"""Offline sampler statistics, a copy of ``object_detection_cib_tpu/cli/
inspect_sampler.py`` (parity: kod/cli/inspect_sampler.py +
kod/test_utils/inspect_sampler.py:96-230); matplotlib is imported by the
plot, inside ``utils/plots.py``.

Iterates N epochs of a sampler over a cached dataset, counts the class
instances actually drawn, dumps JSON + a histogram plot.

  python -m object_detection_cib_torch.cli.inspect_sampler \
      --name coco-zipf --sampler class_aware --epochs 3 --out-dir sampler_out
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from object_detection_cib_torch.data.cache import deserialize_cached_dataset
from object_detection_cib_torch.data.samplers import (
    ClassAwareSampler,
    RepeatFactorSampler,
    ShuffleSampler,
)
from object_detection_cib_torch.utils.plots import (
    plot_instances_per_class_per_epoch,
)

SAMPLERS = {
    "shuffle": lambda info: ShuffleSampler(info, seed=0),
    "class_aware": lambda info: ClassAwareSampler(info, seed=0),
    "repeat_factor": lambda info: RepeatFactorSampler(info),
    "repeat_factor_max": lambda info: RepeatFactorSampler(info, reduction="max"),
}


def inspect_sampler(info, sampler_name: str, epochs: int, out_dir: Path,
                    plot_title: str = ""):
    sampler = SAMPLERS[sampler_name](info)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    per_epoch = {}
    for e in range(epochs):
        idx = np.asarray(sampler.epoch_indices())
        counts = {c: 0 for c in info.classes}
        for i in idx:
            for t in info.samples[int(i)].targets:
                counts[t.class_name] += 1
        per_epoch[e] = counts
    (out_dir / f"{sampler_name}_stats.json").write_text(
        json.dumps(per_epoch, indent=2)
    )
    plot_instances_per_class_per_epoch(
        per_epoch,
        out_dir / f"{sampler_name}_hist.png",
        title=plot_title or f"{sampler_name} on {info.name}",
    )
    return per_epoch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--sampler", choices=list(SAMPLERS), default="class_aware")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--out-dir", type=Path, default=Path("sampler_out"))
    p.add_argument("--plot-title", default="")
    p.add_argument("--cache-dir", type=Path, default=None)
    args = p.parse_args(argv)

    info = deserialize_cached_dataset(args.name, args.split, args.cache_dir)
    per_epoch = inspect_sampler(
        info, args.sampler, args.epochs, args.out_dir, args.plot_title
    )
    print(json.dumps(per_epoch[0], indent=2))


if __name__ == "__main__":
    main()
