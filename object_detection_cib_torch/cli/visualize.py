"""Augmentation visualization, a copy of ``object_detection_cib_tpu/cli/
visualize.py`` (parity: kod/data/test_mosaic.py:95-138 — the
human-in-the-loop mosaic check, generalized to the full augment chain). The
host augment chain draws it; matplotlib is imported inside.

  python -m object_detection_cib_torch.cli.visualize --name synthetic-zipf \
      --split train --out mosaic.png [--device]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from object_detection_cib_torch.data.cache import deserialize_cached_dataset
from object_detection_cib_torch.data.host_augment import (
    AugParams,
    TrainSampleAugmentor,
    mosaic4,
)
from object_detection_cib_torch.data.reader import SampleReader
from object_detection_cib_torch.utils.plots import apply_theme


def _draw(ax, sample, title):
    img = sample.image
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    ax.imshow(img)
    for b in sample.bboxes:
        x1, y1, x2, y2 = b
        ax.add_patch(
            __import__("matplotlib.patches", fromlist=["Rectangle"]).Rectangle(
                (x1, y1), x2 - x1, y2 - y1, fill=False, edgecolor="lime", lw=1.5
            )
        )
    ax.set_title(title)
    ax.axis("off")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--out", type=Path, default=Path("mosaic.png"))
    p.add_argument("--image-size", type=int, default=416)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fake", action="store_true")
    p.add_argument("--cache-dir", type=Path, default=None)
    args = p.parse_args(argv)

    info = deserialize_cached_dataset(args.name, args.split, args.cache_dir)
    reader = SampleReader(args.image_size, info.classes, fake_mode=args.fake)
    rng = np.random.default_rng(args.seed)
    idx = rng.choice(len(info.samples), 4, replace=False)
    samples = [reader(info.samples[i], letter_box=False) for i in idx]

    mosaic, border = mosaic4(samples, args.image_size, rng)
    augmented = TrainSampleAugmentor(AugParams())(mosaic, border)

    plt = apply_theme()
    fig, axes = plt.subplots(1, 3, figsize=(16, 6))
    _draw(axes[0], samples[0], "input sample")
    _draw(axes[1], mosaic, "mosaic (2S x 2S)")
    _draw(axes[2], augmented, "mosaic + affine/HSV/flip")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
