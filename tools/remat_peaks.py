#!/usr/bin/env python3
"""Peak card memory of one fused training epoch of the PyTorch port under
each remat policy, at one network size, resolution and batch.

    python tools/remat_peaks.py --size l --image-size 640 --batch 128
    python tools/remat_peaks.py --size m --image-size 640 --batch 96 --policies none conv_out

Run it from the root of a checkout on a machine with one card. Each policy
runs in a process of its own (so an out-of-memory error or the allocator's
state after one policy does not touch the next): ``Trainer.from_config`` of
the default network with ``model.net.deepen_factor`` / ``widen_factor`` of
the size, ``dataset_name=fake`` with ``--steps`` x batch images held on the
card (``data.pipeline=device data.device_cache=True``, bf16), one fused epoch
of ``--steps`` steps without validation (two eager warm-up steps, the
capture, then replays), ``torch.cuda.max_memory_allocated`` read after it
(the corpus and the validation cache on the card included) and the
allocator's largest reservation. A policy that does not fit prints the
error's first line instead. Prints one JSON object a policy, then the card's
name and power limit; with ``--out FILE`` the objects are also written
there as a JSON list.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from object_detection_cib_torch.models.yolov5 import SIZE_VARIANTS  # noqa: E402

POLICIES = ("none", "conv_out_bn_stats", "conv_out", "nothing")


def measure(size: str, image_size: int, batch: int, steps: int, policy: str) -> dict:
    """One fused epoch under ``policy``, in this process."""
    import tempfile

    import torch

    from object_detection_cib_torch.config import compose
    from object_detection_cib_torch.train.trainer import Trainer

    res = dict(size=size, image_size=image_size, batch=batch, steps=steps, policy=policy)
    with tempfile.TemporaryDirectory(prefix="remat-peaks-") as tmp:
        overrides = ["dataset_name=fake", "data.pipeline=device", "data.device_cache=True", "seed=0",
                     f"data.fake_num_images={steps * batch}", f"data.batch_size={batch}",
                     f"data.target_image_size={image_size}",
                     *(f"model.net.{k}={v}" for k, v in SIZE_VARIANTS[size].items()),
                     f"model.remat_policy={'null' if policy == 'none' else policy}",
                     "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=2", "logger=csv", "hydra=static",
                     "extras.enforce_tags=False", "print_config=False", "extras.print_config=False",
                     "callbacks.model_summary=null", "callbacks.model_checkpoint=null", f"paths.output_dir={tmp}"]
        try:
            t = Trainer.from_config(compose(ROOT / "configs", "train", overrides))
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            t.fit(max_epochs=1)
            torch.cuda.synchronize()
            res.update(fits=True, fit_s=time.perf_counter() - t0, held_before_fit_gib=held / 2**30,
                       peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                       peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30,
                       graphed=bool(t._fused_fn is not None and t._fused_fn.graph),
                       params=sum(p.numel() for p in t.net.parameters()))
        except torch.OutOfMemoryError as e:
            res.update(fits=False, error=str(e).splitlines()[0],
                       peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", choices=sorted(SIZE_VARIANTS), default="l")
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=12, help="steps of the fused epoch (images: steps x batch)")
    ap.add_argument("--policies", nargs="+", choices=POLICIES, default=list(POLICIES))
    ap.add_argument("--out", type=Path, help="also write the results there as a JSON list")
    ap.add_argument("--child", choices=POLICIES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(measure(args.size, args.image_size, args.batch, args.steps, args.child)), flush=True)
        return
    results = []
    for policy in args.policies:
        proc = subprocess.run([sys.executable, __file__, "--size", args.size, "--image-size", str(args.image_size),
                               "--batch", str(args.batch), "--steps", str(args.steps), "--child", policy],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode or not lines:
            raise RuntimeError(f"policy {policy}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        results.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps([dict(r, card=card) for r in results], indent=1))


if __name__ == "__main__":
    main()
