"""Entry points for a compile check and a multi-card check: a forward on
the card, and a dry run of one training step over several ranks.

The port's counterpart of the repo's ``__graft_entry__.py`` (the JAX
package's): ``entry()`` gives ``(fn, example_args)``, the yolov5s forward at
640 px in bf16 with example inputs on the card, and ``dryrun_multichip(n)``
runs one full train step (forward, assignment, loss, backward, SmartSGD,
with the global BatchNorm statistics and the gradient all-reduce) over
``n`` ranks spawned by ``parallel.distributed.launch``, one card each, and
checks a finite loss and equal weights on every rank. Both run on the card
unless the caller asks for the CPU (``device="cpu"``, ``device_type="cpu"``:
gloo ranks). The JAX entry's DP x SP and fused-epoch dry runs are not here:
the port has no spatial sharding (ROADMAP A), and its fused epoch over
ranks is driven by ``chip_smoke.py`` phase 13.

  python -m object_detection_cib_torch.entry [n]   # the forward, then n ranks
"""

from __future__ import annotations

import hashlib
import os
import sys
from typing import Union

import numpy as np
import torch

from object_detection_cib_torch.core.types import FeatureShape, default_anchors
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.parallel.distributed import all_reduce_sum_, launch
from object_detection_cib_torch.parallel.mesh import shard_batch_pytree
from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
from object_detection_cib_torch.train.steps import Batch, make_train_step

NUM_CLASSES = 10


def entry(device: Union[str, torch.device] = "cuda"):
    """``(fn, example_args)``: ``fn`` is yolov5s (nc=10, bf16 over f32
    parameters, random weights from seed 0) in eval mode, called on NHWC
    images in [0, 1]; ``example_args`` is 8 zero images at 640 px on its
    device (the JAX entry's shapes)."""
    net = build_network(NUM_CLASSES, "s", dtype=torch.bfloat16, device=device, seed=0).eval()
    images = torch.zeros((8, 640, 640, 3), device=next(net.parameters()).device)
    return net, (images,)


def _dryrun_batch(B: int, img: int, T: int = 8) -> Batch:
    """The JAX dry run's batch: one box a row, random images from seed 0."""
    rng = np.random.default_rng(0)
    boxes = np.zeros((B, T, 4), np.float32)
    labels = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), bool)
    for b in range(B):
        boxes[b, 0] = [8, 8, 24, 24]
        labels[b, 0] = rng.integers(0, NUM_CLASSES)
        mask[b, 0] = True
    images = rng.random((B, img, img, 3), np.float32)
    return Batch(*(torch.from_numpy(a) for a in (images, boxes, labels, mask)))


def _dryrun_rank(mesh, img: int) -> dict:
    """One rank of the dry run: its rows of a global batch of two images a
    rank, one step; the loss summed over the ranks and a digest of the
    weights. On the CPU a rank takes its share of the host's cores."""
    if mesh.device.type == "cpu":
        torch.set_num_threads(max(min(torch.get_num_threads(), (os.cpu_count() or 1) // mesh.local_size), 1))
    net = build_network(NUM_CLASSES, "s", device=mesh.device, seed=0)
    opt = SmartSGD(net, OptimizerConfig(max_epochs=300), steps_per_epoch=10)
    step = make_train_step(net, default_anchors(), FeatureShape(img, img), opt, mesh=mesh)
    batch = shard_batch_pytree(_dryrun_batch(2 * mesh.size, img), mesh)
    m = step(Batch(*(t.to(mesh.device) for t in batch)))
    loss = m.total.detach().double().reshape(1)
    all_reduce_sum_(loss, mesh.group)
    state = b"".join(v.detach().cpu().double().numpy().tobytes() for v in net.state_dict().values())
    return dict(loss=float(loss), digest=hashlib.sha256(state).hexdigest())


def dryrun_multichip(n_devices: int, device_type: str = "cuda", image_size: int = 64,
                     join_timeout_s: float = 600.0) -> dict:
    """One full train step of yolov5s at ``image_size`` over ``n_devices``
    ranks (NCCL on cards 0..n-1, or gloo on the CPU); raises unless the loss
    is finite and every rank holds the same weights. Returns rank 0's
    ``{"loss", "digest"}``."""
    ranks = launch(_dryrun_rank, n_devices, (image_size,), device_type=device_type, join_timeout_s=join_timeout_s)
    if not np.isfinite(ranks[0]["loss"]):
        raise RuntimeError(f"dry run: loss {ranks[0]['loss']} is not finite")
    if len({r["digest"] for r in ranks}) != 1:
        raise RuntimeError("dry run: the ranks' weights differ after the step")
    print(f"dryrun DP OK: {n_devices} ranks ({device_type}) loss={ranks[0]['loss']:.4f}", flush=True)
    return ranks[0]


if __name__ == "__main__":
    fn, args = entry()
    with torch.inference_mode():
        out = fn(*args)
    print("entry OK", [tuple(level.raw.shape) for level in out.levels()], flush=True)
    if len(sys.argv) > 1:
        dryrun_multichip(int(sys.argv[1]))
