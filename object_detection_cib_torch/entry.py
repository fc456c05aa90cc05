"""Entry points for a compile check and a multi-card check: a forward on
the card, and dry runs of training over several ranks.

The port's counterpart of the repo's ``__graft_entry__.py`` (the JAX
package's): ``entry()`` gives ``(fn, example_args)``, the yolov5s forward at
640 px in bf16 with example inputs on the card, and ``dryrun_multichip(n)``
runs, over ranks spawned by ``parallel.distributed.launch``, one card
each, the JAX entry's four dry runs: (1) one full train step over ``n``
ranks (forward, assignment, loss, backward, SmartSGD, with the global
BatchNorm statistics and the gradient all-reduce); (2) where ``n >= 2``,
DP x SP: one step over a ``(data n // 2, model 2)`` mesh of ``2 (n // 2)``
ranks (JAX's ``devices[:n]`` grid), each rank holding a band of half the
rows of its data rows' images at 256 px, the halos exchanged by hand
(``parallel/spatial.py``), at a global batch of ``max(n // 2 * 2, 2)``;
(3) one fused epoch of the production loop over ``n`` ranks (gather,
augment and train step a step, pipelined; a CUDA graph a step on the card)
over the corpus on the card; (4) the same over a corpus sharded over the
ranks, each rank holding ``8B / n`` of its rows. Dry runs 3 and 4 hold the
corpus in ``corpus_layout`` (``"planar"``, or ``"flat"``: NHWC rows
gathered by K3 in place of K2). Each checks finite losses and equal
weights on every rank, and on the card that each fused epoch launched its
gather (K2 or K3), K4 and K5 once a step. Both entry points run on the card
unless the caller asks for the CPU (``device="cpu"``, ``device_type="cpu"``:
gloo ranks).

  python -m object_detection_cib_torch.entry [n [layout]]   # the forward, then n ranks
"""

from __future__ import annotations

import hashlib
import sys
from typing import Union

import numpy as np
import torch

from object_detection_cib_torch.core.types import FeatureShape, default_anchors
from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline
from object_detection_cib_torch.data.host_augment import AugParams
from object_detection_cib_torch.data.synthetic import build_fake_manifest
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.ops.gather import gather_rows_flat, gather_rows_planar
from object_detection_cib_torch.ops.hsv import hsv_planar
from object_detection_cib_torch.ops.warp import warp_quadrants
from object_detection_cib_torch.parallel.distributed import all_reduce_sum_, launch
from object_detection_cib_torch.parallel.mesh import make_mesh, shard_batch_pytree
from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
from object_detection_cib_torch.train.steps import Batch, make_train_step

NUM_CLASSES = 10
KERNELS = (gather_rows_planar, gather_rows_flat, hsv_planar, warp_quadrants)  # K2, K3, K4, K5
GATHER = {"planar": gather_rows_planar, "flat": gather_rows_flat}  # a fused step's gather by layout


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


def _digest(net: torch.nn.Module) -> str:
    return hashlib.sha256(b"".join(v.detach().cpu().double().numpy().tobytes()
                                   for v in net.state_dict().values())).hexdigest()


def _fused_run(mesh, img: int, sharding: str, layout: str = "planar") -> dict:
    """Dry runs 3 and 4 on one rank: one pipelined fused epoch at a global
    batch of two images a rank over ``8B`` fake images (``max_targets``
    24), the corpus replicated or sharded, in ``layout``: the losses
    summed over the ranks, the weights' digest and the corpus rows this
    rank holds."""
    B = 2 * mesh.size
    pipe = DeviceDataPipeline(build_fake_manifest(num_images=8 * B, num_classes=NUM_CLASSES, seed=0), img, B,
                              AugParams(), max_targets=24, seed=0, fake_mode=True, device=mesh.device,
                              feed_dtype=torch.float32, mesh=mesh, corpus_sharding=sharding,
                              corpus_layout=layout)
    net = build_network(NUM_CLASSES, "s", device=mesh.device, seed=0)
    opt = SmartSGD(net, OptimizerConfig(max_epochs=300), steps_per_epoch=len(pipe))
    step = make_train_step(net, default_anchors(), FeatureShape(img, img), opt, mesh=mesh)
    xs = pipe.epoch_host_arrays()
    before = {k.__name__: k.launches for k in KERNELS}
    flat = pipe.build_fused_epoch_fn(step, pipelined=True, stack_metrics=True)(xs, opt.hyper_table(0, len(xs[0])))
    losses = flat[0].double()
    all_reduce_sum_(losses, mesh.group)
    return dict(losses=losses.cpu().tolist(), digest=_digest(net), held_rows=int(pipe.corpus.shape[0]),
                launches={k.__name__: k.launches - before[k.__name__] for k in KERNELS})


def _one_cpu_thread(mesh) -> None:
    """On the CPU a rank runs one intra-op thread. At the dry runs' sizes
    more threads gain nothing, and where other processes load the host the
    ranks' threads oversubscribe its cores: three dry runs at once on eight
    cores took 170 s for dry runs 1, 3 and 4 with four threads a rank
    against 12 s with one."""
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)


def _dryrun_rank(mesh, img: int, layout: str = "planar") -> dict:
    """One rank of the dry runs. (1) its rows of a global batch of two images
    a rank, one step: the loss summed over the ranks and a digest of the
    weights; then (3) and (4), ``_fused_run``."""
    _one_cpu_thread(mesh)
    net = build_network(NUM_CLASSES, "s", device=mesh.device, seed=0)
    opt = SmartSGD(net, OptimizerConfig(max_epochs=300), steps_per_epoch=10)
    step = make_train_step(net, default_anchors(), FeatureShape(img, img), opt, mesh=mesh)
    batch = shard_batch_pytree(_dryrun_batch(2 * mesh.size, img), mesh)
    m = step(Batch(*(t.to(mesh.device) for t in batch)))
    loss = m.total.detach().double().reshape(1)
    all_reduce_sum_(loss, mesh.group)
    return dict(loss=float(loss), digest=_digest(net), fused=_fused_run(mesh, img, "replicated", layout),
                sharded=_fused_run(mesh, img, "sharded", layout))


SPATIAL_IMAGE = 256  # dry run 2's resolution (JAX's): every level keeps >= 2 rows a band


def _dryrun_spatial_rank(mesh, num_data: int) -> dict:
    """Dry run 2 on one rank: its data rows and band of a global batch of
    ``max(num_data * 2, 2)`` images at 256 px over a ``(num_data, 2)`` mesh,
    one step: the loss summed over the data ranks and a digest of the
    weights."""
    _one_cpu_thread(mesh)
    sp = make_mesh(num_data, 2, device=mesh.device)
    img = SPATIAL_IMAGE
    net = build_network(NUM_CLASSES, "s", device=mesh.device, seed=0)
    opt = SmartSGD(net, OptimizerConfig(max_epochs=300), steps_per_epoch=10)
    step = make_train_step(net, default_anchors(), FeatureShape(img, img), opt, mesh=sp)
    batch = shard_batch_pytree(_dryrun_batch(max(num_data * 2, 2), img), sp, spatial=True)
    m = step(Batch(*(t.to(mesh.device) for t in batch)))
    loss = m.total.detach().double().reshape(1)
    all_reduce_sum_(loss, sp.group)
    return dict(loss=float(loss), digest=_digest(net))


def dryrun_multichip(n_devices: int, device_type: str = "cuda", image_size: int = 64,
                     join_timeout_s: float = 600.0, corpus_layout: str = "planar") -> dict:
    """The dry runs of yolov5s at ``image_size`` over ``n_devices`` ranks
    (NCCL on cards 0..n-1, or gloo on the CPU): one train step, where
    ``n_devices >= 2`` a DP x SP step at 256 px over ``2 (n // 2)`` ranks, a
    fused epoch, a fused epoch over a sharded corpus, both over a corpus
    in ``corpus_layout`` (module docstring).
    Raises unless every loss is finite, every rank holds the same weights
    after each, and each rank holds ``8B / n`` rows of the sharded corpus.
    Returns rank 0's ``{"loss", "digest", "fused", "sharded"}``, with
    ``"spatial"``: rank 0's ``{"loss", "digest"}`` of dry run 2 where it
    ran."""
    ranks = launch(_dryrun_rank, n_devices, (image_size, corpus_layout), device_type=device_type,
                   join_timeout_s=join_timeout_s)
    r0 = ranks[0]
    if not np.isfinite(r0["loss"]):
        raise RuntimeError(f"dry run: loss {r0['loss']} is not finite")
    if len({r["digest"] for r in ranks}) != 1:
        raise RuntimeError("dry run: the ranks' weights differ after the step")
    print(f"dryrun DP OK: {n_devices} ranks ({device_type}) loss={r0['loss']:.4f}", flush=True)
    if n_devices >= 2:
        d = n_devices // 2
        sp = launch(_dryrun_spatial_rank, 2 * d, (d,), device_type=device_type, join_timeout_s=join_timeout_s)
        if not np.isfinite(sp[0]["loss"]):
            raise RuntimeError(f"dry run DP x SP: loss {sp[0]['loss']} is not finite")
        if len({r["digest"] for r in sp}) != 1:
            raise RuntimeError("dry run DP x SP: the ranks' weights differ after the step")
        r0 = dict(r0, spatial=sp[0])
        print(f"dryrun DPxSP OK: mesh(data={d}, model=2) {2 * d} ranks ({device_type}) "
              f"loss={sp[0]['loss']:.4f}", flush=True)
    images = 8 * 2 * n_devices  # 8B
    for part in ("fused", "sharded"):
        if not np.isfinite(r0[part]["losses"]).all():
            raise RuntimeError(f"dry run {part}: losses {r0[part]['losses']} are not all finite")
        if len({r[part]["digest"] for r in ranks}) != 1:
            raise RuntimeError(f"dry run {part}: the ranks' weights differ after the epoch")
    held = [r["sharded"]["held_rows"] for r in ranks]
    if held != [images // n_devices] * n_devices:
        raise RuntimeError(f"dry run sharded: rows held {held}, want {images // n_devices} a rank")
    steps = len(r0["fused"]["losses"])
    want = {k.__name__: steps if k in (GATHER[corpus_layout], hsv_planar, warp_quadrants) else 0 for k in KERNELS}
    for part in ("fused", "sharded") if device_type == "cuda" else ():  # the CPU runs the plain versions
        if any(r[part]["launches"] != want for r in ranks):
            raise RuntimeError(f"dry run {part}: launches {[r[part]['launches'] for r in ranks]}, want {want} "
                               "on each rank")
    print(f"dryrun fused-epoch OK: {n_devices} ranks ({device_type}) {corpus_layout} corpus, "
          f"{len(r0['fused']['losses'])} steps, "
          f"last loss={r0['fused']['losses'][-1]:.4f}", flush=True)
    print(f"dryrun sharded-corpus fused-epoch OK: {n_devices} ranks ({device_type}) corpus {images} rows at "
          f"{images // n_devices} a rank, last loss={r0['sharded']['losses'][-1]:.4f}", flush=True)
    return r0


if __name__ == "__main__":
    fn, args = entry()
    with torch.inference_mode():
        out = fn(*args)
    print("entry OK", [tuple(level.raw.shape) for level in out.levels()], flush=True)
    if len(sys.argv) > 1:
        dryrun_multichip(int(sys.argv[1]), corpus_layout=sys.argv[2] if len(sys.argv) > 2 else "planar")
