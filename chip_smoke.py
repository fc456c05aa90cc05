#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py [--baseline DIR ...]
    python3 chip_smoke.py --phase ddp   # phases 1, 2 and 13 alone (on 2-4 cards for 13 (c))

``--baseline DIR`` (repeatable) also builds the four kernel sources
(``nms.cu``, ``gather.cu``, ``hsv.cu``, ``warp.cu``) of another checkout at
DIR (for example the parent commit, unpacked with ``git archive`` into a
git-ignored directory), holds each bitwise against the plain version in
phases 3 and 7, and times it in turns with this checkout's kernel on the
same inputs, called straight through ctypes. Each checkout's ``nms.cu`` is
called by the interface it has: a library that exports
``odcib_nms_workspace_bytes`` takes a workspace pointer and its capacity in
images after ``keep``; one that does not takes the earlier seven arguments.
Without ``--baseline``, one card and nothing else is needed.

Every kernel is timed two ways: ``ms``, CUDA events around 30 calls in a
row (the kernel's device time, as long as the host enqueues a call faster
than the card runs it; ``--baseline .`` times the same kernels called
without the Python wrapper), and ``call_ms``, one call between two events
from an idle stream, median of 30 (the wrapper's host path included, as a
host-bound step sees it).

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. device: require CUDA, print the card's name and power limit
   (``nvidia-smi``), set and print the TF32 switches;
2. build: compile every kernel source of ``object_detection_cib_torch/ops/
   csrc`` (one ``nvcc`` per source, all at once; printed as set-up time,
   with ptxas' register report);
3. kernels: hold each kernel BITWISE against its plain PyTorch version on
   the card (greedy-NMS keep mask: the chain case, K=256 random, K=2048 with
   900 live, a ragged K=1000, K=64 and K=65, the validation batch of 64 at
   K=2048, one image alone, an image with no live box, one where every box
   is kept and one where box 0 suppresses all others, and the batch of 32 at
   K=2048 from a real yolov5s output), then time kernel and plain version in
   turns with CUDA events (median of repeats), at the batch of 32 and for
   its first image alone, and compute the kernel's bound from this run's
   inputs, beside the dependency depth of the timed case (the sweeps the
   plain version needs to its fixpoint: the chain no parallel design can
   cut). Greedy NMS has no single PyTorch call (there is no torchvision
   here), so there is no library yardstick: ``library_ms`` is null;
4. serving: yolov5s, nc=10, 640x640, batch 32, bf16, channels_last, random
   weights from a seed, through ``make_eval_step`` (forward -> decode -> NMS
   at conf 0.001 / IoU 0.6 / max_nms 2048 / max_det 300) for 200 steps;
   launch counts are zeroed just before and read just after; img/s over the
   200 steps, the host's time to enqueue one step, and ms per stage; a small
   f32 input checked against the CPU run of the same port;
5. validation: a fake 320-image val set at 416 (``build_fake_manifest``,
   coco-zipf top-10 shape), ``ValDeviceCache`` on the card, batch 64,
   ``Evaluator.validate``; the mAP dict must be finite;
6. training set-up: the repo's training recipe (yolov5s, nc=10, 416x416,
   batch 64, bf16 over f32 parameters, mosaic, translate 0.1, scale 0.5,
   HSV 0.015/0.7/0.4, flip 0.5, max_targets 120) as a ``Trainer`` over the
   fake 4,992-image corpus of ``bench.py:bench_sustained`` (the same image
   bytes, sizes and boxes; the class labels follow the coco-zipf long tail
   of the val set, so that the samplers of phase 9 have an imbalance to
   flatten), held on the card as planar uint8 (2.59 GB), with the phase-5
   val set;
7. training kernels: the corpus gather (K2 planar at a mosaic step's 256
   rows and at a no-mosaic step's 64, K3 flat view), HSV (K4,
   bf16 and f32, integral and non-integral, extreme gains, a plane that is
   not a multiple of 8, a base 2 bytes off 16-byte alignment, and pixels
   that read entries 0, 1 and 255 of both division tables) and the mosaic
   warp (K5: taps of a real draw at 416, random windowed taps at 416 and
   640, a quadrant wholly outside its window) held BITWISE against their
   plain versions on the card, then timed in turns against them (and the
   gather against ``torch.index_select``), with bounds from this run's
   inputs;
8. training: the step loop (``Trainer(fused_epoch=False)``),
   ``Trainer.fit(max_epochs=1, epoch_steps=40)`` with the
   launch counts zeroed just before and read just after (K2, K4, K5 once
   per step; K1 five times in the epoch-end validation); finite losses,
   every parameter moved, a finite mAP; img/s over the last 30 steps, ms
   per stage and the host's time to enqueue one step; then two f32 steps
   of yolov5n at 64 px from the same weights and draws on the CPU and the
   card, losses within 1e-3 relative;
9. recipes: the imbalance recipes at the width of phase 8 (yolov5s, nc=10,
   416x416, batch 64, bf16), each a ``Trainer`` over phase 6's corpus on the
   card (built once, shared), stepped through ``pipeline.epoch`` and
   ``train_step`` with the launch counts zeroed just before and read just
   after: class-aware sampling with mixup 0.5 for 10 steps (K2, K4 and K5
   twice per step; both outcomes of the mixup coin; a row with more valid
   targets than one group holds; ``sampler_stats`` flatter than the same
   steps without a sampler), repeat-factor sampling without mosaic for 10
   steps (K2 with 64 rows and K4 once per step, K5 never), a rotating,
   shearing, perspective affine for 5 steps (K5 never; integer pixels in
   [0, 255] before the normalize), the exact warp against the fast one on
   the same rows and draws (4/255 at most, 1/255 on 99% of pixels, HSV
   off; boxes, labels and masks equal), and one composed-path step and one
   mixup step at 64 px on the CPU and the card (1/255, boxes 1e-4, HSV
   off; with HSV on, 9/255; both on under 0.1% of pixels, 0.2% under
   mixup). Each recipe prints
   img/s after a warm-up step, its augment stage's ms, the host's time to
   enqueue one step and its launches: observations, not claims;
10. jpeg: training and validation from JPEG files at the width of phase 8
    (yolov5s, nc=10, 416x416, batch 64, bf16, ``aug_params.yaml``). First a
    probe of the host libraries: cv2 and Pillow (the host pipeline) and
    libjpeg (the native loader, built in a temporary directory). Where
    Pillow is there, ``build_synthetic_dataset`` writes ``synthetic-hard-
    zipf``, 640 train and 128 val JPEG files, into a temporary directory.
    (a) ``Trainer(pipeline="device", device_cache=True)``: the corpus on
    the card, decoded from the files (held byte for byte against the CPU's
    ``pack_batch``, transposed) or, without libjpeg, built by
    ``DeviceCorpus.from_canvases`` from canvases drawn from a seed;
    ``fit`` over one epoch with its validation (K2, K4, K5 10 times each,
    K1 twice). (b) ``device_cache=False``: 5 steps with the groups loaded
    by a host thread (K2 never, K4 and K5 5 times), bitwise equal to the
    device-cache pipeline's batches of the same seed, or, from fake groups
    without libjpeg, step 1 against the same pipeline on the CPU; with the
    RAM cache a second epoch decodes only images not seen before. (c)
    ``pipeline="host"``, 8 worker threads, 5 steps and the host-fed
    validation (no training kernel; K1 once per val batch). Last the two
    validation feeds on the same canvases give the same mAP dict. Each part
    prints img/s and the host's enqueue time, (c) the time the consumer
    waited on its queue: observations, not claims. A part that needs a
    library the machine lacks prints which, and does not run;
11. cli: the normal entry point, ``object_detection_cib_torch.cli.train.
    main([...])`` on the card (``trainer.platform`` null), in a temporary
    output directory with ``hydra=static``, ``extras.enforce_tags=False``,
    no config print and ``logger=csv``. (a) ``experiment=yv5s`` (yolov5s@416,
    B=64, bf16) over a fake 640-image set on the device pipeline with the
    corpus on the card, two epochs validated once
    (``check_val_every_n_epoch=2``), on the fused epoch by the config's
    defaults (a CUDA graph a step, the second epoch enqueued ahead of the
    first's fetch): K2, K4, K5 20 times each, counted by replay, K1 10 (one
    validation of 640 images); finite losses and mAP; ``checkpoints/{best,
    last,meta.json}``, ``csv/metrics.csv``, ``hparams.json``; then ``train=
    False test=True ckpt_path=<run>/checkpoints/last``: the restored
    parameters, statistics and momentum buffers bitwise those saved, the
    test mAP the last validation's within 1e-6. (b) the repo's default data
    config (the host pipeline) under ``trainer.fast_dev_run``: no training
    kernel, K1 once. (c) ``experiment=imbalance/class_aware/default`` with
    mixup 0.5 on the device pipeline, ``limit_train_batches=0.5`` and
    ``limit_val_batches=0.2``: K2, K4, K5 10 times each (5 steps, two groups
    a step), K1 twice, and the sampler's instance counts. (a) and (b) print
    img/s: observations, not claims;
12. fused: the fused epoch (``fused_epoch``, ``fused_pipelined``,
    ``fused_dispatch_ahead``, the config defaults) at phase 8's width over
    phase 6's corpus. First a probe: the first 6 batches of a fused epoch
    (pipelined, a CUDA graph after 2 eager warm-up steps, so 3 batches made
    inside the graph), recorded by the step itself, bitwise equal to the
    step loop's iterator from the same seed. Then two trainers of the same
    seed, the step loop and the fused epoch, each fitted to epoch 2 and on
    to epoch 4 in full 78-step epochs, validated at epochs 2 and 4, in turns
    (step, fused, fused, step): each fit launches K2, K4, K5 156 times
    (counted by replay for the fused loop) and K1 5; finite losses and
    mAP, the fused trainer's parameters moved. Printed: img/s of each fit's
    second epoch (host clock; fetch to fetch for the fused loop), the
    device epoch walls (CUDA events), the first three losses of both loops,
    the peak memory; for one whole fused epoch from an idle card the host's
    enqueue and the time a step; the graph's nodes and kernels per step
    (libcuda's ``cuGraphGetNodes``); over a 10-step fused epoch the profiler's kernel time
    and the card's busy time (the union of the kernels' intervals: two
    streams overlap) and idle share. Observations, not claims;
13. ddp: data parallelism through the launcher
    (``parallel/distributed.py:launch``, one process a rank), each rank
    counting its own launches. (a) A one-rank NCCL group over the fused
    epoch (yolov5s@416, B=64, bf16, 640 fake images, 10 steps, validation
    of 128): K2/K4/K5 10 each by replay, K1 2; the all-reduces issued equal
    the step bodies run in Python (2 warm-up steps and one capture per
    graph) times (3 per BatchNorm + the loss's counts + the gradient
    bucket) + the epoch's metric sum; the graph's kernel nodes read by
    name (``cuFuncGetName``) and those of NCCL counted; finite losses and
    mAP. (b) Two gloo ranks sharing this card, the step loop at a global
    B=64 (32 a rank), 10 steps and one validation: K2/K4/K5 10 on each
    rank, K1 once on each rank's 64-image shard; the ranks' weights
    bitwise equal; the first three losses within rtol 1e-3 of one process
    of the same seed; the merged mAP dict equal to one process's over the
    whole val set with the ranks' weights. (c) With two or more cards,
    N = min(count, 4) NCCL ranks over the config ``cli.train trainer=mesh``
    composes (yolov5s@416, 64 images a card, 1,280 fake images a card, two
    fused epochs, a quarter of the val set), the replicated and then the
    sharded corpus, beside one card alone: img/s over both epochs' windows
    and its ratio to the one card's, launches, collectives issued, NCCL
    kernel nodes in the graph, a profiled 10-step epoch's NCCL kernel ms a
    step and each rank's idle share, peak memory per rank; with one card it
    prints that (c) needs two. ``--phase ddp`` runs phases 1, 2 and 13 alone
    (its last lines: the ranks' launches, the card, the result);
14. the ``kernels`` JSON line (with each path's launches), the card line,
    and the result line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
NMS_OPS_PER_PAIR = 14  # 4 min/max, 2 sub, 2 clamp, 1 mul, 2 add/sub, +eps, div, cmp
HSV_OPS_PER_PIXEL = 75  # per pixel position, 3 channels: csrc/hsv.cu counted op by op
WARP_OPS_PER_TAP_ROW = 12  # per live (quadrant, row), output pixel and channel

SERVE_B, SERVE_S, NC = 32, 640, 10
SERVE_STEPS = 200  # a window of seconds, so host jitter averages out of img/s
VAL_B, VAL_S, VAL_N = 64, 416, 320
CONF, IOU, MAX_NMS, MAX_DET = 0.001, 0.6, 2048, 300
TRAIN_N, TRAIN_B, TRAIN_S, MAX_TARGETS = 4992, 64, 416, 120  # bench.py:237 corpus
TRAIN_STEPS, TIMED_STEPS = 40, 30
RECIPE_STEPS, AFFINE_STEPS = 10, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check_err(err: int) -> None:
    if err:
        fail(f"baseline kernel launch failed: cudaError {err}")


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn()``, from CUDA events around ``reps`` calls
    in a row: the host enqueues ahead of the card, so the launch overhead of
    a call does not show between two kernels."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain, reps_kernel: int, reps_plain: int):
    """ms per call of kernel and plain, each a run of calls in a row, timed in
    turns (plain, kernel, kernel, plain); the median of each one's turns."""
    for _ in range(3):
        kernel()
    plain()
    turns = {"plain": [], "kernel": []}
    for who in ("plain", "kernel", "kernel", "plain"):
        fn, reps = (kernel, reps_kernel) if who == "kernel" else (plain, reps_plain)
        turns[who].append(run_ms(fn, reps))
    return statistics.median(turns["kernel"]), statistics.median(turns["plain"]), turns


def bound(n_bytes: float, n_ops: float):
    """(bound ms, what sets it) from bytes at 3.35 TB/s and f32 ops at 67 TFLOP/s."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def check_equal(name: str, got, want) -> float:
    """Fail unless bitwise equal; returns the max abs difference (0)."""
    eq = torch.equal(got, want)
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    log(f"[kernels] {name}: bitwise_equal={eq} max_abs_err={err}")
    if not eq:
        fail(f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return err


def used_lines(j, w0, w1, S):
    """Per (group, quadrant): source rows (or columns) that carry a non-zero tap."""
    G, Q, _ = j.shape
    used = torch.zeros(G, Q, S, dtype=torch.int8, device=j.device)
    for k, w in enumerate((w0, w1)):
        jj = j.long() + k
        ok = ((w != 0) & (jj >= 0) & (jj < S)).to(torch.int8)
        used.scatter_reduce_(2, jj.clamp(0, S - 1), ok, "amax")
    return used.sum(-1).double()


def nms_pairs_needed(keep, live) -> int:
    """Pair tests any exact greedy NMS must make on these inputs.

    A kept box must be tested against every kept box before it; a suppressed
    live box needs at least one test (against the box that suppresses it).
    """
    k = keep.to(torch.int64)
    kept_before = k.cumsum(dim=1) - k
    pairs = (kept_before * k).sum() + (live & ~keep).sum()
    return int(pairs)


JPEG_TRAIN_N, JPEG_VAL_N, JPEG_STEPS = 640, 128, 5
CLI_N = 640  # data.fake_num_images: the train and the val set of phase 11


def host_libraries(native_loader):
    """({library: version}, {library: why it is missing}) for phase 10: cv2 and
    Pillow for the host pipeline, libjpeg for the native loader (its build
    in a temporary directory is the probe)."""
    import importlib

    have, missing = {}, {}
    for mod, label in (("cv2", "cv2"), ("PIL", "Pillow")):
        try:
            have[label] = getattr(importlib.import_module(mod), "__version__", "?")
        except ImportError as e:
            missing[label] = f"{label} is not installed on this machine ({e})"
    try:
        have["libjpeg"] = str(native_loader.build())
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        why = ("jpeglib.h, libjpeg's header, is not installed on this machine" if "jpeglib.h" in str(e)
               else f"the build failed: {str(e).strip().splitlines()[-1]}")
        missing["libjpeg"] = f"the native JPEG loader (native/loader.cpp, -ljpeg) does not build: {why}"
    return have, missing


class CanvasReader:
    """A sample reader that hands out a val cache's centered canvases and
    targets: the host feed then validates on the cache's very pixels."""

    def __init__(self, cache, info):
        self.cache, self.index = cache, {s.id: j for j, s in enumerate(info.samples)}

    def __call__(self, sample, letter_box=True):
        from object_detection_cib_torch.data.reader import AugmentedSample

        j = self.index[sample.id]
        m = self.cache.gt_mask[j]
        return AugmentedSample(self.cache.canvases[j], self.cache.gt_boxes[j][m],
                               self.cache.gt_labels[j][m].astype("int64"))


def finite_map(m) -> bool:
    """Every summary of an mAP dict finite (a class without ground truth in
    the val set reads NaN, as in the JAX package)."""
    return all(math.isfinite(v) for k, v in m.items() if "_class_" not in k)


def same_map(a, b) -> bool:
    """Equal mAP dicts, NaN equal to NaN."""
    return a.keys() == b.keys() and all(a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def whole_steps_enqueue(step, reps: int = 5):
    """Host ms to enqueue ``step()`` from an idle card: median and runs."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        runs.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(runs), [round(t, 4) for t in runs]


def phase_jpeg(card, dev, aug, counted, zero_counts, read_counts):
    """Phase 10: train and validate from JPEG files at the training width
    (yolov5s, nc=10, 416, batch 64, bf16) through the three feeds. Returns
    each part's launch counts. A part that needs a host library the machine
    lacks says so and does not run; everything else raises on failure."""
    import numpy as np

    from object_detection_cib_torch.data import native_loader
    from object_detection_cib_torch.data.device_pipeline import (
        DeviceCorpus,
        DeviceDataPipeline,
        fake_canvases,
    )
    from object_detection_cib_torch.data.host_augment import ValidationSampleAugmentor
    from object_detection_cib_torch.data.pipeline import DetectionDataset, Prefetcher
    from object_detection_cib_torch.data.synthetic import build_fake_manifest, build_synthetic_dataset
    from object_detection_cib_torch.train.trainer import Trainer

    have, missing = host_libraries(native_loader)
    log("[jpeg] probe: " + "; ".join([f"{k} {v}" for k, v in have.items()] + list(missing.values())))
    host_ok = not ({"cv2", "Pillow"} & set(missing))
    jpeg_ok = host_ok and "libjpeg" not in missing
    kw = dict(size="s", image_size=TRAIN_S, batch_size=TRAIN_B, aug_params=aug, max_targets=MAX_TARGETS,
              seed=0, dtype=torch.bfloat16, device=dev, max_epochs=1)
    steps = JPEG_TRAIN_N // TRAIN_B
    counts = {}

    def expect(part, got, want):
        for k, n in want.items():
            if got[k] != n:
                fail(f"[jpeg] ({part}) launched {k} {got[k]} times, want {n}")

    with tempfile.TemporaryDirectory(prefix="jpeg-corpus-") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        if "Pillow" in missing:
            log(f"[jpeg] no JPEG corpus written: {missing['Pillow']}; (a) and (b) run on a fake manifest")
            train_info = build_fake_manifest(num_classes=NC, num_images=JPEG_TRAIN_N, image_size=TRAIN_S,
                                             seed=0, zipf_a=1.01)
            val_info = build_fake_manifest(num_classes=NC, num_images=JPEG_VAL_N, image_size=TRAIN_S, seed=1)
        else:
            train_info = build_synthetic_dataset(root, "synthetic-hard-zipf", num_images=JPEG_TRAIN_N,
                                                 image_size=TRAIN_S, seed=0)
            val_info = build_synthetic_dataset(root, "synthetic-hard-zipf-val", num_images=JPEG_VAL_N,
                                               image_size=TRAIN_S, seed=1)
            n_bytes = sum((root / s.image_path).stat().st_size for s in train_info.samples + val_info.samples)
            log(f"[jpeg] setup: synthetic-hard-zipf {JPEG_TRAIN_N} train + {JPEG_VAL_N} val JPEG files at "
                f"{TRAIN_S} px ({n_bytes} B) written by build_synthetic_dataset in "
                f"{time.perf_counter() - t0:.2f} s")

        # (a) the corpus on the card, fit over one epoch
        t0 = time.perf_counter()
        if jpeg_ok:
            tr_a = Trainer(train_info, val_info, fake_mode=False, root_dir=root, **kw)
            corpus = tr_a.pipeline.device_corpus
            canv, sizes, fails = native_loader.pack_batch(
                [(root / s.image_path).read_bytes() for s in train_info.samples], TRAIN_S)
            if fails:
                fail(f"[jpeg] the CPU's pack_batch failed on {fails} files")
            source = "the CPU's pack_batch of the JPEG files"
        else:
            log(f"[jpeg] (a) JPEG decode into the corpus on the card not run: {missing.get('libjpeg')}; "
                f"the corpus is built from seeded canvases instead")
            canv, sizes = fake_canvases(train_info, TRAIN_S, seed=5)
            corpus = DeviceCorpus.from_canvases(train_info, canv, sizes, dev)
            tr_a = Trainer(train_info, val_info, fake_mode=True, corpus=corpus, root_dir=root, **kw)
            source = "top-left packed canvases drawn from seed 5"
        setup_s = time.perf_counter() - t0
        if not (torch.equal(corpus.images, torch.from_numpy(canv).to(dev).permute(0, 3, 1, 2))
                and torch.equal(corpus.sizes.cpu(), torch.from_numpy(sizes))):
            fail(f"[jpeg] (a) the corpus on the card differs from {source}")
        log(f"[jpeg] (a) corpus {tuple(corpus.images.shape)} uint8 = {corpus.images.numel()} B on the card "
            f"equals {source}, transposed, byte for byte; trainer set-up {setup_s:.2f} s")
        del canv
        before = [p.detach().clone() for p in tr_a.net.parameters()]
        marks = {}

        def on_step(epoch, i, m):
            if i in (0, steps - 1):
                torch.cuda.synchronize()
                marks[i] = time.perf_counter()

        zero_counts()
        m_a = tr_a.fit(max_epochs=1, on_step=on_step)
        counts["a"] = read_counts()
        n_val = math.ceil(JPEG_VAL_N / TRAIN_B)
        expect("a", counts["a"], {"gather_rows_planar": steps, "hsv_planar": steps, "warp_quadrants": steps,
                                  "greedy_nms_mask": n_val})
        em = tr_a.epoch_metrics[-1]
        if not np.isfinite(em["total"]).all() or not finite_map(m_a):
            fail(f"[jpeg] (a) losses or mAP not finite: {em['total']}, {m_a}")
        unmoved = sum(torch.equal(a, b) for a, b in zip(before, tr_a.net.parameters()))
        if unmoved:
            fail(f"[jpeg] (a) {unmoved} of {len(before)} parameters did not move")
        del before
        pa = tr_a.pipeline
        idx = torch.from_numpy(pa._epoch_plan()[0][0].astype(np.int32)).to(dev)
        pa.consumed_plan_log.pop()  # drawn for timing only
        enq, runs = whole_steps_enqueue(lambda: tr_a.train_step(pa.gather_augment(idx, pa.draw())[0]))
        ips = (steps - 1) * TRAIN_B / (marks[steps - 1] - marks[0])
        log(f"[jpeg] (a) device_cache=True: fit over one epoch ({steps} steps) and validation of "
            f"{JPEG_VAL_N} images; launches {counts['a']}; losses {em['total'][0]:.4f}->{em['total'][-1]:.4f}, "
            f"all parameters moved, targets dropped {int(em['targets_dropped'])}; {ips:.2f} img/s over steps "
            f"2-{steps}; host enqueue of one whole step (median of 5) {enq:.4f} ms (runs {runs}) | {card}")
        log("[jpeg] (a) validation " + json.dumps(m_a))

        # (b) host-fed: the same augment on the card, the groups loaded by a host thread
        tr_b = Trainer(train_info, val_info, device_cache=False, fake_mode=not jpeg_ok, root_dir=root,
                       enable_ram_cache=True, **kw)
        pb = tr_b.pipeline
        decoded = []
        real_pack = native_loader.pack_batch

        def counting_pack(bufs, *a, **k):
            decoded.append(len(bufs))
            return real_pack(bufs, *a, **k)

        native_loader.pack_batch = counting_pack
        try:
            kept, totals = [], []
            zero_counts()
            for i, (batch, _) in enumerate(pb.epoch(JPEG_STEPS)):
                totals.append(tr_b.train_step(batch).total)
                kept.append(batch)
                if i == 0:
                    torch.cuda.synchronize()
                    t_first = time.perf_counter()
            torch.cuda.synchronize()
            t_last = time.perf_counter()
            counts["b"] = read_counts()
            first_decoded = sum(decoded)
            if jpeg_ok:  # a second epoch decodes only the images the first did not
                seen = set(pb.consumed_plan_log[-1][:JPEG_STEPS].ravel().tolist())
                decoded.clear()
                for _ in pb.epoch(JPEG_STEPS):
                    pass
                new = set(pb.consumed_plan_log[-1][:JPEG_STEPS].ravel().tolist()) - seen
                if sum(decoded) != len(new):
                    fail(f"[jpeg] (b) the second epoch decoded {sum(decoded)} images, want the {len(new)} "
                         f"its first {JPEG_STEPS} steps had not seen")
                cache_note = (f"RAM cache: epoch 1 decoded {first_decoded} images in {JPEG_STEPS} steps, "
                              f"epoch 2 decoded {sum(decoded)}, exactly the {len(new)} not seen before")
            else:
                cache_note = f"fake groups: {first_decoded} images decoded"
        finally:
            native_loader.pack_batch = real_pack
        expect("b", counts["b"], {"gather_rows_planar": 0, "hsv_planar": JPEG_STEPS,
                                  "warp_quadrants": JPEG_STEPS})
        losses = torch.stack(totals).tolist()
        if not all(math.isfinite(v) for v in losses):
            fail(f"[jpeg] (b) losses not finite: {losses}")
        if jpeg_ok:
            ref = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS, seed=0,
                                     device=dev, corpus=corpus)
            for i, (want, _) in enumerate(ref.epoch(JPEG_STEPS)):
                if not all(torch.equal(x, y) for x, y in zip(kept[i], want)):
                    fail(f"[jpeg] (b) step {i}: the host-fed batch differs from the device-cache one")
            equal_note = f"all {JPEG_STEPS} batches bitwise equal to the device-cache pipeline's (same seed)"
        else:
            cpu = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS, seed=0,
                                     device="cpu", device_cache=False)
            first_draws = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, seed=0, device=dev,
                                             device_cache=False).draw()
            t0 = time.perf_counter()
            want, _ = cpu.load_augment(cpu._epoch_plan()[0][0], first_draws.to("cpu"))
            diff = (kept[0].images.float().cpu() - want.images.float()).abs() * 255.0
            worst, share = float(diff.max()), float((diff > 1e-3).float().mean())
            box_err = float((kept[0].boxes.cpu() - want.boxes).abs().max())
            if (worst > 9.0 + 1e-3 or share >= 0.001 or box_err > 1e-4
                    or not torch.equal(kept[0].mask.cpu(), want.mask)
                    or not torch.equal(kept[0].labels.cpu(), want.labels)):
                fail(f"[jpeg] (b) step 1 on the card against the CPU: pixels {worst}/255 on {share}, "
                     f"boxes {box_err}, or labels/mask differ")
            equal_note = (f"step 1 against the same pipeline on the CPU ({time.perf_counter() - t0:.2f} s "
                          f"there): max pixel difference {worst:.4f}/255 on {share:.6f} of pixels, boxes "
                          f"{box_err:.2e}, labels and masks equal")
        g0 = pb._epoch_plan()[0][0]
        pb.consumed_plan_log.pop()  # drawn for timing only
        enq, runs = whole_steps_enqueue(lambda: tr_b.train_step(pb.load_augment(g0, pb.draw())[0]))
        log(f"[jpeg] (b) device_cache=False, {JPEG_STEPS} steps: launches {counts['b']}; losses "
            f"{losses[0]:.4f}->{losses[-1]:.4f}; {(JPEG_STEPS - 1) * TRAIN_B / (t_last - t_first):.2f} img/s "
            f"over steps 2-{JPEG_STEPS}; host enqueue of one whole step, its group loaded on the host "
            f"(median of 5) {enq:.4f} ms (runs {runs}); {cache_note}; {equal_note} | {card}")
        del kept, tr_b, pb

        # (c) the host pipeline (the repo's default config), and its validation feed
        if not host_ok:
            log(f"[jpeg] (c) host pipeline not run: {'; '.join(missing[k] for k in ('cv2', 'Pillow') if k in missing)}")
        else:
            # the host augmentor also runs aug_params.yaml's colour extras (p=0.01 each),
            # which the device augment has not
            tr_c = Trainer(train_info, val_info, pipeline="host", num_workers=8, fake_mode=False,
                           root_dir=root, **{**kw, "aug_params": aug._replace(image_color_transforms=True)})
            marks.clear()

            def on_step_c(epoch, i, m):
                if i in (0, JPEG_STEPS - 1):
                    torch.cuda.synchronize()
                    marks[i] = time.perf_counter()

            zero_counts()
            m_c = tr_c.fit(max_epochs=1, epoch_steps=JPEG_STEPS, on_step=on_step_c)
            counts["c"] = read_counts()
            expect("c", counts["c"], {"gather_rows_planar": 0, "hsv_planar": 0, "warp_quadrants": 0,
                                      "greedy_nms_mask": n_val})
            em = tr_c.epoch_metrics[-1]
            if not np.isfinite(em["total"]).all() or not finite_map(m_c):
                fail(f"[jpeg] (c) losses or mAP not finite: {em['total']}, {m_c}")
            wait = tr_c.prefetcher.wait_seconds
            feed = iter(tr_c.prefetcher)
            batch = next(feed)
            feed.close()
            enq, runs = whole_steps_enqueue(lambda: tr_c.train_step(batch))
            log(f"[jpeg] (c) pipeline='host', num_workers=8, {JPEG_STEPS} steps and validation over "
                f"{JPEG_VAL_N} JPEG files: launches {counts['c']}; losses {em['total'][0]:.4f}->"
                f"{em['total'][-1]:.4f}, targets dropped {int(em['targets_dropped'])}; "
                f"{(JPEG_STEPS - 1) * TRAIN_B / (marks[JPEG_STEPS - 1] - marks[0]):.2f} img/s over steps "
                f"2-{JPEG_STEPS}; consumer waited on the queue {wait:.4f} s in all "
                f"({wait / JPEG_STEPS * 1e3:.4f} ms a step); host enqueue of one train step (median of 5) "
                f"{enq:.4f} ms (runs {runs}) | {card}")
            log("[jpeg] (c) validation " + json.dumps(m_c))
            del tr_c, batch

        # the two validation feeds on the same canvases
        vcache = tr_a.val_cache
        ds = DetectionDataset(val_info, CanvasReader(vcache, val_info), ValidationSampleAugmentor())
        host_feed = Prefetcher(ds, TRAIN_B, MAX_TARGETS, num_threads=8, drop_last=False, device=None)
        zero_counts()
        m_dev = tr_a.evaluator.validate(vcache)
        m_host = tr_a.evaluator.validate_batches(host_feed)
        val_counts = read_counts()["greedy_nms_mask"]
        if not same_map(m_dev, m_host) or val_counts != 2 * n_val:
            fail(f"[jpeg] validation feeds differ on the same canvases: {m_dev} against {m_host} "
                 f"(NMS launches {val_counts}, want {2 * n_val})")
        log(f"[jpeg] ValDeviceCache and the host feed over the same {len(vcache)} canvases: the same mAP "
            f"dict (map {m_dev['map']:.6g}); NMS launches {val_counts}")
    return counts


def phase_cli(card, counted, zero_counts, read_counts):
    """Phase 11: train, test and run recipes through ``cli.train.main`` on the
    card. Returns each run's launch counts."""
    import numpy as np

    from object_detection_cib_torch.cli.train import main as cli_main
    from object_detection_cib_torch.train import trainer as trainer_mod
    from object_detection_cib_torch.train.checkpoint import load_state

    made = []  # the Trainer of each run, to look inside
    from_config = trainer_mod.Trainer.from_config.__func__

    def recording(cls, cfg, mesh=None):
        made.append(from_config(cls, cfg, mesh))
        return made[-1]

    trainer_mod.Trainer.from_config = classmethod(recording)
    t_phase = time.perf_counter()
    common = ["hydra=static", "extras.enforce_tags=False", "print_config=False", "extras.print_config=False",
              "logger=csv"]
    counts = {}

    def run(part, out, *overrides):
        zero_counts()
        t0 = time.perf_counter()
        metrics = cli_main([*common, f"paths.output_dir={out}", *overrides])
        counts[part] = read_counts()
        return metrics, made[-1], time.perf_counter() - t0

    def expect(part, want):
        got = counts[part]
        for k, n in want.items():
            if got[k] != n:
                fail(f"[cli] ({part}) launched {k} {got[k]} times, want {n}")

    def close(a, b, tol=1e-6):
        return a.keys() == b.keys() and all(
            abs(a[k] - b[k]) <= tol or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)

    try:
        with tempfile.TemporaryDirectory(prefix="cli-runs-") as tmp:
            # configs/logger/many_loggers.yaml (the default) adds TensorBoard:
            # does its writer exist on this machine, or does it warn and no-op?
            import warnings

            from object_detection_cib_torch.utils.loggers import build_loggers, tensorboard_without_tensorflow

            tensorboard_without_tensorflow()  # as the CLI's program entry does
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                (tb,) = build_loggers({"tensorboard": {"save_dir": str(Path(tmp) / "tb")}})
            log(f"[cli] probe: logger 'tensorboard' -> {type(tb).__name__}"
                + "".join(f"; warned: {w.message}" for w in caught))
            getattr(tb, "finalize", lambda: None)()
            run_a = Path(tmp) / "a"
            device = ["data.pipeline=device", "data.device_cache=True", "dataset_name=fake",
                      f"data.fake_num_images={CLI_N}"]
            m_a, t_a, wall_a = run("a", run_a, "experiment=yv5s", *device, "trainer.max_epochs=2",
                                   "trainer.check_val_every_n_epoch=2")
            B = t_a.batch_size
            steps, blocks = CLI_N // B, -(-CLI_N // B)
            expect("a", {"gather_rows_planar": 2 * steps, "hsv_planar": 2 * steps, "warp_quadrants": 2 * steps,
                         "greedy_nms_mask": blocks})
            losses = np.concatenate([em["total"] for em in t_a.epoch_metrics])
            if len(losses) != 2 * steps or not np.isfinite(losses).all() or not finite_map(m_a):
                fail(f"[cli] (a) losses or mAP not finite: {losses}, {m_a}")
            files = ["checkpoints/best", "checkpoints/last", "checkpoints/meta.json", "csv/metrics.csv",
                     "hparams.json"]
            missing = [f for f in files if not (run_a / f).is_file()]
            if missing:
                fail(f"[cli] (a) run files missing: {missing}")
            ips_a = t_a.epoch_imgs[-1] / t_a.epoch_walls[-1]
            log(f"[cli] (a) experiment=yv5s yolov5s@{t_a.image_shape.width} B={B} compute dtype {t_a.net.dtype}: "
                f"{len(t_a.epoch_metrics)} epochs of {steps} "
                f"steps, one validation of {CLI_N} images; launches {counts['a']}; losses {losses[0]:.4f}->"
                f"{losses[-1]:.4f}; run files {files}; epoch 2: {ips_a:.2f} img/s ({t_a.epoch_imgs[-1]} images "
                f"in {t_a.epoch_walls[-1]:.4f} s, host clock); whole command {wall_a:.2f} s | {card}")
            log("[cli] (a) validation " + json.dumps(m_a))

            last = run_a / "checkpoints" / "last"
            saved = load_state(last)
            m_t, t_t, _ = run("a_test", Path(tmp) / "a_test", "experiment=yv5s", *device, "train=False",
                              "test=True", f"ckpt_path={last}")
            expect("a_test", {"gather_rows_planar": 0, "hsv_planar": 0, "warp_quadrants": 0,
                              "greedy_nms_mask": blocks})
            net_ok = all(torch.equal(v.cpu(), saved["net"][k]) for k, v in t_t.net.state_dict().items())
            mom_ok = all(torch.equal(v.cpu(), saved["optimizer"]["momentum"][k])
                         for k, v in t_t.optimizer.buffers.items())
            fit_val = {k: v for k, v in m_a.items() if k != "images_per_sec"}
            if not (net_ok and mom_ok and t_t.optimizer.step_count == 2 * steps):
                fail(f"[cli] (a) restored state differs from the checkpoint: net {net_ok}, momentum {mom_ok}, "
                     f"step {t_t.optimizer.step_count}")
            if not close(m_t, fit_val):
                fail(f"[cli] (a) test mAP {m_t} differs from the last validation {fit_val}")
            log(f"[cli] (a) train=False test=True ckpt_path=<run>/checkpoints/last: {len(saved['net'])} tensors "
                f"and {len(saved['optimizer']['momentum'])} momentum buffers restored bitwise, step_count "
                f"{t_t.optimizer.step_count}; test mAP equals the last validation's within 1e-6 (map "
                f"{m_t['map']:.6g}); launches {counts['a_test']}")

            m_b, t_b, wall_b = run("b", Path(tmp) / "b", "experiment=yv5s", "dataset_name=fake",
                                   "trainer.fast_dev_run=True")
            expect("b", {"gather_rows_planar": 0, "hsv_planar": 0, "warp_quadrants": 0, "greedy_nms_mask": 1})
            if t_b.prefetcher is None or not finite_map(m_b) or not np.isfinite(t_b.epoch_metrics[0]["total"]).all():
                fail(f"[cli] (b) not the host pipeline, or losses / mAP not finite: {m_b}")
            log(f"[cli] (b) data.pipeline=host (configs/data/default.yaml), trainer.fast_dev_run=True: one step "
                f"and one validation batch; launches {counts['b']}; loss {float(t_b.epoch_metrics[0]['total'][0]):.4f}; "
                f"{t_b.epoch_imgs[0] / t_b.epoch_walls[0]:.2f} img/s over its one step ({t_b.epoch_imgs[0]} "
                f"images in {t_b.epoch_walls[0]:.4f} s, the first host batch included); whole command "
                f"{wall_b:.2f} s | {card}")

            m_c, t_c, _ = run("c", Path(tmp) / "c", "experiment=imbalance/class_aware/default",
                              "data.mixup_prob=0.5", *device, "trainer.max_epochs=1",
                              "trainer.limit_train_batches=0.5", "trainer.limit_val_batches=0.2")
            n_c = max(int(steps * 0.5), 1)
            expect("c", {"gather_rows_planar": 2 * n_c, "hsv_planar": 2 * n_c, "warp_quadrants": 2 * n_c,
                         "greedy_nms_mask": max(int(blocks * 0.2), 1)})
            stats = t_c.sampler_stats(n_c)
            if not finite_map(m_c) or not np.isfinite(t_c.epoch_metrics[0]["total"]).all() or not sum(stats.values()):
                fail(f"[cli] (c) losses or mAP not finite, or no instance counted: {m_c}, {stats}")
            log(f"[cli] (c) experiment=imbalance/class_aware/default data.mixup_prob=0.5, limit_train_batches=0.5, "
                f"limit_val_batches=0.2: {len(t_c.epoch_metrics[0]['total'])} steps; launches {counts['c']}; "
                f"sampler_stats over the steps trained {stats}")
        log(f"[cli] phase 11: four commands in {time.perf_counter() - t_phase:.2f} s")
    finally:
        trainer_mod.Trainer.from_config = classmethod(from_config)
    return counts


FUSED_EPOCHS = 4  # phase 12: two fits of two epochs per loop, in turns
PROBE_STEPS = 6  # phase 12's batch probe: 3 batches made eagerly, 3 inside the graph
PROF_STEPS = 10  # phase 12's profiler window of replays


def _graph_nodes(graph):
    """(libcuda, node handles, node types) of a kept ``torch.cuda.CUDAGraph``
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            fail("cuGraphNodeGetType failed")
        kinds.append(kind.value)
    return cuda, list(nodes), kinds


def graph_nodes(graph):
    """(nodes, kernel nodes) of a kept ``torch.cuda.CUDAGraph``."""
    _, nodes, kinds = _graph_nodes(graph)
    return len(nodes), kinds.count(0)  # CU_GRAPH_NODE_TYPE_KERNEL = 0


def phase_fused(card, dev, aug, train_info, val_info, corpus, zero_counts, read_counts):
    """Phase 12: the fused epoch (the JAX package's default device-cache
    loop) at phase 8's width over phase 6's corpus, beside the step loop.
    Returns the fused fits' launch counts."""
    import numpy as np

    from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline
    from object_detection_cib_torch.train.trainer import Trainer

    steps = TRAIN_N // TRAIN_B
    t_phase = time.perf_counter()

    # the batches: the fused epoch (pipelined, a CUDA graph) against the step loop's iterator
    ref = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS, seed=0, device=dev,
                             corpus=corpus)
    probe = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS, seed=0, device=dev,
                               corpus=corpus)
    want = [b for b, _ in ref.epoch(PROBE_STEPS)]
    rec = [torch.empty((PROBE_STEPS,) + tuple(x.shape), dtype=x.dtype, device=dev) for x in want[0]]
    k = torch.zeros((), dtype=torch.int64, device=dev)

    def record(batch, *rows):
        for buf, x in zip(rec, batch):
            buf.index_copy_(0, k.view(1), x[None])
        k.add_(1)
        return batch.images.float().sum()

    fn = probe.build_fused_epoch_fn(record, pipelined=True, stack_metrics=True)
    fn(probe.epoch_host_arrays(PROBE_STEPS))
    torch.cuda.synchronize()
    for i, batch in enumerate(want):
        if not all(torch.equal(buf[i], x) for buf, x in zip(rec, batch)):
            fail(f"[fused] batch {i} of the fused epoch (CUDA graph) differs from the step loop's")
    made_in_graph = PROBE_STEPS - 1 - fn.WARMUP_STEPS
    log(f"[fused] batches: the first {PROBE_STEPS} of the fused epoch (pipelined, captured after "
        f"{fn.WARMUP_STEPS} eager warm-up steps; the last {made_in_graph} made inside the graph) bitwise "
        f"equal to the step loop's (images, boxes, labels, mask); graphs {sorted(fn.graphs)}")
    del ref, probe, want, rec, fn

    # the two loops in turns: step, fused, fused, step
    kw = dict(size="s", image_size=TRAIN_S, batch_size=TRAIN_B, aug_params=aug, max_targets=MAX_TARGETS,
              seed=0, dtype=torch.bfloat16, device=dev, corpus=corpus, max_epochs=FUSED_EPOCHS)
    loops = {"step": Trainer(train_info, val_info, fused_epoch=False, **kw),
             "fused": Trainer(train_info, val_info, **kw)}
    for t in loops.values():
        t.loop = t.loop._replace(check_val_every_n_epoch=2)
    t_f = loops["fused"]
    before = [p.detach().clone() for p in t_f.net.parameters()]
    n_val = math.ceil(len(val_info.samples) / TRAIN_B)
    counts, turns = {}, []
    for turn, (name, stop) in enumerate((("step", 2), ("fused", 2), ("fused", 4), ("step", 4))):
        t = loops[name]
        if name == "fused" and stop == 2:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        m = t.fit(max_epochs=stop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        want_n = {"gather_rows_planar": 2 * steps, "hsv_planar": 2 * steps, "warp_quadrants": 2 * steps,
                  "greedy_nms_mask": n_val}
        for kname, nw in want_n.items():
            if got[kname] != nw:
                fail(f"[fused] turn {turn} ({name}) launched {kname} {got[kname]} times, want {nw}")
        if name == "fused" and stop == 2:
            peak = torch.cuda.max_memory_allocated()
            counts = got
            unmoved = sum(torch.equal(a, b) for a, b in zip(before, t_f.net.parameters()))
            if unmoved:
                fail(f"[fused] {unmoved} of {len(before)} parameters did not move")
        losses = np.concatenate([em["total"] for em in t.epoch_metrics[-2:]])
        if not np.isfinite(losses).all() or not finite_map(m):
            fail(f"[fused] turn {turn} ({name}): losses or mAP not finite: {losses}, {m}")
        ips = sum(t.epoch_imgs[-2:]) / sum(t.epoch_walls[-2:])
        turns.append((name, ips))
        walls = t.device_epoch_walls() if name == "fused" else {}
        log(f"[fused] turn {turn} {name} loop, fit to epoch {stop}: {ips:.2f} img/s over its two epochs "
            f"(host clock, the epochs' walls summed: {[round(w, 4) for w in t.epoch_walls[-2:]]} s, "
            f"{'fetch to fetch' if name == 'fused' else 'start to fetch'}); epoch {stop} alone "
            f"{t.epoch_imgs[-1] / t.epoch_walls[-1]:.2f} img/s; device epoch walls (CUDA events) "
            f"{ {e: round(w, 4) for e, w in walls.items()} } s; whole fit {wall:.2f} s with one validation; "
            f"launches {got}; losses {losses[0]:.4f}->{losses[-1]:.4f}; map {m['map']:.6g} | {card}")
    first = [loops[n].epoch_metrics[0]["total"][:3] for n in ("step", "fused")]
    log(f"[fused] first three losses, step loop {first[0].tolist()} vs fused {first[1].tolist()} "
        f"(same weights, batches and order; equal where the card's kernels are deterministic)")
    log(f"[fused] peak memory of the first fused fit {peak / 2**30:.3f} GiB (max_memory_allocated, all "
        f"trainers alive) | {card}")

    # the fused epoch alone: host enqueue, device time, profiler, graph nodes
    fn = t_f._fused_fn
    pipe = t_f.pipeline
    opt = t_f.optimizer

    def epoch(n):
        xs = pipe.epoch_host_arrays(n)
        step0 = opt.step_count
        out = fn(xs, opt.hyper_table(step0, xs[0].shape[0]))
        opt.step_count = step0 + xs[0].shape[0]
        return out

    body = fn.graphs["body"]
    replay_ms = []
    real_replay = body.replay

    def timed_replay():
        t = time.perf_counter()
        real_replay()
        replay_ms.append((time.perf_counter() - t) * 1e3)

    body.replay = timed_replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch(None)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del body.replay
    enq_ms, dev_ms = (t1 - t0) / steps * 1e3, (t2 - t0) / steps * 1e3
    wait = statistics.median(replay_ms[2:])
    log(f"[fused] one whole epoch of {steps} steps from an idle card: the host returns from the enqueue "
        f"after {enq_ms:.4f} ms a step, done in {dev_ms:.4f} ms a step ({TRAIN_B * 1e3 / dev_ms:.2f} img/s, "
        f"host clock); one replay's call takes {replay_ms[0]:.4f} ms from the idle card, then "
        f"{replay_ms[1]:.4f}, then a median {wait:.4f} ms (replays 3-{len(replay_ms)}): the host waits on "
        f"the card's queue, ahead of it by about one step | {card}")
    nodes, kernels = graph_nodes(fn.graphs["body"].graph)
    last_nodes, last_kernels = graph_nodes(fn.graphs["last"].graph)
    log(f"[fused] graph of one step (make batch i+1 beside train step i): {nodes} nodes, {kernels} kernels; "
        f"the last step's (train only): {last_nodes} nodes, {last_kernels} kernels; launches held "
        f"{ {e.__name__: n for e, n in fn.graphs['body'].launches.items()} }")

    from torch.profiler import ProfilerActivity, profile

    epoch(PROF_STEPS)  # the same shapes once more, untraced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(PROF_STEPS)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(getattr(e, "self_device_time_total", 0) for e in dev_events) / 1e3 / PROF_STEPS
    per_step = sum(e.count for e in dev_events) / PROF_STEPS
    # two streams overlap: the busy time is the union of the kernels' intervals, not their sum
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, None
    for a, b in spans:
        if reach is None or a > reach:
            busy_us += b - a
            reach = b
        elif b > reach:
            busy_us += b - reach
            reach = b
    if spans:
        window = max(b for _, b in spans) - spans[0][0]
        log(f"[fused] profiler over a {PROF_STEPS}-step fused epoch: kernels {per_step:.0f} a step taking "
            f"{kernel_ms:.4f} ms a step summed; the card busy (union of kernel intervals, two streams) "
            f"{busy_us / 1e3 / PROF_STEPS:.4f} ms a step of the window's {window / 1e3 / PROF_STEPS:.4f}: "
            f"device idle share {1 - busy_us / window:.4f} | {card}")
    else:
        log("[fused] profiler: no device time in the trace of the replays; busy and idle share not measured")
    ips = {n: [v for m_, v in turns if m_ == n] for n in ("step", "fused")}
    log(f"[fused] in turns (step, fused, fused, step): img/s step {ips['step']}, fused {ips['fused']}; "
        f"phase 12 {time.perf_counter() - t_phase:.2f} s | {card}")
    del loops, t_f, fn
    return counts


# ------------------------------------------------------------ 13 ddp
DDP_N, DDP_VAL, DDP_STEPS = 640, 128, 10  # phase 13 (a) and (b): 640 train images, 10 steps of B=64
MESH_PER_CARD = 1280  # phase 13 (c): fake images a card (20 steps an epoch at 64 a card)


def _kernel_entries():
    from object_detection_cib_torch.ops import gather as gather_ops
    from object_detection_cib_torch.ops import hsv as hsv_ops
    from object_detection_cib_torch.ops import nms as nms_ops
    from object_detection_cib_torch.ops import warp as warp_ops

    return (gather_ops.gather_rows_planar, gather_ops.gather_rows_flat, hsv_ops.hsv_planar,
            warp_ops.warp_quadrants, nms_ops.greedy_nms_mask)


def _zero_kernels():
    for fn in _kernel_entries():
        fn.launches = 0


def _read_kernels():
    return {fn.__name__: fn.launches for fn in _kernel_entries()}


def graph_kernel_names(graph):
    """The function name of every kernel node of a kept ``torch.cuda.CUDAGraph``
    (``cuGraphKernelNodeGetParams_v2``, then ``cuFuncGetName`` or
    ``cuKernelGetName``); None where libcuda gives no name."""

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                    ("shared", ctypes.c_uint), ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cuda, nodes, kinds = _graph_nodes(graph)
    names = []
    for node, kind in zip(nodes, kinds):
        if kind != 0:
            continue
        p, name = Params(), ctypes.c_char_p()
        if cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)):
            names.append(None)
        elif p.func and not cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)):
            names.append(name.value.decode())
        elif p.kern and not cuda.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)):
            names.append(name.value.decode())
        else:
            names.append(None)
    return names


def _ddp_infos(n_train: int, n_val: int):
    from object_detection_cib_torch.data.synthetic import build_fake_manifest

    return (build_fake_manifest(num_images=n_train, num_classes=NC, image_size=TRAIN_S, seed=0),
            build_fake_manifest(num_images=n_val, num_classes=NC, image_size=TRAIN_S, seed=1))


def _ddp_card():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _ddp_fused_rank(mesh):
    """Phase 13 (a), in a one-rank NCCL group: one fused epoch of 10 steps
    with its validation."""
    import numpy as np

    from object_detection_cib_torch.models.layers import BatchNorm
    from object_detection_cib_torch.parallel.distributed import all_reduce_sum_
    from object_detection_cib_torch.train.trainer import Trainer

    _ddp_card()
    train_info, val_info = _ddp_infos(DDP_N, DDP_VAL)
    t = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B, max_targets=MAX_TARGETS,
                seed=0, dtype=torch.bfloat16, device=mesh.device, mesh=mesh, max_epochs=1)
    n_bn = sum(isinstance(m, BatchNorm) for m in t.net.modules())
    _zero_kernels()
    calls = all_reduce_sum_.calls
    t0 = time.perf_counter()
    m = t.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_kernels()
    fn = t._fused_fn
    names = {g: graph_kernel_names(fn.graphs[g].graph) for g in fn.graphs}
    return dict(counts=counts, calls=all_reduce_sum_.calls - calls, n_bn=n_bn, graphs=sorted(fn.graphs),
                warmup=fn.WARMUP_STEPS, losses=np.asarray(t.epoch_metrics[0]["total"]).tolist(), map=m,
                kernel_nodes={g: len(v) for g, v in names.items()},
                unnamed={g: sum(x is None for x in v) for g, v in names.items()},
                nccl={g: sorted({x for x in v if x and "nccl" in x.lower()}) for g, v in names.items()},
                nccl_nodes={g: sum(1 for x in v if x and "nccl" in x.lower()) for g, v in names.items()},
                wall=wall, peak=torch.cuda.max_memory_allocated(mesh.device))


def _ddp_gloo_rank(mesh):
    """Phase 13 (b), one of two gloo ranks on one card: 10 steps of the step
    loop at a global batch of 64 and one validation of this rank's shard."""
    import hashlib

    import numpy as np

    from object_detection_cib_torch.train.trainer import Trainer

    _ddp_card()
    train_info, val_info = _ddp_infos(DDP_N, DDP_VAL)
    t = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B, max_targets=MAX_TARGETS,
                seed=0, dtype=torch.bfloat16, device=mesh.device, mesh=mesh, max_epochs=1, fused_epoch=False)
    _zero_kernels()
    t0 = time.perf_counter()
    m = t.fit(max_epochs=1, epoch_steps=DDP_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_kernels()
    state = {k: v.detach().cpu() for k, v in t.net.state_dict().items()}
    digest = hashlib.sha256(b"".join(v.float().numpy().tobytes() for v in state.values())).hexdigest()
    return dict(counts=counts, losses=np.asarray(t.epoch_metrics[0]["total"]).tolist(), map=m, digest=digest,
                state=state if mesh.is_main else None, val_images=len(t.val_cache), wall=wall,
                ips=t.epoch_imgs[0] / t.epoch_walls[0])


def _busy_idle(prof):
    """(device busy ms, window ms, NCCL kernels' ms) of a profiler trace: the
    busy time is the union of the kernels' intervals (streams overlap)."""
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, reach = 0.0, None
    for a, b in spans:
        if reach is None or a > reach:
            busy, reach = busy + b - a, b
        elif b > reach:
            busy, reach = busy + b - reach, b
    nccl = sum(e.time_range.end - e.time_range.start for e in evs if "nccl" in e.name.lower())
    window = (max(b for _, b in spans) - spans[0][0]) if spans else 0.0
    return busy / 1e3, window / 1e3, nccl / 1e3


def _ddp_mesh_run(mesh, cfg):
    """Phase 13 (c), one rank of ``cli.train``'s data-parallel run of ``cfg``
    (``train(cfg, mesh)``'s trainer; no mesh: one card alone): two fused
    epochs validated once, then a profiled 10-step fused epoch."""
    from torch.profiler import ProfilerActivity, profile

    from object_detection_cib_torch.parallel.distributed import all_reduce_sum_, reduce_scatter_sum
    from object_detection_cib_torch.train.trainer import Trainer

    _ddp_card()
    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    t = Trainer.from_config(cfg, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_kernels()
    calls = (all_reduce_sum_.calls, reduce_scatter_sum.calls)
    t0 = time.perf_counter()
    m = t.fit()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = _read_kernels()
    calls = (all_reduce_sum_.calls - calls[0], reduce_scatter_sum.calls - calls[1])
    peak = torch.cuda.max_memory_allocated(dev)
    fn, pipe, opt = t._fused_fn, t.pipeline, t.optimizer
    names = graph_kernel_names(fn.graphs["body"].graph)

    def epoch(n):
        xs = pipe.epoch_host_arrays(n)
        step0 = opt.step_count
        fn(xs, opt.hyper_table(step0, xs[0].shape[0]))
        opt.step_count = step0 + xs[0].shape[0]

    epoch(PROF_STEPS)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(PROF_STEPS)
        torch.cuda.synchronize(dev)
    busy, window, nccl = _busy_idle(prof)
    return dict(counts=counts, calls=calls, map=m, peak=peak, wall=wall,
                ips_epochs=[i / w for i, w in zip(t.epoch_imgs, t.epoch_walls)],
                ips=sum(t.epoch_imgs) / sum(t.epoch_walls), device_walls=t.device_epoch_walls(),
                kernel_nodes=len(names), nccl_nodes=sum(1 for x in names if x and "nccl" in x.lower()),
                nccl_names=sorted({x for x in names if x and "nccl" in x.lower()}),
                prof_steps=PROF_STEPS, busy_ms=busy, window_ms=window, nccl_ms=nccl,
                batch=t.batch_size, steps=t.steps_per_epoch, held_rows=int(pipe.corpus.shape[0]))


def phase_ddp(card):
    """Phase 13: data-parallel training through the launcher: (a) a
    one-rank NCCL group over the fused epoch, (b) two gloo ranks on one
    card over the step loop against one process, (c) with two or more
    cards, ``cli.train trainer=mesh`` on N = min(count, 4) NCCL ranks
    against one card. Returns the ranks' launch counts."""
    import warnings

    import numpy as np

    from object_detection_cib_torch.config import compose
    from object_detection_cib_torch.parallel import distributed
    from object_detection_cib_torch.train.trainer import Trainer

    def launch(*args, **kw):
        """``distributed.launch``, its warnings (a rank terminated after
        handing back its result) printed."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = distributed.launch(*args, **kw)
        for w in caught:
            log(f"[ddp] launcher warning: {w.message}")
        return out

    t_phase = time.perf_counter()
    out = {}
    # (a) one NCCL rank, the fused epoch
    (a,) = launch(_ddp_fused_rank, 1, device_type="cuda", timeout_s=300, join_timeout_s=600)
    steps = DDP_N // TRAIN_B
    want = {"gather_rows_planar": steps, "hsv_planar": steps, "warp_quadrants": steps,
            "greedy_nms_mask": -(-DDP_VAL // TRAIN_B)}
    for k, n in want.items():
        if a["counts"][k] != n:
            fail(f"[ddp] (a) launched {k} {a['counts'][k]} times, want {n}")
    per_step = 3 * a["n_bn"] + 2  # BatchNorm: 2 forward, 1 backward; the loss's counts; the gradient bucket
    python_steps = a["warmup"] + len(a["graphs"])  # eager warm-up steps, then one capture per graph
    if a["calls"] != python_steps * per_step + 1:
        fail(f"[ddp] (a) {a['calls']} all-reduces issued, want {python_steps} x {per_step} + 1 (the epoch's metrics)")
    if not (np.isfinite(a["losses"]).all() and finite_map(a["map"])):
        fail(f"[ddp] (a) losses or mAP not finite: {a['losses']}, {a['map']}")
    log(f"[ddp] (a) launch(1 rank, NCCL) fused epoch yolov5s@{TRAIN_S} B={TRAIN_B} bf16, {DDP_N} fake images, "
        f"{steps} steps + validation of {DDP_VAL}: launches {a['counts']} (training kernels by replay); "
        f"graphs {a['graphs']} captured after {a['warmup']} eager steps; all-reduces issued {a['calls']} = "
        f"{python_steps} step bodies run in Python (warm-up and captures) x {per_step} ({a['n_bn']} BatchNorms "
        f"x 3 + loss counts + gradient bucket) + 1 epoch metric sum; kernel nodes {a['kernel_nodes']}, "
        f"of them named nccl {a['nccl_nodes']} {a['nccl']}, unnamed {a['unnamed']}; losses {a['losses'][0]:.4f}->"
        f"{a['losses'][-1]:.4f}; map {a['map']['map']:.6g}; fit {a['wall']:.2f} s; peak {a['peak'] / 2**30:.3f} "
        f"GiB | {card}")
    out["a"] = a["counts"]

    # (b) two gloo ranks on this card, the step loop, against one process
    ranks = launch(_ddp_gloo_rank, 2, device_type="cuda", backend="gloo", devices=[0, 0], timeout_s=300,
                   join_timeout_s=600)
    shard_blocks = -(-(DDP_VAL // 2) // TRAIN_B)
    for r, res in enumerate(ranks):
        want = {"gather_rows_planar": DDP_STEPS, "hsv_planar": DDP_STEPS, "warp_quadrants": DDP_STEPS,
                "greedy_nms_mask": shard_blocks}
        for k, n in want.items():
            if res["counts"][k] != n:
                fail(f"[ddp] (b) rank {r} launched {k} {res['counts'][k]} times, want {n}")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        fail("[ddp] (b) the two ranks' weights differ after the steps")
    train_info, val_info = _ddp_infos(DDP_N, DDP_VAL)
    one = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B, max_targets=MAX_TARGETS,
                  seed=0, dtype=torch.bfloat16, device="cuda", max_epochs=1, fused_epoch=False)
    one.fit(max_epochs=1, epoch_steps=3)
    first = np.asarray(one.epoch_metrics[0]["total"][:3])
    got = np.asarray(ranks[0]["losses"][:3])
    if not np.allclose(got, first, rtol=1e-3, atol=0):
        fail(f"[ddp] (b) first three losses {got.tolist()} vs one process {first.tolist()} beyond rtol 1e-3")
    one.net.load_state_dict(ranks[0]["state"])
    whole = one.validate()
    merged = {k: v for k, v in ranks[0]["map"].items() if k != "images_per_sec"}
    if not (same_map(merged, whole) and same_map(merged, {k: v for k, v in ranks[1]["map"].items()
                                                          if k != "images_per_sec"})):
        fail(f"[ddp] (b) the merged mAP dict {merged} differs from one process's {whole}")
    log(f"[ddp] (b) launch(2 ranks, gloo, both on cuda:0) step loop yolov5s@{TRAIN_S} global B={TRAIN_B} "
        f"({TRAIN_B // 2} a rank) bf16, {DDP_STEPS} steps + validation: launches rank 0 {ranks[0]['counts']}, "
        f"rank 1 {ranks[1]['counts']} (K1 over each rank's {ranks[0]['val_images']} of {DDP_VAL} val images); "
        f"weights equal on both ranks; first three losses {got.tolist()} vs one process {first.tolist()} "
        f"(rtol 1e-3); merged mAP dict equal to one process's on the same weights (map {whole['map']:.6g}); "
        f"{ranks[0]['ips']:.2f} img/s (two processes sharing one card over gloo: not a rate to compare) | {card}")
    out["b"] = {k: ranks[0]["counts"][k] + ranks[1]["counts"][k] for k in ranks[0]["counts"]}
    del one

    # (c) N cards over cli.train trainer=mesh
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[ddp] (c) needs 2 cards, this machine shows {count}: not run")
    else:
        n = min(count, 4)
        with tempfile.TemporaryDirectory(prefix="ddp-mesh-") as tmp:
            def cfg(ranks_, *extra):
                return compose(Path(__file__).resolve().parent / "configs", "train", [
                    "experiment=yv5s", "trainer=mesh", f"trainer.num_devices={ranks_}", "data.pipeline=device",
                    "data.device_cache=True", "dataset_name=fake", f"data.fake_num_images={MESH_PER_CARD * ranks_}",
                    f"data.batch_size={TRAIN_B * ranks_}", "trainer.max_epochs=2",
                    "trainer.check_val_every_n_epoch=2", "trainer.limit_val_batches=0.25", "logger=csv",
                    "hydra=static", "extras.enforce_tags=False", "print_config=False", "extras.print_config=False",
                    f"paths.output_dir={tmp}/{ranks_}-{len(extra)}", *extra])

            runs = {}
            runs["1 card"] = [_ddp_mesh_run(None, cfg(1))]
            torch.cuda.empty_cache()  # rank 0 shares card 0 with this process
            runs[f"{n} cards"] = launch(_ddp_mesh_run, n, (cfg(n),), timeout_s=600, join_timeout_s=1200)
            runs[f"{n} cards, sharded"] = launch(_ddp_mesh_run, n, (cfg(n, "data.corpus_sharding=sharded"),),
                                                timeout_s=600, join_timeout_s=1200)
        base = runs["1 card"][0]["ips"]
        for name, rs in runs.items():
            r0 = rs[0]
            steps_c = 2 * r0["steps"]
            for r, res in enumerate(rs):
                for k in ("gather_rows_planar", "hsv_planar", "warp_quadrants"):
                    if res["counts"][k] != steps_c:
                        fail(f"[ddp] (c) {name} rank {r} launched {k} {res['counts'][k]} times, want {steps_c}")
                if not finite_map(res["map"]):
                    fail(f"[ddp] (c) {name} rank {r}: mAP not finite {res['map']}")
            maps = {json.dumps({k: v for k, v in res["map"].items() if k != "images_per_sec"}) for res in rs}
            if len(maps) != 1:
                fail(f"[ddp] (c) {name}: the ranks read different mAP dicts")
            idle = [round(1 - res["busy_ms"] / res["window_ms"], 4) if res["window_ms"] else None for res in rs]
            log(f"[ddp] (c) {name}: yolov5s@{TRAIN_S} global B={r0['batch']} bf16 fused epoch, {r0['steps']} steps an "
                f"epoch x 2: {r0['ips']:.2f} img/s over both epochs' windows (rank 0, host clock; per epoch "
                f"{[round(x, 2) for x in r0['ips_epochs']]}), {r0['ips'] / base:.4f}x the one card's; device epoch "
                f"walls {r0['device_walls']}; launches rank 0 {r0['counts']}; collectives issued (all-reduce, "
                f"reduce-scatter) {r0['calls']}; graph kernel nodes {r0['kernel_nodes']}, NCCL {r0['nccl_nodes']} "
                f"{r0['nccl_names'][:3]}; profiled {r0['prof_steps']} steps: NCCL kernels {r0['nccl_ms'] / r0['prof_steps']:.4f} "
                f"ms a step, busy {r0['busy_ms'] / r0['prof_steps']:.4f} of {r0['window_ms'] / r0['prof_steps']:.4f} ms "
                f"a step; idle share per rank {idle}; peak memory per rank "
                f"{[round(res['peak'] / 2**30, 3) for res in rs]} GiB, corpus rows held {r0['held_rows']}; "
                f"map {r0['map']['map']:.6g} | {card}")
        out["c"] = {k: sum(res["counts"][k] for res in runs[f"{n} cards"]) for k in runs[f"{n} cards"][0]["counts"]}
    log(f"[ddp] phase 13 {time.perf_counter() - t_phase:.2f} s | {card}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="root of another checkout whose four kernel sources are timed beside")
    ap.add_argument("--phase", choices=["all", "ddp"], default="all",
                    help="ddp: phases 1, 2 and 13 alone (data parallelism; (c) needs two or more cards)")
    args = ap.parse_args()
    # ---------------------------------------------------------------- 1 device
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    root = Path(__file__).resolve().parent
    if not (root / "object_detection_cib_torch").is_dir():
        fail(f"object_detection_cib_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(root))

    import numpy as np

    from object_detection_cib_torch.core.nms import non_max_suppression, select_candidates
    from object_detection_cib_torch.core.types import FeatureShape, default_anchors
    from object_detection_cib_torch.data.device_pipeline import (
        DeviceDataPipeline,
        augment_group,
        draw_augment,
    )
    from object_detection_cib_torch.data.host_augment import AugParams, HSVParams
    from object_detection_cib_torch.data.samplers import ClassAwareSampler, RepeatFactorSampler
    from object_detection_cib_torch.data.synthetic import build_fake_manifest
    from object_detection_cib_torch.data.val_cache import ValDeviceCache
    from object_detection_cib_torch.eval.decode import decode_predictions
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.ops import augment as aug_ops
    from object_detection_cib_torch.ops import gather as gather_ops
    from object_detection_cib_torch.ops import hsv as hsv_ops
    from object_detection_cib_torch.ops import nms as nms_ops
    from object_detection_cib_torch.ops import warp as warp_ops
    from object_detection_cib_torch.ops.build import REPORTS, build_all, kernel_usage
    from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
    from object_detection_cib_torch.train.steps import make_eval_step, make_train_step
    from object_detection_cib_torch.train.trainer import Evaluator, Trainer, plan_instance_counts

    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda")
    anchors = default_anchors()

    # ----------------------------------------------------------------- 2 build
    t0 = time.perf_counter()
    libs = build_all(verbose=True)
    log(f"[build] setup: nvcc {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    baselines = {}  # checkout dir -> {source: library}
    for b in args.baseline:
        t0 = time.perf_counter()
        built = build_all(["gather", "hsv", "nms", "warp"],
                          csrc=b / "object_detection_cib_torch" / "ops" / "csrc")
        baselines[b] = {n: ctypes.CDLL(str(p)) for n, p in built.items()}
        log(f"[build] baseline {b}: {', '.join(built)} in {time.perf_counter() - t0:.2f} s")
    if args.phase == "ddp":
        ddp = phase_ddp(card)
        print(json.dumps({"ddp_launches": ddp}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    usage = {}  # kernel entry -> (registers per thread, static shared bytes), from ptxas
    for report in REPORTS.values():
        usage.update(kernel_usage(report))

    def resources(entry_part: str, dynamic: int) -> str:
        found = [(e, u) for e, u in usage.items() if entry_part in e]
        if not found:
            return f"registers not reported, shared memory {dynamic} B dynamic per block"
        return "; ".join(f"{e}: {r} registers per thread, {st + dynamic} B shared memory per block "
                         f"({st} static + {dynamic} dynamic)" for e, (r, st) in found)

    # -------------------------------------------------- 3 kernels vs plain
    def rand_case(K, n_real, seed, span, wh):
        g = torch.Generator().manual_seed(seed)
        boxes = torch.zeros(1, K, 4)
        xy = torch.rand(n_real, 2, generator=g) * span
        sz = wh[0] + torch.rand(n_real, 2, generator=g) * (wh[1] - wh[0])
        boxes[0, :n_real] = torch.cat([xy, xy + sz], -1)
        live = torch.zeros(1, K, dtype=torch.bool)
        live[0, :n_real] = True
        return boxes.to(dev), live.to(dev)

    chain = torch.zeros(1, 256, 4)
    chain[0, :3] = torch.tensor([[0, 0, 10, 10], [3, 0, 13, 10], [6, 0, 16, 10]], dtype=torch.float32)
    chain_live = torch.zeros(1, 256, dtype=torch.bool)
    chain_live[0, :3] = True

    net = build_network(NC, "s", dtype=torch.bfloat16, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand(SERVE_B, SERVE_S, SERVE_S, 3, device=dev, generator=g)
    with torch.inference_mode():
        det = decode_predictions(net.eval()(images), anchors)
        cand = select_candidates(det, CONF, max_nms=MAX_NMS)
    n_pass = (cand.live.sum(dim=1)).tolist()
    log(f"[kernels] yolov5s@640 candidates past conf {CONF}: min {min(n_pass)} max {max(n_pass)} "
        f"of K={cand.live.shape[1]} (detections per image {det.shape[1] * NC})")

    def batch_case(B, K, seed):
        """Random boxes of three classes (offset 4096 apart), ~90% live."""
        g = torch.Generator().manual_seed(seed)
        xy = torch.rand(B, K, 2, generator=g) * 300.0
        sz = 5.0 + torch.rand(B, K, 2, generator=g) * 85.0
        cls = torch.randint(0, 3, (B, K, 1), generator=g).float() * 4096.0
        live = torch.rand(B, K, generator=g) > 0.1
        return (torch.cat([xy, xy + sz], -1) + cls).to(dev), live.to(dev)

    # image 0: no live box; image 1: disjoint boxes, all kept; image 2: equal
    # boxes, box 0 suppresses all others
    edge = torch.zeros(3, 300, 4)
    edge[:2, :, 0] = torch.arange(300.0) * 20.0
    edge[:2, :, 2] = edge[:2, :, 0] + 10.0
    edge[:2, :, 3] = 10.0
    edge[2] = torch.tensor([0.0, 0.0, 100.0, 100.0])
    edge_live = torch.ones(3, 300, dtype=torch.bool)
    edge_live[0] = False

    cases = {
        "chain K=256": (chain.to(dev), chain_live.to(dev), 0.45),
        "random K=256": (*rand_case(256, 200, 0, 200, (10, 80)), 0.45),
        "random K=2048 900 live": (*rand_case(2048, 900, 5, 400, (10, 90)), 0.5),
        "random K=1000 ragged": (*rand_case(1000, 700, 6, 300, (10, 80)), 0.45),
        "random K=64 (one word)": (*batch_case(2, 64, 7), 0.45),
        "random K=65 (one word and one box)": (*batch_case(2, 65, 8), 0.45),
        "random B=64 K=2048 (the validation batch)": (*batch_case(VAL_B, 2048, 9), IOU),
        "none live / all kept / box 0 suppresses all, K=300": (edge.to(dev), edge_live.to(dev), 0.5),
        "yolov5s@640 B=1 K=2048": (cand.offset_boxes[:1], cand.live[:1], IOU),
        "yolov5s@640 B=32 K=2048": (cand.offset_boxes, cand.live, IOU),
    }
    max_err = 0
    for name, (boxes, live, thr) in cases.items():
        got = nms_ops.greedy_nms_mask(boxes, live, thr)
        torch.cuda.synchronize()
        want = nms_ops.greedy_nms_mask_plain(boxes, live, thr)
        err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
        max_err = max(max_err, err)
        log(f"[kernels] greedy_nms_mask {name}: kept {int(got.sum())}/{int(live.sum())} "
            f"bitwise_equal={torch.equal(got, want)}")
        if not torch.equal(got, want):
            fail(f"greedy_nms_mask disagrees with its plain version on {name}")
        if name.startswith("chain") and got[0, :3].tolist() != [True, False, True]:
            fail("chain case: greedy NMS must keep {A, C}")
        if name.startswith("none live") and (
                got[0].any() or not got[1].all() or got[2].nonzero().flatten().tolist() != [0]):
            fail("edge cases: want nothing kept, everything kept, only box 0 kept")
        del want

    boxes, live, thr = cases["yolov5s@640 B=32 K=2048"]
    keep = nms_ops.greedy_nms_mask(boxes, live, thr)
    nms_ms, plain_ms, turns = in_turns(lambda: nms_ops.greedy_nms_mask(boxes, live, thr),
                                       lambda: nms_ops.greedy_nms_mask_plain(boxes, live, thr), 30, 5)
    B, K = live.shape
    nms_bytes = B * K * (16 + 1 + 1)  # boxes f32x4 + live u8 in, keep u8 out
    pairs = nms_pairs_needed(keep, live)
    bound_ms, bound_by = bound(nms_bytes, pairs * NMS_OPS_PER_PAIR)
    log(f"[kernels] greedy_nms_mask B={B} K={K}: kernel {nms_ms:.4f} ms (turns {turns['kernel']}), "
        f"plain {plain_ms:.4f} ms (turns {turns['plain']}) | {card}")
    _, sweeps = nms_ops.greedy_nms_mask_plain(boxes, live, thr, with_sweeps=True)
    kept_n = keep.sum(dim=1)
    log(f"[kernels] bound: {nms_bytes} B at 3.35 TB/s, {pairs} pair tests x {NMS_OPS_PER_PAIR} ops "
        f"at 67 TFLOP/s -> {bound_ms:.6f} ms ({bound_by}); dependency depth: the plain version "
        f"reaches its fixpoint in {sweeps} sweeps; kept per image min {int(kept_n.min())} max "
        f"{int(kept_n.max())} of {int(live.sum(dim=1).min())}..{int(live.sum(dim=1).max())} live")
    call_ms = {"greedy_nms_mask": (cuda_ms(lambda: nms_ops.greedy_nms_mask(boxes, live, thr), 30), None)}
    log(f"[kernels] greedy_nms_mask one call from an idle stream, host launch path included (median "
        f"of 30): {call_ms['greedy_nms_mask'][0]:.4f} ms | {card}")
    one_ms, one_plain_ms, turns = in_turns(
        lambda: nms_ops.greedy_nms_mask(boxes[:1], live[:1], thr),
        lambda: nms_ops.greedy_nms_mask_plain(boxes[:1], live[:1], thr), 30, 5)
    log(f"[kernels] greedy_nms_mask B=1 K={K} (the batch's first image alone), in a row: kernel "
        f"{one_ms:.4f} ms, plain {one_plain_ms:.4f} ms (turns {turns}) | {card}")
    log(f"[kernels] nms.cu at K={K}: {resources('pair_kernel', 0)}; "
        f"{resources('scan_kernel', nms_ops.scan_smem_bytes(K))}")

    def nms_direct(lib, bx, lv):
        """A checkout's nms.cu called straight through ctypes, by the
        interface it has: (call, keep buffer)."""
        nb, nk = lv.shape
        out = torch.zeros_like(lv)
        fn = lib.odcib_greedy_nms_mask
        args = [bx.data_ptr(), lv.data_ptr(), out.data_ptr()]
        types = [ctypes.c_void_p] * 3
        ws = None
        if hasattr(lib, "odcib_nms_workspace_bytes"):
            lib.odcib_nms_workspace_bytes.argtypes = [ctypes.c_int]
            lib.odcib_nms_workspace_bytes.restype = ctypes.c_longlong
            ws = torch.empty(nb * lib.odcib_nms_workspace_bytes(nk), dtype=torch.uint8, device=dev)
            args += [ws.data_ptr(), nb]
            types += [ctypes.c_void_p, ctypes.c_int]
        args += [nb, nk, float(thr), torch.cuda.current_stream().cuda_stream]
        fn.argtypes = types + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]

        def call(ws=ws):  # the workspace lives as long as the call does
            check_err(fn(*args))

        return call, out

    for b, blibs in baselines.items():
        for bx, lv, want in ((boxes, live, keep), (boxes[:1], live[:1], keep[:1])):
            base_nms, got = nms_direct(blibs["nms"], bx, lv)
            base_nms()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"baseline {b} greedy_nms_mask disagrees at B={lv.shape[0]}")
            k_ms, b_ms, turns = in_turns(lambda: nms_ops.greedy_nms_mask(bx, lv, thr), base_nms, 30, 30)
            log(f"[kernels] greedy_nms_mask B={lv.shape[0]} K={K}, in a row: this checkout {k_ms:.4f} ms, "
                f"baseline {b} {b_ms:.4f} ms, bitwise_equal=True (turns {turns}) | {card}")

    # ------------------------------------------------------------- 4 serving
    estep = make_eval_step(net, anchors, conf_thres=CONF, iou_thres=IOU,
                           max_det=MAX_DET, max_nms=MAX_NMS)
    for _ in range(2):
        estep(images)
    torch.cuda.synchronize()
    steps = SERVE_STEPS
    nms_ops.greedy_nms_mask.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        res = estep(images)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = nms_ops.greedy_nms_mask.launches
    if serve_launches != steps:
        fail(f"serving path launched the NMS kernel {serve_launches} times in {steps} steps")
    if tuple(res.boxes.shape) != (SERVE_B, MAX_DET, 4) or not torch.isfinite(res.boxes).all():
        fail(f"serving result: bad boxes {tuple(res.boxes.shape)}")
    if not (res.num_valid > 0).all() or not (res.scores[res.valid] > CONF).all():
        fail("serving result: an image without detections, or a score below conf")
    img_s = SERVE_B * steps / serve_s
    log(f"[serving] yolov5s nc={NC} {SERVE_S}x{SERVE_S} B={SERVE_B} bf16: {steps} eval steps in "
        f"{serve_s:.4f} s = {img_s:.2f} img/s; NMS launches {serve_launches} "
        f"({serve_launches / steps:g} per step); detections per image "
        f"{res.num_valid.min().item()}..{res.num_valid.max().item()} | {card}")

    # host time to enqueue one step from an idle card: above the device time,
    # the step is bound by the host's launches, not by the card
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        estep(images)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    log(f"[serving] host enqueue of one eval step (median of 5): {statistics.median(enqueue):.4f} ms "
        f"(runs {[round(t, 4) for t in enqueue]}) | {card}")

    with torch.inference_mode():
        out = net(images)
        det = decode_predictions(out, anchors)
        stage = {
            "forward": cuda_ms(lambda: net(images), 10),
            "decode": cuda_ms(lambda: decode_predictions(out, anchors), 10),
            "nms": cuda_ms(lambda: non_max_suppression(det, CONF, IOU, max_det=MAX_DET,
                                                       max_nms=MAX_NMS), 10),
        }
    log("[serving] ms per stage (CUDA events, median of 10): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage.items()) + f" | {card}")

    # the same port on the CPU agrees on a small f32 input
    small = build_network(3, "n", device="cpu", seed=1).eval()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        det_cpu = decode_predictions(small(x), anchors)
        det_gpu = decode_predictions(small.to(dev)(x.to(dev)), anchors)
        if not torch.allclose(det_gpu.cpu(), det_cpu, atol=1e-3, rtol=1e-3):
            fail("small f32 forward+decode: CUDA and CPU disagree beyond 1e-3")
        r_gpu = non_max_suppression(det_gpu, CONF, IOU)
        r_cpu = non_max_suppression(det_gpu.cpu(), CONF, IOU)
    for a, b in zip(r_gpu, r_cpu):
        if not torch.equal(a.cpu(), b):
            fail("small input: NMS on CUDA (kernel) and CPU (plain) differ")
    log(f"[serving] small f32 check: CUDA vs CPU decode within 1e-3, NMS identical "
        f"({r_cpu.num_valid.tolist()} kept)")

    # ---------------------------------------------------------- 5 validation
    info = build_fake_manifest(num_classes=NC, num_images=VAL_N, image_size=VAL_S,
                               zipf_a=1.01, seed=0)
    t0 = time.perf_counter()
    cache = ValDeviceCache(info, range(VAL_N), VAL_S, 120, fake_mode=True)
    ev = Evaluator(net, anchors, info.classes, batch_size=VAL_B, device=dev)
    ev.device_blocks(cache)
    torch.cuda.synchronize()
    log(f"[validation] setup: {VAL_N} canvases at {VAL_S} on the card in {time.perf_counter() - t0:.2f} s")
    nms_ops.greedy_nms_mask.launches = 0
    t0 = time.perf_counter()
    metrics = ev.validate(cache)
    val_s = time.perf_counter() - t0
    val_launches = nms_ops.greedy_nms_mask.launches
    n_blocks = math.ceil(VAL_N / VAL_B)
    if val_launches != n_blocks:
        fail(f"validation launched the NMS kernel {val_launches} times, want {n_blocks}")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"validation mAP not finite: {metrics}")
    log(f"[validation] {VAL_N} images B={VAL_B}: {val_s:.3f} s ({VAL_N / val_s:.1f} img/s incl. "
        f"host mAP), NMS launches {val_launches} | {card}")
    log("[validation] " + json.dumps(metrics))

    # ------------------------------------------------------- 6 training set-up
    aug = AugParams()  # configs/data/augmentations/aug_params.yaml, mixup 0
    train_info = build_fake_manifest(num_classes=NC, num_images=TRAIN_N, seed=0, zipf_a=1.01)
    t0 = time.perf_counter()
    trainer = Trainer(train_info, info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B,
                      aug_params=aug, max_targets=MAX_TARGETS, seed=0, dtype=torch.bfloat16,
                      device=dev, fused_epoch=False)  # phase 8 is the step loop; phase 12 the fused
    torch.cuda.synchronize()
    pipe = trainer.pipeline
    corpus = pipe.corpus
    log(f"[train] setup: fake corpus {tuple(corpus.shape)} uint8 = {corpus.numel()} B on the "
        f"card, net, pipeline and val cache in {time.perf_counter() - t0:.2f} s; "
        f"{trainer.steps_per_epoch} steps per epoch, warmup {trainer.optimizer.nw} steps")

    # ------------------------------------------- 7 training kernels vs plain
    K = 4 * TRAIN_B
    idx_np = np.random.default_rng(1).integers(0, TRAIN_N, K).astype(np.int32)
    idx_np[:4] = idx_np[4]  # repeated rows
    idx = torch.from_numpy(idx_np).to(dev)
    row_bytes = corpus[0].numel()
    flat = corpus.view(TRAIN_N, 8, row_bytes // 8)
    errs = {}
    errs["gather_rows_planar"] = max(
        check_equal(f"gather_rows_planar {tuple(corpus.shape)}[{K}]",
                    gather_ops.gather_rows_planar(corpus, idx), gather_ops.gather_rows_plain(corpus, idx)),
        check_equal("gather_rows_planar byte path (7,3,13,7)[5]",
                    gather_ops.gather_rows_planar(corpus[:7, :, :13, :7].contiguous(), idx[4:9] % 7),
                    gather_ops.gather_rows_plain(corpus[:7, :, :13, :7].contiguous(), idx[4:9] % 7)))
    bad = idx[:8].clone()
    bad[[1, 5]] = torch.tensor([-1, TRAIN_N], dtype=torch.int32, device=dev)
    want = gather_ops.gather_rows_plain(corpus, torch.where((bad >= 0) & (bad < TRAIN_N), bad, 0))
    want[[1, 5]] = 0
    errs["gather_rows_planar"] = max(errs["gather_rows_planar"], check_equal(
        "gather_rows_planar out-of-range rows come out zero", gather_ops.gather_rows_planar(corpus, bad),
        want))
    # without mosaic a step gathers B rows, not 4B: the first row of that
    # recipe's own plan (phase 9 drives it), sampler and all
    flat_plan = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS,
                                   use_mosaic=False, sampler=RepeatFactorSampler(train_info), seed=0,
                                   device=dev, corpus=pipe.device_corpus)._epoch_plan()[0]
    idx_b = torch.from_numpy(flat_plan[0].astype(np.int32)).to(dev)
    if idx_b.numel() != TRAIN_B:
        fail(f"the no-mosaic plan holds {idx_b.numel()} rows a step, want {TRAIN_B}")
    errs["gather_rows_planar"] = max(errs["gather_rows_planar"], check_equal(
        f"gather_rows_planar {tuple(corpus.shape)}[{TRAIN_B}] (a no-mosaic step's rows)",
        gather_ops.gather_rows_planar(corpus, idx_b), gather_ops.gather_rows_plain(corpus, idx_b)))
    errs["gather_rows_flat"] = check_equal(
        f"gather_rows_flat {tuple(flat.shape)}[{K}]",
        gather_ops.gather_rows_flat(flat, idx), gather_ops.gather_rows_plain(flat, idx))
    timing = {}
    for name, fn, src in (("gather_rows_planar", gather_ops.gather_rows_planar, corpus),
                          ("gather_rows_flat", gather_ops.gather_rows_flat, flat)):
        k_ms, p_ms, turns = in_turns(lambda: fn(src, idx), lambda: gather_ops.gather_rows_plain(src, idx),
                                     30, 10)
        lib_ms = statistics.median([run_ms(lambda: torch.index_select(src, 0, idx.long()), 30)
                                    for _ in range(2)])
        timing[name] = (k_ms, p_ms, lib_ms, *bound(2 * K * row_bytes, 0))
        log(f"[kernels] {name} K={K} rows of {row_bytes} B: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"torch.index_select {lib_ms:.4f} ms, bound {timing[name][3]:.6f} ms ({timing[name][4]}) "
            f"(turns {turns}) | {card}")
        log(f"[kernels] {name}: {2 * K * row_bytes / k_ms / 1e6:.1f} GB/s moved (index_select "
            f"{2 * K * row_bytes / lib_ms / 1e6:.1f}), {timing[name][3] / k_ms:.4f} of the byte bound | {card}")
        call_ms[name] = (cuda_ms(lambda: fn(src, idx), 30),
                         cuda_ms(lambda: torch.index_select(src, 0, idx.long()), 30))
        log(f"[kernels] {name} one call from an idle stream, host launch path included (median of 30): "
            f"kernel {call_ms[name][0]:.4f} ms, torch.index_select {call_ms[name][1]:.4f} ms | {card}")
    log(f"[kernels] gather.cu with 16-byte rows: {resources('gather_rows_kernelI5uint4', 0)}")
    want = gather_ops.gather_rows_plain(corpus, idx)
    for b, blibs in baselines.items():
        fn = blibs["gather"].odcib_gather_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_void_p]
        got = torch.zeros_like(want)
        stream = torch.cuda.current_stream().cuda_stream

        def base_gather():
            check_err(fn(corpus.data_ptr(), idx.data_ptr(), got.data_ptr(), TRAIN_N, K, row_bytes, stream))

        base_gather()
        check_equal(f"baseline {b} gather_rows_planar", got, want)
        k_ms, b_ms, turns = in_turns(lambda: gather_ops.gather_rows_planar(corpus, idx), base_gather, 30, 30)
        log(f"[kernels] gather_rows_planar K={K}, in a row: this checkout {k_ms:.4f} ms, baseline {b} "
            f"{b_ms:.4f} ms (turns {turns}) | {card}")
    del want

    # a real step's warp and HSV inputs, drawn from a generator of their own
    gen = torch.Generator(device=dev).manual_seed(7)
    draws = draw_augment(gen, TRAIN_B, TRAIN_S, aug)
    sample = pipe.gather(torch.from_numpy(pipe._epoch_plan()[0][0].astype(np.int32)).to(dev))
    G = TRAIN_B
    placement = aug_ops._mosaic_placement(sample.sizes.reshape(G, 4, 2), draws.centers, TRAIN_S)
    M = aug_ops._affine_matrices(draws.values, 2 * TRAIN_S, 2 * TRAIN_S, TRAIN_S, TRAIN_S)
    taps = aug_ops.mosaic_warp_taps(M, placement, TRAIN_S, draws.flip)
    imgs = sample.images.reshape(G, 4, 3, TRAIN_S, TRAIN_S)

    def rand_taps(G_, S_, seed):
        gt = torch.Generator(device=dev).manual_seed(seed)
        out = [torch.randint(0, 256, (G_, 4, 3, S_, S_), generator=gt, device=dev, dtype=torch.uint8)]
        for _ in range(2):
            j0 = torch.randint(-3, S_ + 1, (G_, 4, S_), generator=gt, device=dev, dtype=torch.int32)
            w = [torch.rand(G_, 4, S_, generator=gt, device=dev) for _ in range(2)]
            w = [torch.where(torch.rand(G_, 4, S_, generator=gt, device=dev) < 0.2, 0.0, x) for x in w]
            out += [j0, *w]
        return out

    dead = [t.clone() for t in taps]
    for t in dead[1:3] + dead[4:6]:
        t[:, 2] = 0.0  # quadrant 2 wholly outside its window: every weight zero
    warp_cases = {
        f"real draw {tuple(imgs.shape)}": (imgs, *taps),
        "random windowed taps G=16 S=416": tuple(rand_taps(16, 416, 1)),
        "random windowed taps G=16 S=640": tuple(rand_taps(16, 640, 2)),
        "real draw, quadrant 2 outside its window": (imgs, *dead),
    }
    errs["warp_quadrants"] = 0.0
    for name, args in warp_cases.items():
        for od in (torch.bfloat16, torch.float32):
            errs["warp_quadrants"] = max(errs["warp_quadrants"], check_equal(
                f"warp_quadrants {name} -> {od}", warp_ops.warp_quadrants(*args, out_dtype=od),
                warp_ops.warp_quadrants_plain(*args, out_dtype=od)))
    warped = warp_ops.warp_quadrants(imgs, *taps, out_dtype=torch.bfloat16)
    k_ms, p_ms, turns = in_turns(lambda: warp_ops.warp_quadrants(imgs, *taps, out_dtype=torch.bfloat16),
                                 lambda: warp_ops.warp_quadrants_plain(imgs, *taps, out_dtype=torch.bfloat16),
                                 30, 5)
    jx0, wx0, wx1, jy0, wy0, wy1 = taps
    src_bytes = float((used_lines(jy0, wy0, wy1, TRAIN_S) * used_lines(jx0, wx0, wx1, TRAIN_S)).sum() * 3)
    tap_bytes = sum(t.numel() * t.element_size() for t in taps)
    out_bytes = warped.numel() * warped.element_size()
    live_rows = float(((wy0 != 0) | (wy1 != 0)).sum())
    warp_ops_n = live_rows * TRAIN_S * 3 * WARP_OPS_PER_TAP_ROW + warped.numel() * 2
    timing["warp_quadrants"] = (k_ms, p_ms, None, *bound(src_bytes + tap_bytes + out_bytes, warp_ops_n))
    log(f"[kernels] warp_quadrants G={G} S={TRAIN_S} bf16 out: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
        f"(turns {turns}); bytes needed: source {src_bytes:.0f} (of {imgs.numel()} held) + taps "
        f"{tap_bytes} + out {out_bytes}; ops {warp_ops_n:.0f} (live quadrant rows {live_rows:.0f} of "
        f"{wy0.numel()}) -> bound {timing['warp_quadrants'][3]:.6f} ms ({timing['warp_quadrants'][4]}) | {card}")
    log(f"[kernels] warp_quadrants: {(src_bytes + tap_bytes + out_bytes) / k_ms / 1e6:.1f} GB/s of needed "
        f"bytes, {timing['warp_quadrants'][3] / k_ms:.4f} of the bound | {card}")
    call_ms["warp_quadrants"] = (
        cuda_ms(lambda: warp_ops.warp_quadrants(imgs, *taps, out_dtype=torch.bfloat16), 30), None)
    log(f"[kernels] warp_quadrants one call from an idle stream, host launch path included (median of "
        f"30): {call_ms['warp_quadrants'][0]:.4f} ms | {card}")
    for b, blibs in baselines.items():
        fn = blibs["warp"].odcib_warp_quadrants_bf16
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        got = torch.zeros_like(warped)
        ptrs = [imgs.data_ptr(), *(t.data_ptr() for t in taps), got.data_ptr()]
        stream = torch.cuda.current_stream().cuda_stream

        def base_warp():
            check_err(fn(*ptrs, G, TRAIN_S, TRAIN_S, stream))

        base_warp()
        check_equal(f"baseline {b} warp_quadrants", got, warped)
        k_ms, b_ms, turns = in_turns(lambda: warp_ops.warp_quadrants(imgs, *taps, out_dtype=torch.bfloat16),
                                     base_warp, 30, 30)
        log(f"[kernels] warp_quadrants G={G} S={TRAIN_S}, in a row: this checkout {k_ms:.4f} ms, baseline "
            f"{b} {b_ms:.4f} ms (turns {turns}) | {card}")
    log(f"[kernels] warp.cu at S=So={TRAIN_S}: "
        f"{resources('warp_quadrants_kernel', warp_ops.smem_bytes(TRAIN_S, TRAIN_S))}")

    gh = torch.Generator(device=dev).manual_seed(3)
    extreme = torch.tensor([[0.985, 0.3, 0.6], [1.015, 1.7, 1.4], [1.0, 1.0, 1.0], [0.99, 1.69, 0.61]],
                           device=dev).repeat(G // 4, 1)
    hsv_cases = {
        "real warp output bf16": (warped, draws.hsv_r),
        "real warp output f32": (warped.float(), draws.hsv_r),
        "integral bf16, extreme gains": (torch.randint(0, 256, warped.shape, generator=gh, device=dev)
                                         .to(torch.bfloat16), extreme),
        "non-integral f32, extreme gains": (torch.rand(warped.shape, generator=gh, device=dev) * 255.0,
                                            extreme),
    }
    # every (v, diff) pair twice over: entries 0, 1 and 255 of both tables
    vv, dd = torch.meshgrid(torch.arange(256), torch.arange(256), indexing="ij")
    vv, dd = vv.flatten()[None], torch.minimum(vv, dd).flatten()[None]
    lut = torch.stack([torch.cat([vv, vv - dd], 1), torch.cat([vv - dd, vv], 1),
                       torch.cat([vv - dd // 2, vv - dd], 1)], 1).view(1, 3, 256, 512)
    odd = torch.randint(0, 256, (5, 3, 13, 7), generator=gh, device=dev)
    buf = torch.randint(0, 256, (4 * 3 * 16 * 64 + 1,), generator=gh, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        off = buf.to(dt)[1:].view(4, 3, 16, 64)  # 2 or 4 bytes past a 16-byte boundary
        if off.data_ptr() % 16 == 0:
            fail("the offset view is 16-byte aligned: the case tests nothing")
        hsv_cases.update({
            f"every (v, diff) pair {dt}": (lut.to(dev, dt), extreme[1:2]),
            f"plane of 91, not a multiple of 8, {dt}": (odd.to(dt), extreme[:5]),
            f"base {off.data_ptr() % 16} bytes off 16-byte alignment {dt}": (off, extreme[:4]),
        })
    errs["hsv_planar"] = 0.0
    for name, (x, r) in hsv_cases.items():
        errs["hsv_planar"] = max(errs["hsv_planar"], check_equal(
            f"hsv_planar {name} {tuple(x.shape)}", hsv_ops.hsv_planar(x, r), hsv_ops.hsv_planar_plain(x, r)))
    k_ms, p_ms, turns = in_turns(lambda: hsv_ops.hsv_planar(warped, draws.hsv_r),
                                 lambda: hsv_ops.hsv_planar_plain(warped, draws.hsv_r), 30, 5)
    n_pos = warped.numel() // 3
    timing["hsv_planar"] = (k_ms, p_ms, None,
                            *bound(2 * warped.numel() * warped.element_size() + draws.hsv_r.numel() * 4,
                                   n_pos * HSV_OPS_PER_PIXEL))
    log(f"[kernels] hsv_planar {tuple(warped.shape)} bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
        f"(turns {turns}), bound {timing['hsv_planar'][3]:.6f} ms ({timing['hsv_planar'][4]}) | {card}")
    call_ms["hsv_planar"] = (cuda_ms(lambda: hsv_ops.hsv_planar(warped, draws.hsv_r), 30), None)
    log(f"[kernels] hsv_planar one call from an idle stream, host launch path included (median of 30): "
        f"{call_ms['hsv_planar'][0]:.4f} ms | {card}")
    hsv_bytes = 2 * warped.numel() * warped.element_size()
    log(f"[kernels] hsv_planar: {hsv_bytes / k_ms / 1e6:.1f} GB/s moved, "
        f"{timing['hsv_planar'][3] / k_ms:.4f} of the bound | {card}")
    log(f"[kernels] hsv.cu: {resources('hsv_planar_kernel', 0)}")
    hsv_want = hsv_ops.hsv_planar(warped, draws.hsv_r)
    for b, blibs in baselines.items():
        fn = blibs["hsv"].odcib_hsv_planar_bf16
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        got = torch.zeros_like(warped)
        stream = torch.cuda.current_stream().cuda_stream

        def base_hsv():
            check_err(fn(warped.data_ptr(), draws.hsv_r.data_ptr(), got.data_ptr(), G,
                         TRAIN_S * TRAIN_S, stream))

        base_hsv()
        check_equal(f"baseline {b} hsv_planar", got, hsv_want)
        k_ms, b_ms, turns = in_turns(lambda: hsv_ops.hsv_planar(warped, draws.hsv_r), base_hsv, 30, 30)
        log(f"[kernels] hsv_planar {tuple(warped.shape)} bf16, in a row: this checkout {k_ms:.4f} ms, "
            f"baseline {b} {b_ms:.4f} ms (turns {turns}) | {card}")
    timing["greedy_nms_mask"] = (nms_ms, plain_ms, None, bound_ms, bound_by)
    errs["greedy_nms_mask"] = max_err

    # ------------------------------------------------------------- 8 training
    net = trainer.net
    before = [p.detach().clone() for p in net.parameters()]
    marks = {}

    def on_step(epoch, i, m):
        if i in (TRAIN_STEPS - TIMED_STEPS - 1, TRAIN_STEPS - 1):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()

    counted = _kernel_entries()
    _zero_kernels()
    t0 = time.perf_counter()
    train_map = trainer.fit(max_epochs=1, epoch_steps=TRAIN_STEPS, on_step=on_step)
    fit_s = time.perf_counter() - t0
    train_launches = _read_kernels()
    log(f"[train] fit(max_epochs=1, epoch_steps={TRAIN_STEPS}) incl. validation: {fit_s:.2f} s; "
        f"launches {train_launches}")
    for name in ("gather_rows_planar", "hsv_planar", "warp_quadrants"):
        if train_launches[name] != TRAIN_STEPS:
            fail(f"training launched {name} {train_launches[name]} times in {TRAIN_STEPS} steps")
    if train_launches["greedy_nms_mask"] != n_blocks:
        fail(f"epoch-end validation launched NMS {train_launches['greedy_nms_mask']} times, want {n_blocks}")
    em = trainer.epoch_metrics[-1]
    if not all(np.isfinite(v).all() for v in em.values()):
        fail(f"training losses not finite: {em}")
    if pipe._overflow_pending:
        fail(f"fit left {len(pipe._overflow_pending)} overflow counts pending on the pipeline")
    unmoved = sum(torch.equal(a, b) for a, b in zip(before, net.parameters()))
    if unmoved:
        fail(f"{unmoved} of {len(before)} parameters did not move in {TRAIN_STEPS} steps")
    if not all(math.isfinite(v) for v in train_map.values()):
        fail(f"epoch-end mAP not finite: {train_map}")
    t_lo, t_hi = marks[TRAIN_STEPS - TIMED_STEPS - 1], marks[TRAIN_STEPS - 1]
    train_ips = TIMED_STEPS * TRAIN_B / (t_hi - t_lo)
    log(f"[train] yolov5s nc={NC} {TRAIN_S}x{TRAIN_S} B={TRAIN_B} bf16: {TIMED_STEPS} steps "
        f"(steps {TRAIN_STEPS - TIMED_STEPS + 1}-{TRAIN_STEPS}) in {t_hi - t_lo:.4f} s = {train_ips:.2f} img/s; "
        f"epoch wall {trainer.epoch_walls[-1]:.3f} s for {trainer.epoch_imgs[-1]} images | {card}")
    log("[train] per step: " + ", ".join(f"{k} {em[k][0]:.4g}->{em[k][-1]:.4g}"
                                         for k in ("total", "box", "obj", "cls", "lr"))
        + f"; all {len(before)} parameters moved; assign_drop total {em['assign_drop'].sum():.0f}; "
        f"targets dropped by max_targets {int(em['targets_dropped'])} (pipeline total "
        f"{pipe.overflow_total}, none pending)")
    log("[train] epoch-end validation " + json.dumps(train_map))

    plan_idx = torch.from_numpy(pipe._epoch_plan()[0][1].astype(np.int32)).to(dev)
    fixed = pipe.gather(plan_idx)
    batch, _ = pipe.augment_fn(fixed, draws)
    stage = {
        "gather (K2 + sizes/targets)": cuda_ms(lambda: pipe.gather(plan_idx), 10),
        "augment (K5, K4, boxes, to_batch)": cuda_ms(lambda: pipe.augment_fn(fixed, draws), 10),
        "draws": cuda_ms(lambda: draw_augment(gen, TRAIN_B, TRAIN_S, aug), 10),
        "forward+assign+loss+backward+SGD": cuda_ms(lambda: trainer.train_step(batch), 10),
        "whole step": cuda_ms(lambda: trainer.train_step(pipe.gather_augment(
            plan_idx, draw_augment(gen, TRAIN_B, TRAIN_S, aug))[0]), 10),
    }
    log("[train] ms per stage (CUDA events, median of 10): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage.items()) + f" | {card}")
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(pipe.gather_augment(plan_idx, draw_augment(gen, TRAIN_B, TRAIN_S, aug))[0])
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    log(f"[train] host enqueue of one whole step (median of 5): {statistics.median(enqueue):.4f} ms "
        f"(runs {[round(t, 4) for t in enqueue]}) | {card}")

    # device busy time per step and kernels launched per step, from a trace
    # of 3 whole steps; the idle share compares that busy time with the
    # untraced pipelined step time of the fit above
    from torch.profiler import ProfilerActivity, profile

    n_prof = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            trainer.train_step(pipe.gather_augment(plan_idx, draw_augment(gen, TRAIN_B, TRAIN_S, aug))[0])
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, "self_device_time_total", 0) for e in dev_events) / 1e3 / n_prof
    launches_per_step = sum(e.count for e in dev_events) / n_prof
    step_ms = (t_hi - t_lo) / TIMED_STEPS * 1e3
    if busy_ms > 0:
        log(f"[train] profiler: device busy {busy_ms:.4f} ms per step, {launches_per_step:.0f} kernels per "
            f"step; pipelined step {step_ms:.4f} ms -> device idle share {1 - busy_ms / step_ms:.4f} | {card}")
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]
        log("[train] top kernels by device time per step (ms): " + "; ".join(
            f"{e.key[:60]} x{e.count // n_prof} {e.self_device_time_total / 1e3 / n_prof:.3f}" for e in top))
    else:
        log("[train] profiler: no device time in the trace; idle share not measured")

    # two f32 yolov5n steps at 64 px from the same weights and draws, CPU vs card
    small_info = build_fake_manifest(num_classes=3, num_images=16, image_size=64, seed=0)
    g_cpu = torch.Generator().manual_seed(5)
    small_draws = [draw_augment(g_cpu, 4, 64, aug) for _ in range(2)]

    def small_run(device):
        snet = build_network(3, "n", device=device, seed=1)
        spipe = DeviceDataPipeline(small_info, 64, 4, aug, max_targets=20, seed=0,
                                   feed_dtype=torch.float32, device=device)
        sstep = make_train_step(snet, anchors, FeatureShape(64, 64),
                                SmartSGD(snet, OptimizerConfig(max_epochs=10), 4))
        plan, _ = spipe._epoch_plan()
        losses = []
        for i in range(2):
            b, _ = spipe.gather_augment(torch.from_numpy(plan[i].astype(np.int32)).to(device),
                                        small_draws[i].to(device))
            losses.append(float(sstep(b).total))
        return losses

    l_cpu, l_gpu = small_run(torch.device("cpu")), small_run(dev)
    if not all(abs(a - b) <= 1e-3 * abs(a) for a, b in zip(l_cpu, l_gpu)):
        fail(f"small f32 train steps: CPU losses {l_cpu} vs card {l_gpu} beyond 1e-3 relative")
    log(f"[train] small f32 check: yolov5n@64 B=4, 2 steps, loss CPU {l_cpu} vs card {l_gpu} "
        f"(within 1e-3 relative)")

    # -------------------------------------------------------------- 9 recipes
    shared = pipe.device_corpus
    T4 = 4 * pipe.src_T  # target slots of one mosaic group
    torch.cuda.reset_peak_memory_stats()

    zero_counts, read_counts = _zero_kernels, _read_kernels

    def run_recipe(name, steps, want, **kw):
        """``steps`` train steps of one recipe; launches counted over all of
        them, img/s over all but the first. No value is read on the host
        inside a step; the one synchronisation marks the end of the warm-up."""
        tr = Trainer(train_info, info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B,
                     aug_params=kw.pop("aug_params", aug), max_targets=MAX_TARGETS, seed=0,
                     dtype=torch.bfloat16, device=dev, corpus=shared, **kw)
        rp = tr.pipeline
        if rp.corpus.data_ptr() != corpus.data_ptr():
            fail(f"{name}: the recipe did not share phase 6's corpus")
        totals, rows_valid = [], []
        zero_counts()
        for i, (batch, _) in enumerate(rp.epoch(steps)):
            totals.append(tr.train_step(batch).total)
            rows_valid.append(batch.mask.sum(1))
            if i == 0:
                torch.cuda.synchronize()
                t_first = time.perf_counter()
        torch.cuda.synchronize()
        t_last = time.perf_counter()
        got = read_counts()
        ips = (steps - 1) * TRAIN_B / (t_last - t_first)
        for k, n in want.items():
            if got[k] != n:
                fail(f"{name}: {k} launched {got[k]} times in {steps} steps, want {n}")
        losses = torch.stack(totals).tolist()
        if not all(math.isfinite(v) for v in losses):
            fail(f"{name}: losses not finite: {losses}")
        # the stages of one step, on fixed rows and draws
        groups, secs = rp._epoch_plan()
        rp.consumed_plan_log.pop()  # a plan drawn for timing only: not an epoch trained
        idx = torch.from_numpy(groups[0].astype(np.int32)).to(dev)
        idx2 = torch.from_numpy(secs[0].astype(np.int32)).to(dev) if secs.size else None
        draws_r = rp.draw()
        fixed = rp.gather(idx)
        fixed2 = rp.gather(idx2) if idx2 is not None else None
        aug_ms = cuda_ms(lambda: rp.augment_fn(fixed, draws_r, fixed2), 10)
        enq = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(rp.gather_augment(idx, rp.draw(), idx2)[0])
            enq.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        log(f"[recipes] {name}: {steps} steps, losses {losses[0]:.4f}->{losses[-1]:.4f}, launches {got}; "
            f"{(steps - 1) * TRAIN_B} images (steps 2-{steps}) in {t_last - t_first:.4f} s = {ips:.2f} img/s; "
            f"augment stage {aug_ms:.4f} ms (CUDA events, median of 10); K2 rows per launch {idx.numel()}; "
            f"host enqueue of one whole step (median of 5) {statistics.median(enq):.4f} ms | {card}")
        return tr, torch.stack(rows_valid), (fixed, draws_r)

    def spread(counts):
        """Largest over smallest per-class instance count."""
        return max(counts.values()) / max(min(counts.values()), 1)

    # class-aware sampling + mixup
    n2 = 2 * RECIPE_STEPS
    tr, rows_valid, _ = run_recipe(
        "class-aware + mixup 0.5", RECIPE_STEPS,
        {"gather_rows_planar": n2, "hsv_planar": n2, "warp_quadrants": n2},
        sampler=ClassAwareSampler(train_info, seed=0), mixup_prob=0.5)
    plain_pipe = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS,
                                    mixup_prob=0.5, seed=0, device=dev, corpus=shared)
    # the per-image coins of those steps, drawn again by a pipeline of the
    # same seed; the run's batches must bear them out: a row whose coin is
    # false holds no more than one group's targets
    coins = torch.stack([plain_pipe.draw().mix_do for _ in range(RECIPE_STEPS)])
    n_true, n_all = int(coins.sum()), coins.numel()
    if not 0 < n_true < n_all:
        fail(f"mixup coin true for {n_true} of {n_all} images: want some of each")
    most = int(rows_valid.max())
    if most <= T4:
        fail(f"no batch row holds more than one group's {T4} target slots (most {most})")
    unmixed = int(torch.where(coins, 0, rows_valid).max())
    if unmixed > T4:
        fail(f"a row whose mixup coin is false holds {unmixed} targets, more than one group's {T4}")
    stats = tr.sampler_stats(RECIPE_STEPS)
    plain_stats = plan_instance_counts(train_info, np.concatenate(plain_pipe._epoch_plan(), 1)[:RECIPE_STEPS])
    log(f"[recipes] class-aware + mixup: coin true for {n_true} of {n_all} images; most valid targets in "
        f"a row {most} (one group holds {T4}); instances per class over {RECIPE_STEPS} steps: "
        f"class-aware {stats} (largest/smallest {spread(stats):.3f}), no sampler {plain_stats} "
        f"({spread(plain_stats):.3f}), corpus {train_info.get_instance_count()}")
    if sum(stats.values()) <= 0 or spread(stats) >= spread(plain_stats):
        fail("class-aware sampling is not flatter than no sampler over the same steps")
    del tr, plain_pipe

    # repeat-factor sampling, no mosaic
    tr, _, (fixed, _) = run_recipe(
        "repeat-factor, no mosaic", RECIPE_STEPS,
        {"gather_rows_planar": RECIPE_STEPS, "hsv_planar": RECIPE_STEPS, "warp_quadrants": 0},
        sampler=RepeatFactorSampler(train_info), use_mosaic=False)
    if fixed.images.shape[0] != TRAIN_B:
        fail(f"no-mosaic step gathered {fixed.images.shape[0]} rows, want {TRAIN_B}")
    log(f"[recipes] repeat-factor, no mosaic: instances per class over {RECIPE_STEPS} steps "
        f"{tr.sampler_stats(RECIPE_STEPS)}")
    del tr, fixed

    # a rotating, shearing, perspective affine on the mosaic canvas
    general = aug._replace(affine_params=aug.affine_params._replace(degrees=10.0, shear=2.0,
                                                                     perspective=0.0005))
    tr, _, (fixed, draws_r) = run_recipe(
        "general affine (degrees 10, shear 2, perspective 0.0005)", AFFINE_STEPS,
        {"gather_rows_planar": AFFINE_STEPS, "hsv_planar": AFFINE_STEPS, "warp_quadrants": 0},
        aug_params=general)
    staged = augment_group(fixed, draws_r, TRAIN_S, general).images
    lo, hi = float(staged.min()), float(staged.max())
    if staged.dtype != torch.float32 or not torch.equal(staged, staged.round()) or lo < 0 or hi > 255:
        fail(f"general affine: pixels before normalize are not integers in [0, 255] ({lo}..{hi})")
    log(f"[recipes] general affine: pixels before normalize {tuple(staged.shape)} {staged.dtype}, "
        f"integers in [{lo:.0f}, {hi:.0f}]")
    del tr, fixed, staged

    # the exact warp beside the fast one: same rows, same draws
    def warp_pipe(hsv, precision):
        a = aug if hsv else aug._replace(hsv_params=HSVParams.no_aug())
        return DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, a, max_targets=MAX_TARGETS, seed=0,
                                  warp_precision=precision, feed_dtype=torch.float32, device=dev,
                                  corpus=shared)

    for hsv in (False, True):
        fast_p, exact_p = warp_pipe(hsv, "fast"), warp_pipe(hsv, "exact")
        d = fast_p.draw()
        zero_counts()
        fb, _ = fast_p.gather_augment(plan_idx, d)
        n_fast = read_counts()["warp_quadrants"]
        eb, _ = exact_p.gather_augment(plan_idx, d)
        n_exact = read_counts()["warp_quadrants"] - n_fast
        diff = (fb.images - eb.images).abs() * 255.0
        worst, within1 = float(diff.max()), float((diff <= 1.0 + 1e-3).float().mean())
        ex_ms = cuda_ms(lambda: exact_p.gather_augment(plan_idx, d), 5)
        fa_ms = cuda_ms(lambda: fast_p.gather_augment(plan_idx, d), 5)
        log(f"[recipes] exact vs fast warp, HSV {'on' if hsv else 'off'}: max pixel difference "
            f"{worst:.4f}/255, {within1:.6f} of pixels within 1/255; K5 launches fast {n_fast} exact "
            f"{n_exact}; gather+augment exact {ex_ms:.4f} ms, fast {fa_ms:.4f} ms | {card}")
        if n_fast != 1 or n_exact != 0:
            fail(f"warp launches: fast {n_fast} (want 1), exact {n_exact} (want 0)")
        if not (torch.equal(fb.boxes, eb.boxes) and torch.equal(fb.labels, eb.labels)
                and torch.equal(fb.mask, eb.mask)):
            fail("exact and fast warp disagree on boxes, labels or mask")
        if not hsv and (worst > 4.0 + 1e-3 or within1 < 0.99):
            fail(f"exact vs fast warp outside the contract: max {worst}/255, {within1} within 1/255")
    del fast_p, exact_p, fb, eb
    log(f"[recipes] torch.cuda.max_memory_allocated over the recipes: "
        f"{torch.cuda.max_memory_allocated()} B | {card}")

    # one composed-path step and one mixup step at 64 px, CPU against card
    for name, kw in (("composed path (general affine)", dict(affine=True)),
                     ("mixup 0.5", dict(mixup_prob=0.5))):
        for hsv in (False, True):
            a = general if kw.get("affine") else aug
            if not hsv:
                a = a._replace(hsv_params=HSVParams.no_aug())
            pkw = {k: v for k, v in kw.items() if k != "affine"}
            pair = [DeviceDataPipeline(small_info, 64, 4, a, max_targets=40, seed=0,
                                       feed_dtype=torch.float32, device=d, **pkw)
                    for d in ("cpu", dev)]
            groups, secs = pair[0]._epoch_plan()
            d_cpu = pair[0].draw()
            outs = []
            for sp in pair:
                i1 = torch.from_numpy(groups[0].astype(np.int32)).to(sp.device)
                i2 = torch.from_numpy(secs[0].astype(np.int32)).to(sp.device) if secs.size else None
                outs.append(sp.gather_augment(i1, d_cpu.to(sp.device), i2)[0])
            diff = (outs[0].images - outs[1].images.cpu()).abs() * 255.0
            worst, share = float(diff.max()), float((diff > 1e-3).float().mean())
            box_err = float((outs[0].boxes - outs[1].boxes.cpu()).abs().max())
            log(f"[recipes] CPU vs card, {name}, 64 px B=4 f32, HSV {'on' if hsv else 'off'}: max pixel "
                f"difference {worst:.4f}/255 on {share:.6f} of pixels, boxes {box_err:.2e}")
            # HSV multiplies a one-unit warp difference, so with HSV on the
            # limit is 9 units; either way on at most 0.1% of pixels (0.2%
            # where two groups are blended)
            limit = 9.0 if hsv else 1.0
            if worst > limit + 1e-3 or share >= 0.001 * (2 if pkw else 1) or box_err > 1e-4:
                fail(f"CPU vs card, {name}: pixels {worst}/255 on {share}, boxes {box_err}")
            if not (torch.equal(outs[0].labels, outs[1].labels.cpu())
                    and torch.equal(outs[0].mask, outs[1].mask.cpu())):
                fail(f"CPU vs card, {name}: labels or mask differ")

    # ---------------------------------------------------------------- 10 jpeg
    jpeg = phase_jpeg(card, dev, aug, counted, zero_counts, read_counts)

    # ----------------------------------------------------------------- 11 cli
    cli = phase_cli(card, counted, zero_counts, read_counts)

    # --------------------------------------------------------------- 12 fused
    fused = phase_fused(card, dev, aug, train_info, info, shared, zero_counts, read_counts)
    torch.cuda.empty_cache()  # the ranks of phase 13 are other processes on this card

    # ----------------------------------------------------------------- 13 ddp
    ddp = phase_ddp(card)

    # -------------------------------------------------------------- 14 report
    src = "object_detection_cib_torch/ops/csrc/"
    rows = [
        ("greedy_nms_mask", "nms.cu", "object_detection_cib_tpu/ops/pallas_nms.py:131", serve_launches),
        ("gather_rows_planar", "gather.cu", "object_detection_cib_tpu/ops/pallas_gather.py:98",
         train_launches["gather_rows_planar"]),
        ("gather_rows_flat", "gather.cu", "object_detection_cib_tpu/ops/pallas_gather.py:62",
         train_launches["gather_rows_flat"]),
        ("hsv_planar", "hsv.cu", "object_detection_cib_tpu/ops/pallas_hsv.py:132",
         train_launches["hsv_planar"]),
        ("warp_quadrants", "warp.cu", "object_detection_cib_tpu/ops/pallas_warp.py:208",
         train_launches["warp_quadrants"]),
    ]
    kernels = []
    for name, file, replaces, launches in rows:
        k_ms, p_ms, lib_ms, b_ms, b_by = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + file, "replaces": replaces,
            "launches": launches, "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "call_ms": call_ms[name][0], "library_call_ms": call_ms[name][1],
            "launches_by_path": {"serving": serve_launches if name == "greedy_nms_mask" else 0,
                                 "validation": val_launches if name == "greedy_nms_mask" else 0,
                                 "train": train_launches[name],
                                 **{f"jpeg_{part}": n[name] for part, n in jpeg.items()},
                                 "cli": {part: n[name] for part, n in cli.items()},
                                 "fused": fused[name],
                                 "ddp": {part: n[name] for part, n in ddp.items()}},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
