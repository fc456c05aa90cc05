#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. device: require CUDA, print the card's name and power limit
   (``nvidia-smi``), set and print the TF32 switches;
2. build: compile every kernel of the path from ``object_detection_cib_torch``
   (``nvcc``, printed as set-up time, with ptxas' register report);
3. kernels: hold each kernel BITWISE against its plain PyTorch version on
   the card (greedy-NMS keep mask: the chain case, K=256 random, K=2048 with
   900 live, a ragged K=1000, and the batch of 32 at K=2048 from a real
   yolov5s output), then time kernel and plain version in turns with CUDA
   events (median of repeats) and compute the kernel's bound from this
   run's inputs. Greedy NMS has no single PyTorch call (there is no
   torchvision here), so there is no library yardstick: ``library_ms`` is
   null;
4. serving: yolov5s, nc=10, 640x640, batch 32, bf16, channels_last, random
   weights from a seed, through ``make_eval_step`` (forward -> decode -> NMS
   at conf 0.001 / IoU 0.6 / max_nms 2048 / max_det 300) for 200 steps;
   launch counts are zeroed just before and read just after; img/s over the
   200 steps, the host's time to enqueue one step, and ms per stage; a small
   f32 input checked against the CPU run of the same port;
5. validation: a fake 320-image val set at 416 (``build_fake_manifest``,
   coco-zipf top-10 shape), ``ValDeviceCache`` on the card, batch 64,
   ``Evaluator.validate``; the mAP dict must be finite;
6. the ``kernels`` JSON line, the card line, and the result line last.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
NMS_OPS_PER_PAIR = 14  # 4 min/max, 2 sub, 2 clamp, 1 mul, 2 add/sub, +eps, div, cmp

SERVE_B, SERVE_S, NC = 32, 640, 10
SERVE_STEPS = 200  # a window of seconds, so host jitter averages out of img/s
VAL_B, VAL_S, VAL_N = 64, 416, 320
CONF, IOU, MAX_NMS, MAX_DET = 0.001, 0.6, 2048, 300


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


def nms_pairs_needed(keep, live) -> int:
    """Pair tests any exact greedy NMS must make on these inputs.

    A kept box must be tested against every kept box before it; a suppressed
    live box needs at least one test (against the box that suppresses it).
    """
    k = keep.to(torch.int64)
    kept_before = k.cumsum(dim=1) - k
    pairs = (kept_before * k).sum() + (live & ~keep).sum()
    return int(pairs)


def main() -> None:
    # ---------------------------------------------------------------- 1 device
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    root = Path(__file__).resolve().parent
    if not (root / "object_detection_cib_torch").is_dir():
        fail(f"object_detection_cib_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(root))

    from object_detection_cib_torch.core.nms import non_max_suppression, select_candidates
    from object_detection_cib_torch.core.types import default_anchors
    from object_detection_cib_torch.data.synthetic import build_fake_manifest
    from object_detection_cib_torch.data.val_cache import ValDeviceCache
    from object_detection_cib_torch.eval.decode import decode_predictions
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.ops import nms as nms_ops
    from object_detection_cib_torch.train.steps import make_eval_step
    from object_detection_cib_torch.train.trainer import Evaluator

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
    lib = nms_ops.build(verbose=True)
    log(f"[build] setup: nvcc {lib.name} in {time.perf_counter() - t0:.2f} s")

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

    cases = {
        "chain K=256": (chain.to(dev), chain_live.to(dev), 0.45),
        "random K=256": (*rand_case(256, 200, 0, 200, (10, 80)), 0.45),
        "random K=2048 900 live": (*rand_case(2048, 900, 5, 400, (10, 90)), 0.5),
        "random K=1000 ragged": (*rand_case(1000, 700, 6, 300, (10, 80)), 0.45),
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

    boxes, live, thr = cases["yolov5s@640 B=32 K=2048"]
    keep = nms_ops.greedy_nms_mask(boxes, live, thr)
    kernel = lambda: nms_ops.greedy_nms_mask(boxes, live, thr)  # noqa: E731
    plain = lambda: nms_ops.greedy_nms_mask_plain(boxes, live, thr)  # noqa: E731
    for _ in range(3):
        kernel()
    plain()
    turns = {"plain": [], "kernel": []}
    for who in ("plain", "kernel", "kernel", "plain"):
        turns[who].append(cuda_ms(kernel if who == "kernel" else plain, 30 if who == "kernel" else 5))
    nms_ms, plain_ms = statistics.median(turns["kernel"]), statistics.median(turns["plain"])
    B, K = live.shape
    nms_bytes = B * K * (16 + 1 + 1)  # boxes f32x4 + live u8 in, keep u8 out
    pairs = nms_pairs_needed(keep, live)
    t_bytes = nms_bytes / H100_BYTES_PER_S * 1e3
    t_ops = pairs * NMS_OPS_PER_PAIR / H100_F32_FLOP_PER_S * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log(f"[kernels] greedy_nms_mask B={B} K={K}: kernel {nms_ms:.4f} ms (turns {turns['kernel']}), "
        f"plain {plain_ms:.4f} ms (turns {turns['plain']}) | {card}")
    log(f"[kernels] bound: {nms_bytes} B / 3.35 TB/s = {t_bytes:.6f} ms; {pairs} pair tests x "
        f"{NMS_OPS_PER_PAIR} ops / 67 TFLOP/s = {t_ops:.6f} ms -> {bound_ms:.6f} ms ({bound_by})")

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
    ev = Evaluator(net, anchors, info.classes, batch_size=VAL_B)
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

    # --------------------------------------------------------------- 6 report
    kernels = [{
        "name": "greedy_nms_mask",
        "route": "cuda",
        "source": "object_detection_cib_torch/ops/csrc/nms.cu",
        "replaces": "object_detection_cib_tpu/ops/pallas_nms.py:131",
        "launches": serve_launches,
        "max_abs_err": max_err,
        "ms": nms_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
