"""An inference cell: one client, one request in flight (a closed loop).

A request is a batch of uint8 images from the seed's pool in pinned host
memory. It is copied up (``infer.upload``), run through the program's
``Evaluator.eval_step`` (forward, decode, candidate selection, K1 NMS;
``infer.enqueue``, the host's time in the call), and its ``NMSResult`` is
copied back and waited for (``infer.fetch``), as ``predict_batches`` does.
A request's latency runs from its upload to its detections as numpy.

Set-up makes the pool and the weights on the card, sets the weights'
BatchNorm statistics from the float32 reference on one batch (so random
weights give informative detections), builds the program's network and
``Evaluator``, and runs a few requests (cuDNN's first calls). The window
sends requests until ``--seconds`` have passed; ``infer_img_s`` is the
images of all its requests over its wall time, ``infer_p95_ms`` the 95th
percentile of all their latencies.

``correct`` judges a sample of the window's requests, drawn from the seed,
and its last, against the float32 reference once the window has closed.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Callable, Optional

import numpy as np
import torch

from harness import faults, inputs, judge, registry, tracing
from reference import plain_math
from reference.detect import nms

WARMUP_REQUESTS = 3
FAULTS = faults.INFER  # what ``calibrate.py`` plants under this window


def build(cell: dict, seed: int, device):
    """-> (the program's Evaluator, the pool as (batches, B, S, S, 3), the weights)."""
    from object_detection_cib_torch.train.trainer import Evaluator

    cfg = cell["model"]
    net_family = registry.family(cfg)
    S, B = cell["image_size"], cell["batch"]
    nc = cfg["nc"]
    pool = inputs.pool(seed, cell["pool_images"], S, device)
    calib = pool[:B].to(device).float() / 255.0
    state = net_family.calibrated(cfg, net_family.weights(seed, cfg, device), calib)
    net, anchors = net_family.eval_network(cfg, device)
    net.load_state_dict(state)
    ev = Evaluator(net, anchors, [f"class_{i}" for i in range(nc)], batch_size=B,
                   conf_thres=cell["conf"], iou_thres=cell["iou"], max_det=cell["max_det"],
                   max_nms=cell["max_nms"], device=device)
    return ev, pool.view(-1, B, S, S, 3), state


def request(ev, batch: torch.Tensor, device, spans: tracing.Spans):
    """One request: -> its detections (boxes, scores, classes, num) as numpy."""
    from object_detection_cib_torch.utils.device import to_unit

    on_card = torch.device(device).type == "cuda"
    with spans.span("infer.upload"):
        x = batch.to(device, non_blocking=True)
    with spans.span("infer.enqueue"):
        res = ev.eval_step(to_unit(x))
    with spans.span("infer.fetch"):
        host = [t.to("cpu", non_blocking=True) for t in (res.boxes, res.scores, res.classes, res.num_valid)]
        if on_card:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return tuple(t.numpy() for t in host)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_process: float,
        hook: Optional[Callable] = None) -> dict:
    """One run of an inference cell; ``hook(evaluator)`` may plant a fault."""
    cfg = cell["model"]
    B = cell["batch"]
    ev, batches, state = build(cell, seed, device)
    if hook is not None:
        hook(ev)
    rng = np.random.default_rng([int(seed) & (2**63 - 1), inputs.STREAM_PICK])
    order = rng.permutation(batches.shape[0])
    spans = tracing.Spans()
    for i in range(WARMUP_REQUESTS):
        request(ev, batches[order[i % len(order)]], device, spans)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process
    spans = tracing.Spans()
    kept, lat, which = {}, [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        j = int(order[i % len(order)])
        a = time.perf_counter()
        out = request(ev, batches[j], device, spans)
        b = time.perf_counter()
        lat.append(b - a)
        which.append(j)
        if i < cell["judged_from_first"]:
            kept[i] = out
        i += 1
        if b - t0 >= seconds:
            break
    t1 = time.perf_counter()
    kept[i - 1] = out
    n = len(lat)
    p95 = statistics.quantiles(lat, n=100)[94] if n >= 2 else lat[0]
    res = {"setup_s": setup_s, "attempted": n, "failed": 0, "window_s": t1 - t0,
           "e2e": {"infer_img_s": n * B / (t1 - t0), "infer_p95_ms": p95 * 1e3, "setup_s": setup_s},
           "enqueue_ms": statistics.median(spans.durations("infer.enqueue")) * 1e3,
           "detail": "latency ms p50 %.3f p95 %.3f p99 %.3f max %.3f over %d requests" % (
               *(q * 1e3 for q in (statistics.median(lat), p95, statistics.quantiles(lat, n=100)[98] if n >= 2 else
                                   lat[0], max(lat))), n)}
    record = None
    if trace:
        reqs = max(1, int(cell["trace_seconds"] * n / (t1 - t0)))

        def work():
            for k in range(reqs):
                request(ev, batches[int(order[k % len(order)])], device, spans)

        tr = tracing.traced(work, device)
        record = dict(tr, cell=cell["name"], kind="infer", chips=1, batch=B, image_size=cell["image_size"],
                      requests=reqs, rate_img_s=res["e2e"]["infer_img_s"], enqueue_ms=res["enqueue_ms"],
                      image_flops=registry.family(cfg).conv_flops(cfg, cell["image_size"]),
                      nms_k=cell["max_nms"])
    res["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    del ev
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    first = sorted(k for k in kept if k < cell["judged_from_first"])
    sample = sorted(set(rng.choice(first, size=min(cell["judged_requests"], len(first)), replace=False).tolist())
                    | {i - 1})
    res["numbers"] = judge_requests(cell, state, batches, {k: (which[k], kept[k]) for k in sample}, device)
    res["record"] = record
    return res


def judge_requests(cell: dict, state: dict, batches: torch.Tensor, answers: dict, device,
                   quant: bool = False) -> dict:
    """The widest of each detection number over the judged requests;
    ``answers`` {request: (pool batch, detections)}."""
    cfg = cell["model"]
    net_family = registry.family(cfg)
    worst = {}
    with plain_math(), torch.no_grad():
        net = net_family.reference(cfg).to(device).eval()
        net.load_state_dict(state)
        net.set_quant(quant)
        for j, det in answers.values():
            images = batches[j].to(device).float() / 255.0
            decoded = net_family.decode(cfg, net(images))
            ref = nms(decoded, cell["conf"], cell["iou"], cell["max_det"], cell["max_nms"])
            got = judge.detection_numbers(tuple(torch.as_tensor(t) for t in det), decoded, ref)
            worst = {k: max(v, worst.get(k, v)) for k, v in got.items()}
    return worst


def reference_answers(cell: dict, state: dict, batches: torch.Tensor, picks, device, quant: bool) -> dict:
    """The reference's own detections (``quant``: its fp8 control) for pool
    batches ``picks``, as a program's answers: {i: (batch, detections)}."""
    cfg = cell["model"]
    net_family = registry.family(cfg)
    out = {}
    with plain_math(), torch.no_grad():
        net = net_family.reference(cfg).to(device).eval()
        net.load_state_dict(state)
        net.set_quant(quant)
        for i, j in enumerate(picks):
            images = batches[j].to(device).float() / 255.0
            d = nms(net_family.decode(cfg, net(images)), cell["conf"], cell["iou"], cell["max_det"],
                    cell["max_nms"])
            out[i] = (j, (d.boxes.cpu(), d.scores.cpu(), d.classes.cpu(), d.num.cpu()))
    return out


def reading(cell: dict, seed: int, device, hook=None, what: str = "program") -> dict:
    """``calibrate.py``'s reading: the numbers of ``judged_requests`` pool
    batches drawn from the seed, judged as a run judges them, without a
    timed window; ``what`` "control" puts the fp8 reference in the
    program's place, ``hook`` plants a fault."""
    ev, batches, state = build(cell, seed, device)
    rng = np.random.default_rng([int(seed) & (2**63 - 1), inputs.STREAM_PICK])
    picks = rng.permutation(batches.shape[0])[:cell["judged_requests"]].tolist()
    if what == "control":
        answers = reference_answers(cell, state, batches, picks, device, quant=True)
    elif what == "program":
        if hook is not None:
            hook(ev)
        spans = tracing.Spans()
        answers = {i: (j, request(ev, batches[j], device, spans)) for i, j in enumerate(picks)}
    else:
        raise ValueError(f"an inference cell has no {what!r} reading")
    del ev
    gc.collect()
    return judge_requests(cell, state, batches, answers, device)
