"""A training cell: ``Trainer.fit`` on the fused epoch, whole epochs.

The cell's file states the traffic: sizes, ``aug`` (the augment's ranges,
``reference.feed.Aug``'s fields, given to the program as its
``AugParams`` and to the reference as they are) and ``program`` (further
``Trainer`` keywords, among ``PROGRAM_KEYS``).

Set-up builds one ``Trainer`` from the public constructor over a corpus
made on the card from the seed, loads the seed's weights into it, and
drives it through its first steps with the window's own call, ``fit``: a
first epoch cut to one step (eager), then one cut to ``judged_steps - 1``
(two eager steps, the capture of the CUDA graphs, their replays). Those
steps are what ``correct`` judges; they also pay cuDNN's first calls and
the capture, so nothing compiles in the window.

The window is one ``fit`` call over ``window_epochs`` whole epochs for
each ``window_seconds`` (or part) of ``--seconds``, from the call to its
return, which ends in the fetch of the last epoch's metrics: the images of
its epochs over that wall time. Validation and checkpoints are off inside
it.

With ``--trace 1`` the window runs at least three epochs, and a logger
handed to the trainer (the program calls its loggers once an epoch, after
the epoch's fetch) starts the profiler after the first epoch's fetch and
stops it after the second's. Under dispatch-ahead the card then runs the
end of the second epoch and the third but for its last steps: whole steps
and one epoch boundary, as the timed window runs them, without the fit's
start or end.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from counts.flops import TRAIN_FACTOR, conv_flops
from harness import faults, inputs, judge, tracing
from reference import plain_math
from reference.feed import (Aug, content_size, count_draws, draw_step, epoch_plans, reached_bytes, steps_batches,
                            target_arrays)
from reference.network import YOLOv5
from reference.train import train_steps

FAULTS = faults.TRAIN  # what ``calibrate.py`` plants under this window
# ``Trainer`` keywords a cell's ``program`` may set: they change how the
# program computes its steps, not what; the reference follows any of them.
# A keyword that changes what is computed (no mosaic, mixup, a sampler,
# loss weights) needs the reference to follow it first.
PROGRAM_KEYS = ("fused_epoch", "fused_pipelined", "fused_dispatch_ahead", "remat_policy", "warp_pallas")
STEP_KERNEL = "gather_rows_kernel"  # K2: one launch a step in every recipe the reference follows (no mixup)
TRACED_EPOCHS = 3  # a traced window's fewest epochs: the second's fetch must come before the last epoch's


def aug(cell: dict) -> Aug:
    """The cell's augment ranges (``configs/data/augmentations/aug_params.yaml``
    where it states none)."""
    return Aug(**cell.get("aug", {}))


def program_aug(a: Aug):
    from object_detection_cib_torch.data.host_augment import AffineParams, AugParams, HSVParams

    return AugParams(AffineParams(translate=a.translate, scale=a.scale), HSVParams(a.hue, a.saturation, a.value),
                     a.flip_lr_prob)


def program_keywords(cell: dict) -> dict:
    extra = dict(cell.get("program", {}))
    unknown = sorted(set(extra) - set(PROGRAM_KEYS))
    if unknown:
        raise ValueError(f"cell {cell['name']}: the reference does not follow {unknown}; "
                         f"a cell's program may set {PROGRAM_KEYS}")
    return extra


def window_epochs(cell: dict, seconds: float) -> int:
    return cell["window_epochs"] * max(1, math.ceil(seconds / cell["window_seconds"]))


def build(cell: dict, seed: int, device, m: inputs.Manifest):
    """The program's trainer over the seed's corpus, with the seed's
    weights: -> (trainer, weights)."""
    from object_detection_cib_torch.data.device_pipeline import DeviceCorpus
    from object_detection_cib_torch.train.trainer import FitConfig, Trainer

    cfg = cell["model"]
    S, B = cell["image_size"], cell["batch"]
    info = inputs.dataset_info(m)
    images, sizes = inputs.corpus(seed, m, S, device)
    trainer = Trainer(
        info, info, size={"deepen_factor": cfg["deepen_factor"], "widen_factor": cfg["widen_factor"]},
        image_size=S, batch_size=B, aug_params=program_aug(aug(cell)), max_targets=cell["max_targets"], seed=seed,
        dtype=torch.bfloat16, device=device, pipeline="device", device_cache=True,
        corpus=DeviceCorpus(info, images, sizes, device), max_epochs=cell["max_epochs"], val_device_cache=False,
        assign_compact_slots=cell["compact_slots"], **program_keywords(cell))
    trainer.loop = FitConfig(check_val_every_n_epoch=10**9, log_every_n_steps=10**9)
    state = inputs.of_config(seed, cfg, device)
    with torch.no_grad():
        trainer.net.load_state_dict(state)
    return trainer, state


def first_steps(trainer, judged: int):
    """Drive ``trainer`` through its first ``judged`` steps by ``fit``:
    -> (their total losses, the momentum after step 1, the parameters
    after the last)."""
    trainer.fit(max_epochs=1, epoch_steps=1)
    first = {n: b.detach().clone() for n, b in trainer.optimizer.buffers.items()}
    trainer.fit(max_epochs=2, epoch_steps=judged - 1)
    losses = [float(x) for m in trainer.epoch_metrics[:2] for x in m["total"]]
    after = {n: p.detach().clone() for n, p in trainer.net.named_parameters()}
    return losses, first, after


def reference_steps(cell: dict, seed: int, device, m: inputs.Manifest, state: dict, judged: int,
                    quant: bool = False):
    """The reference (``quant``: its fp8 control) over the same first
    steps: -> (losses, first gradient, parameters after)."""
    cfg = cell["model"]
    S, B = cell["image_size"], cell["batch"]
    with plain_math():
        net = YOLOv5(cfg["nc"], cfg["deepen_factor"], cfg["widen_factor"]).to(device)
        net.load_state_dict(state)
        net.set_quant(quant)
        images, sizes = inputs.corpus(seed, m, S, device)
        targets = tuple(torch.from_numpy(a).to(device) for a in target_arrays(m.shapes, m.boxes, m.labels, S))
        plans = epoch_plans(seed, len(m.shapes), B, 2)
        batches = steps_batches(images, sizes, targets, plans, [1, judged - 1], seed, S, aug(cell),
                                cell["max_targets"])
        losses, first = train_steps(net, batches, len(m.shapes) // B, cfg["nc"], S)
        after = {n: p.detach().clone() for n, p in net.named_parameters()}
    return losses, first, after


def judge_steps(prog, ref, state: dict) -> dict:
    (lp, fp, ap), (lr, fr, ar) = prog, ref
    return judge.train_numbers(lp, lr, fp, fr, {n: ap[n] - state[n] for n in ar}, {n: ar[n] - state[n] for n in ar})


def k5_reached(cell: dict, seed: int, device, m: inputs.Manifest, done: int, epoch: int, steps: int):
    """Source bytes K5's taps reach in each of the first ``steps`` steps of
    epoch ``epoch``, after ``done`` steps' draws."""
    S, B = cell["image_size"], cell["batch"]
    a = aug(cell)
    gen = torch.Generator(device=device).manual_seed(seed)
    count_draws(gen, B, S, a, done)
    plan = epoch_plans(seed, len(m.shapes), B, epoch + 1)[epoch]
    sizes = torch.tensor([content_size(h, w, S) for h, w in m.shapes], dtype=torch.int32, device=device)
    out = []
    for i in range(steps):
        d = draw_step(gen, B, S, a)
        out.append(reached_bytes(sizes[torch.from_numpy(plan[i]).to(device)], d, S))
    return out


class _TraceOneEpoch:
    """A logger for the trainer: the profiler runs from its first call to
    its second (the program calls its loggers once an epoch, after the
    epoch's fetch, once ``log_every_n_steps`` is the epoch's steps), with
    the span ``window.fit`` open in it."""

    def __init__(self, trace: tracing.Trace):
        self.trace, self.calls, self._fit = trace, 0, None

    def log(self, metrics, step) -> None:
        self.calls += 1
        if self.calls == 1:
            self.trace.start()
            self._fit = torch.profiler.record_function("window.fit")
            self._fit.__enter__()
        elif self.calls == 2:
            self._fit.__exit__(None, None, None)
            self.trace.stop()


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_process: float,
        hook: Optional[Callable] = None) -> dict:
    """One run of a training cell; ``hook(trainer)`` may plant a fault."""
    cfg = cell["model"]
    S, B = cell["image_size"], cell["batch"]
    a = cfg["assumed"]
    m = inputs.manifest(seed, a["corpus_images"], S, cfg["nc"], tuple(a["boxes_per_image"]), a["zipf_a"])
    trainer, state = build(cell, seed, device, m)
    if hook is not None:
        hook(trainer)
    judged = cell["judged_steps"]
    prog = first_steps(trainer, judged)
    spe = trainer.steps_per_epoch
    epochs = window_epochs(cell, seconds)
    spans = tracing.Spans()
    on_card = torch.device(device).type == "cuda"
    tr = None
    if trace:
        epochs = max(epochs, TRACED_EPOCHS)
        tr = _TraceOneEpoch(tracing.Trace(device, sync=False))
        trainer.loop = trainer.loop._replace(log_every_n_steps=spe)
        trainer.loggers = list(trainer.loggers) + [tr]
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process
    start = trainer.epoch
    with spans.span("window.fit"):
        trainer.fit(max_epochs=start + epochs)
    (_, t0, t1), = spans.items
    window = trainer.epoch_metrics[start:]
    totals = np.concatenate([w["total"] for w in window])
    images = int(totals.size) * B
    failed = int((~np.isfinite(totals)).sum()) * B
    out = {"setup_s": setup_s, "e2e": {"train_img_s": images / (t1 - t0), "setup_s": setup_s},
           "attempted": images, "failed": failed, "window_epochs": epochs, "window_s": t1 - t0}
    record = None
    if trace:
        if tr.calls < 2:
            raise RuntimeError(f"the traced window's fit called its loggers {tr.calls} times in {epochs} epochs")
        record = dict(tr.trace.record(), cell=cell["name"], kind="train", chips=1, batch=B, image_size=S,
                      step_kernel=STEP_KERNEL,
                      step_flops=TRAIN_FACTOR * conv_flops(cfg["nc"], cfg["deepen_factor"], cfg["widen_factor"], S) * B,
                      k5_reached=k5_reached(cell, seed, device, m, judged + 2 * spe, start + 2, spe))
        lead, tail = record["edge_idle_s"]
        out["detail"] = (f"trace: {record['window_s']:.3f} s window, idle {record['window_s'] - record['busy_s']:.6f} s, "
                         f"of it {lead:.6f} s at its start and {tail:.6f} s at its end; "
                         f"{len(record['kernels'])} device operations")
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    del trainer, window, tr
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = reference_steps(cell, seed, device, m, state, judged)
    out["numbers"] = judge_steps(prog, ref, state)
    out["record"] = record
    return out


def reading(cell: dict, seed: int, device, hook=None, what: str = "program") -> dict:
    """``calibrate.py``'s reading: the judged first steps at the cell's own
    sizes, as a run judges them, without a window. ``what``: "program"
    (``hook`` may plant a fault), "control" (the fp8 reference in the
    program's place) or "float32_program" (the program computing in
    float32, a second witness). The leaves with the widest gaps come
    beside the numbers."""
    cfg, S = cell["model"], cell["image_size"]
    a = cfg["assumed"]
    m = inputs.manifest(seed, a["corpus_images"], S, cfg["nc"], tuple(a["boxes_per_image"]), a["zipf_a"])
    judged = cell["judged_steps"]
    if what == "control":
        state = inputs.of_config(seed, cfg, device)
        prog = reference_steps(cell, seed, device, m, state, judged, quant=True)
    elif what in ("program", "float32_program"):
        trainer, state = _built(cell, seed, device, m, what == "float32_program")
        if hook is not None:
            hook(trainer)
        prog = first_steps(trainer, judged)
        del trainer
        gc.collect()
    else:
        raise ValueError(f"a training cell has no {what!r} reading")
    ref = reference_steps(cell, seed, device, m, state, judged)
    numbers = judge_steps(prog, ref, state)
    delta = lambda run: {n: run[2][n] - state[n] for n in ref[2]}  # noqa: E731
    numbers["worst_grad_leaves"] = judge.worst_leaves(prog[1], ref[1], ref[1])
    numbers["worst_update_leaves"] = judge.worst_leaves(delta(prog), delta(ref), ref[1])
    return numbers


def _built(cell, seed, device, m, in_float32: bool):
    from object_detection_cib_torch.train import trainer as T

    if not in_float32:
        return build(cell, seed, device, m)
    init = T.Trainer.__init__
    T.Trainer.__init__ = lambda self, *a, **k: init(self, *a, **{**k, "dtype": torch.float32})
    try:
        return build(cell, seed, device, m)
    finally:
        T.Trainer.__init__ = init
