"""A training cell: ``Trainer.fit`` on the fused epoch, whole epochs, on
one card or over ``chips`` cards.

The cell's file states the traffic: sizes, ``aug`` (the augment's ranges,
``reference.feed.Aug``'s fields, given to the program as its
``AugParams`` and to the reference as they are) and ``program`` (further
``Trainer`` keywords, among ``PROGRAM_KEYS``). The network is the
configuration's family (``networks/``).

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

Over several cards the program's own launcher
(``parallel/distributed.py:launch``) starts one rank a card, NCCL between
them (gloo on the CPU). ``batch`` is the global batch: each rank builds
its trainer on its card, as one host's rank, and trains on its
``batch / chips`` rows of every step, its BatchNorm statistics and the
gradient summed over the ranks. Every rank runs the set-up above and waits
for the others before the window; rank 0 times its ``fit`` (the global
batch's images over its wall time), traces its own card and hands back the
judged steps; ``setup_s`` runs from this process's start, the ranks' start
included, and the peak memory is the fullest card's. Each rank hands back
the forbidden modules it holds once its window has closed, and a run in
which any holds one raises. Once the ranks have
exited the reference follows the judged steps on the first card at the
global batch, as one batch: BatchNorm over all of it, as the synchronised
BatchNorm computes it.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from counts.flops import TRAIN_FACTOR
from harness import faults, inputs, judge, registry, tracing
from harness.loaded import forbidden_modules, refuse_ranks
from reference import plain_math
from reference.feed import (Aug, Draws, content_size, count_draws, draw_step, epoch_plans, reached_bytes,
                            steps_batches, target_arrays)

FAULTS = faults.TRAIN  # what ``calibrate.py`` plants under this window
MESH_FAULTS = faults.MESH  # and, under a cell of several cards, these
# ``Trainer`` keywords a cell's ``program`` may set: they change how the
# program computes its steps, not what; the reference follows any of them.
# A keyword that changes what is computed (no mosaic, mixup, a sampler,
# loss weights) needs the reference to follow it first.
PROGRAM_KEYS = ("fused_epoch", "fused_pipelined", "fused_dispatch_ahead", "remat_policy", "warp_pallas")
STEP_KERNEL = "gather_rows_kernel"  # K2: one launch a step in every recipe the reference follows (no mixup)
TRACED_EPOCHS = 3  # a traced window's fewest epochs: the second's fetch must come before the last epoch's
RANKS_TIMEOUT_S = 900.0  # the ranks of one launch end within this, or the launch raises


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


def build(cell: dict, seed: int, device, m: inputs.Manifest, mesh=None):
    """The program's trainer over the seed's corpus, with the seed's
    weights (on ``mesh``, this rank's): -> (trainer, weights)."""
    from object_detection_cib_torch.data.device_pipeline import DeviceCorpus
    from object_detection_cib_torch.train.trainer import FitConfig, Trainer

    cfg = cell["model"]
    net_family = registry.family(cfg)
    S, B = cell["image_size"], cell["batch"]
    info = inputs.dataset_info(m)
    images, sizes = inputs.corpus(seed, m, S, device)
    trainer = Trainer(
        info, info, **net_family.trainer_keywords(cfg),
        image_size=S, batch_size=B, aug_params=program_aug(aug(cell)), max_targets=cell["max_targets"], seed=seed,
        dtype=torch.bfloat16, device=device, pipeline="device", device_cache=True,
        corpus=DeviceCorpus(info, images, sizes, device), max_epochs=cell["max_epochs"], val_device_cache=False,
        assign_compact_slots=cell["compact_slots"], mesh=mesh, **program_keywords(cell))
    trainer.loop = FitConfig(check_val_every_n_epoch=10**9, log_every_n_steps=10**9)
    state = net_family.weights(seed, cfg, device)
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
    steps at the global batch: -> (losses, first gradient, parameters
    after)."""
    cfg = cell["model"]
    net_family = registry.family(cfg)
    S, B = cell["image_size"], cell["batch"]
    with plain_math():
        net = net_family.reference(cfg).to(device)
        net.load_state_dict(state)
        net.set_quant(quant)
        images, sizes = inputs.corpus(seed, m, S, device)
        targets = tuple(torch.from_numpy(a).to(device) for a in target_arrays(m.shapes, m.boxes, m.labels, S))
        plans = epoch_plans(seed, len(m.shapes), B, 2)
        batches = steps_batches(images, sizes, targets, plans, [1, judged - 1], seed, S, aug(cell),
                                cell["max_targets"])
        losses, first = net_family.train_steps(cfg, net, batches, len(m.shapes) // B, S)
        after = {n: p.detach().clone() for n, p in net.named_parameters()}
    return losses, first, after


def judge_steps(prog, ref, state: dict) -> dict:
    (lp, fp, ap), (lr, fr, ar) = prog, ref
    return judge.train_numbers(lp, lr, fp, fr, {n: ap[n] - state[n] for n in ar}, {n: ar[n] - state[n] for n in ar})


def k5_reached(cell: dict, seed: int, device, m: inputs.Manifest, done: int, epoch: int, steps: int):
    """Source bytes K5's taps reach on rank 0's card (its ``batch /
    chips`` groups of the global step) in each of the first ``steps``
    steps of epoch ``epoch``, after ``done`` steps' draws."""
    S, B = cell["image_size"], cell["batch"]
    mine = B // cell["chips"]
    a = aug(cell)
    gen = torch.Generator(device=device).manual_seed(seed)
    count_draws(gen, B, S, a, done)
    plan = epoch_plans(seed, len(m.shapes), B, epoch + 1)[epoch]
    sizes = torch.tensor([content_size(h, w, S) for h, w in m.shapes], dtype=torch.int32, device=device)
    out = []
    for i in range(steps):
        d = Draws(*(t[:mine] for t in draw_step(gen, B, S, a)))
        out.append(reached_bytes(sizes[torch.from_numpy(plan[i][:4 * mine]).to(device)], d, S))
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


def _train(cell: dict, seed: int, seconds: float, trace: bool, device, t_process: float, hook: Optional[Callable],
           m: inputs.Manifest, mesh=None) -> dict:
    """The program's part of one run, on one card or as one rank of
    ``mesh``: set-up, the judged first steps (``prog``) and the window."""
    cfg = cell["model"]
    S, B = cell["image_size"], cell["batch"]
    trainer, state = build(cell, seed, device, m, mesh)
    if hook is not None:
        hook(trainer)
    judged = cell["judged_steps"]
    prog = first_steps(trainer, judged)
    spe = trainer.steps_per_epoch
    epochs = window_epochs(cell, seconds)
    spans = tracing.Spans()
    on_card = torch.device(device).type == "cuda"
    main = mesh is None or mesh.rank == 0
    tr = None
    if trace:
        epochs = max(epochs, TRACED_EPOCHS)
        trainer.loop = trainer.loop._replace(log_every_n_steps=spe)
        if main:
            tr = _TraceOneEpoch(tracing.Trace(device, sync=False))
            trainer.loggers = list(trainer.loggers) + [tr]
    if mesh is not None:
        from object_detection_cib_torch.parallel.distributed import barrier

        barrier(mesh)
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
    if tr is not None:
        if tr.calls < 2:
            raise RuntimeError(f"the traced window's fit called its loggers {tr.calls} times in {epochs} epochs")
        record = dict(tr.trace.record(), cell=cell["name"], kind="train", chips=cell["chips"],
                      batch=B // cell["chips"], image_size=S, step_kernel=STEP_KERNEL,
                      step_flops=TRAIN_FACTOR * registry.family(cfg).conv_flops(cfg, S) * B,
                      k5_reached=k5_reached(cell, seed, device, m, judged + 2 * spe, start + 2, spe))
        lead, tail = record["edge_idle_s"]
        out["detail"] = (f"trace: {record['window_s']:.3f} s window, idle {record['window_s'] - record['busy_s']:.6f} s, "
                         f"of it {lead:.6f} s at its start and {tail:.6f} s at its end; "
                         f"{len(record['kernels'])} device operations")
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    out["record"], out["prog"], out["state"] = record, prog, state
    del trainer, window, tr
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def _moved(x, device):
    """``x`` with its tensors copied to ``device``: to the host as a rank
    hands them back, to the first card for the reference."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    if isinstance(x, dict):
        return {k: _moved(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_moved(v, device) for v in x)
    return x


def _rank_run(mesh, cell, seed, seconds, trace, t_process, hook):
    """One rank of a run over several cards (``launch``'s function): rank 0
    hands back its run without the weights, which the reference draws
    again; the others their peak memory; each the forbidden modules it
    holds once the window has closed."""
    m = manifest(cell, seed)
    out = _train(cell, seed, seconds, trace, mesh.device, t_process, hook, m, mesh)
    out.pop("state")
    out = _moved(out, "cpu") if mesh.rank == 0 else {"memory_peak_bytes": out["memory_peak_bytes"]}
    return dict(out, forbidden=forbidden_modules())


def _launch(cell: dict, device, fn, args: tuple) -> list:
    """``fn(mesh, *args)`` on ``cell["chips"]`` ranks, one a card from the
    first (or on the CPU over gloo), by the program's launcher."""
    from object_detection_cib_torch.parallel.distributed import launch

    on_card = torch.device(device).type == "cuda"
    if on_card:  # built once here, not by every rank at once
        from object_detection_cib_torch.ops.build import build_all

        build_all()
    return launch(fn, cell["chips"], args=args, device_type="cuda" if on_card else "cpu",
                  join_timeout_s=RANKS_TIMEOUT_S)


def manifest(cell: dict, seed: int) -> inputs.Manifest:
    cfg = cell["model"]
    a = cfg["assumed"]
    return inputs.manifest(seed, a["corpus_images"], cell["image_size"], cfg["nc"], tuple(a["boxes_per_image"]),
                           a["zipf_a"])


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_process: float,
        hook: Optional[Callable] = None) -> dict:
    """One run of a training cell; ``hook(trainer)`` may plant a fault (on
    every rank)."""
    if cell["chips"] == 1:
        m = manifest(cell, seed)
        out = _train(cell, seed, seconds, trace, device, t_process, hook, m)
        state = out.pop("state")
    else:
        outs = _launch(cell, device, _rank_run, (cell, seed, seconds, trace, t_process, hook))
        refuse_ranks([o.pop("forbidden") for o in outs])
        out = outs[0]
        out["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)
        m = manifest(cell, seed)
        cfg = cell["model"]
        state = registry.family(cfg).weights(seed, cfg, device)
    prog = _moved(out.pop("prog"), device)
    ref = reference_steps(cell, seed, device, m, state, cell["judged_steps"])
    out["numbers"] = judge_steps(prog, ref, state)
    return out


def _judged(cell: dict, seed: int, device, hook, in_float32: bool, mesh=None):
    """The program's judged first steps, without a window: -> (prog, weights)."""
    trainer, state = _built(cell, seed, device, manifest(cell, seed), in_float32, mesh)
    if hook is not None:
        hook(trainer)
    prog = first_steps(trainer, cell["judged_steps"])
    del trainer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return prog, state


def _rank_readings(mesh, cell, jobs):
    """Every job's judged steps on the ranks of one launch: -> (rank 0's
    readings, else None; the forbidden modules this rank holds)."""
    progs = [_judged(cell, seed, mesh.device, hook, in_float32, mesh)[0] for seed, hook, in_float32 in jobs]
    return ([_moved(p, "cpu") for p in progs] if mesh.rank == 0 else None), forbidden_modules()


def _numbers(cell: dict, seed: int, device, prog, state) -> dict:
    """A reading's numbers: ``prog`` (None: the fp8 control's) against the
    reference, the leaves with the widest gaps beside them."""
    cfg = cell["model"]
    m = manifest(cell, seed)
    judged = cell["judged_steps"]
    if state is None:
        state = registry.family(cfg).weights(seed, cfg, device)
    if prog is None:
        prog = reference_steps(cell, seed, device, m, state, judged, quant=True)
    prog = _moved(prog, device)
    ref = reference_steps(cell, seed, device, m, state, judged)
    numbers = judge_steps(prog, ref, state)
    delta = lambda run: {n: run[2][n] - state[n] for n in ref[2]}  # noqa: E731
    numbers["worst_grad_leaves"] = judge.worst_leaves(prog[1], ref[1], ref[1])
    numbers["worst_update_leaves"] = judge.worst_leaves(delta(prog), delta(ref), ref[1])
    numbers["step_loss_gaps"] = [abs(a - b) / abs(b) for a, b in zip(prog[0], ref[0])]
    return numbers


def readings(cell: dict, jobs, device) -> list:
    """``calibrate.py``'s readings: the judged first steps at the cell's own
    sizes, as a run judges them, without a window. Each job is (seed,
    hook, what): "program" (``hook`` may plant a fault), "control" (the
    fp8 reference in the program's place) or "float32_program" (the
    program computing in float32, a second witness). Over several cards
    the program's jobs run first, on the ranks of one launch, and the
    references after it."""
    for _, _, what in jobs:
        if what not in ("program", "control", "float32_program"):
            raise ValueError(f"a training cell has no {what!r} reading")
    if cell["chips"] == 1:
        return [_numbers(cell, seed, device, *((None, None) if what == "control" else
                                               _judged(cell, seed, device, hook, what == "float32_program")))
                for seed, hook, what in jobs]
    ran = [(seed, hook, what == "float32_program") for seed, hook, what in jobs if what != "control"]
    outs = _launch(cell, device, _rank_readings, (cell, ran)) if ran else [([], [])]
    refuse_ranks([found for _, found in outs])
    progs = iter(outs[0][0])
    return [_numbers(cell, seed, device, None if what == "control" else next(progs), None)
            for seed, _, what in jobs]


def _built(cell, seed, device, m, in_float32: bool, mesh=None):
    from object_detection_cib_torch.train import trainer as T

    if not in_float32:
        return build(cell, seed, device, m, mesh)
    init = T.Trainer.__init__
    T.Trainer.__init__ = lambda self, *a, **k: init(self, *a, **{**k, "dtype": torch.float32})
    try:
        return build(cell, seed, device, m, mesh)
    finally:
        T.Trainer.__init__ = init
