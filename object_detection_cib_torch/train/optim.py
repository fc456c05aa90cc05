"""Smart-SGD: three parameter groups, epoch schedules, per-step warmup.

Counterpart of ``object_detection_cib_tpu/train/optim.py`` (parity:
kod/nn/optim/smart.py:20-60, schedulers.py:13-24, warmup.py:39-58 and
exp.py:156-185):

  * groups: every ``*.bias`` (conv and BatchNorm) -> ``bias`` (no decay,
    warmup from ``warmup_bias_lr``); BatchNorm weight -> ``norm`` (no
    decay); everything else (conv kernels) -> ``decay`` (weight_decay);
  * torch.optim.SGD(momentum, nesterov=True) semantics with coupled decay
    on the decay group: g += wd*p; buf = mom*buf + g; d = g + mom*buf;
    p -= lr*d;
  * epoch-indexed lr schedules (linear / cosine / cosine_annealing / step);
  * warmup for nw = max(round(steps_per_epoch * warmup_epochs), 100) steps:
    each group's lr moves linearly from its start (bias 0.1, others 0) to
    lr0 * sch(epoch), momentum from 0.8 to 0.937, while step <= nw.

A step's hyperparameters come from the step count before it is
incremented, in f32 arithmetic as the JAX package traces them, computed on
the host by ``hyperparams``. The update reads them from the device: a
training loop fills one ``(steps, 3)`` table per epoch (``hyper_table``)
and hands each step its row, so a captured CUDA graph of the step reads
the replayed step's values and not the captured one's (the JAX package
computes them from the step inside its program). The update runs as
``torch._foreach_*`` ops per group, one op per arithmetic step so that
nothing is fused into a multiply-add. Not carried: the (rows, 128)
padded group view and its ``optimization_barrier`` (TPU layout fixes).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from object_detection_cib_torch.models.layers import BatchNorm

f32 = np.float32


def sch_linear(epoch, max_epochs: int, lrf: float):
    return (1.0 - epoch / max_epochs) * (1.0 - lrf) + lrf


def sch_cosine(epoch, max_epochs: int, lrf: float):
    return 1.0 + 0.5 * (lrf - 1.0) * (1.0 - np.cos(epoch / max_epochs * math.pi))


def sch_cosine_annealing(epoch, max_epochs: int, lrf: float):
    return ((1.0 + np.cos(epoch * math.pi / max_epochs)) / 2.0) * (1.0 - lrf) + lrf


def sch_step(epoch, step_size: int = 100, gamma: float = 0.5):
    return gamma ** np.floor(epoch / step_size)


def make_schedule(name: str, max_epochs: int, lrf: float = 0.01, **kw) -> Callable:
    if name == "linear":
        return lambda e: sch_linear(e, max_epochs, lrf)
    if name == "cosine":
        return lambda e: sch_cosine(e, max_epochs, lrf)
    if name == "cosine_annealing":
        return lambda e: sch_cosine_annealing(e, max_epochs, lrf)
    if name == "step":
        return lambda e: sch_step(e, **kw)
    raise ValueError(f"unknown schedule {name!r}")


GROUP_BIAS, GROUP_NORM, GROUP_DECAY = 0, 1, 2


def group_params(net: nn.Module) -> Dict[str, int]:
    """Parameter name -> optimizer group (ref smart.py:30-40)."""
    norm = {f"{m}.weight" for m, mod in net.named_modules() if isinstance(mod, BatchNorm)}
    groups = {}
    for name, _ in net.named_parameters():
        if name.endswith(".bias") or name == "bias":
            groups[name] = GROUP_BIAS
        elif name in norm:
            groups[name] = GROUP_NORM
        else:
            groups[name] = GROUP_DECAY
    return groups


class WarmupParams(NamedTuple):
    """ref configs/model/yv5.yaml optimizer_warmup_updater block."""

    warmup_epochs: float = 3.0
    warmup_bias_lr: float = 0.1
    warmup_momentum: float = 0.8


class OptimizerConfig(NamedTuple):
    lr0: float = 0.01  # ref configs/nn/optimizers/smart_sgd.yaml
    momentum: float = 0.937
    nesterov: bool = True
    weight_decay: float = 5e-4
    schedule: str = "linear"
    lrf: float = 0.01
    max_epochs: int = 300
    warmup: Optional[WarmupParams] = WarmupParams()


def _interp(x, x1, y0, y1):
    """np.interp(x, [0, x1], [y0, y1]) with clamping (ref warmup.py:39-58), f32."""
    t = np.clip(f32(x) / f32(max(x1, 1)), f32(0.0), f32(1.0))
    return y0 + t * (y1 - y0)


class SmartSGD:
    """SGD over a network's parameters with grouped lr/decay and warmup.

    Usage: ``opt = SmartSGD(net, config, steps_per_epoch)``; after
    ``backward()``, ``opt.step(hp)`` updates the parameters in place with
    the row ``hp`` of a ``hyper_table`` (by default the hyperparameters of
    ``opt.step_count``) and then increments ``step_count``, a host integer.
    ``state_dict()`` / ``load_state_dict()`` carry the momentum buffers (by
    parameter name) and ``step_count``, what a checkpoint holds beside the
    network's own ``state_dict`` (``train/checkpoint.py``).
    """

    def __init__(self, net: nn.Module, config: OptimizerConfig, steps_per_epoch: int):
        self.config = config
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.sch_fn = make_schedule(config.schedule, config.max_epochs, config.lrf)
        if config.warmup is not None:
            # nw = max(round(num_batches * warmup_epochs), 100)  (ref exp.py:167-173)
            self.nw = max(round(self.steps_per_epoch * config.warmup.warmup_epochs), 100)
        else:
            self.nw = 0
        labels = group_params(net)
        self.groups: List[Tuple[int, List[nn.Parameter], List[torch.Tensor]]] = []
        named = dict(net.named_parameters())
        self.buffers: Dict[str, torch.Tensor] = {}  # the groups' buffers by parameter name
        for grp in (GROUP_BIAS, GROUP_NORM, GROUP_DECAY):
            names = [n for n, g in labels.items() if g == grp]
            if names:
                bufs = [torch.zeros_like(named[n]) for n in names]
                self.buffers.update(zip(names, bufs))
                self.groups.append((grp, [named[n] for n in names], bufs))
        self.device = next(net.parameters()).device
        self.step_count = 0

    def state_dict(self) -> dict:
        """``{"step_count": int, "momentum": {name: buffer}}``; the buffers
        are the live tensors, which ``step`` updates in place."""
        return {"step_count": self.step_count, "momentum": dict(self.buffers)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy momentum buffers (by name, the same set) and ``step_count`` in."""
        mom = state["momentum"]
        if set(mom) != set(self.buffers):
            raise KeyError(f"momentum buffers differ: missing {sorted(set(self.buffers) - set(mom))}, "
                           f"unexpected {sorted(set(mom) - set(self.buffers))}")
        for name, buf in self.buffers.items():
            buf.copy_(mom[name])
        self.step_count = int(state["step_count"])

    def hyperparams(self, step: int) -> Tuple[float, float, float]:
        """(lr_bias, lr_other, momentum) at a global step, f32 values."""
        cfg = self.config
        epoch = step // self.steps_per_epoch
        lr_sched = f32(cfg.lr0 * f32(self.sch_fn(f32(epoch))))
        if cfg.warmup is None or self.nw == 0:
            return float(lr_sched), float(lr_sched), float(f32(cfg.momentum))
        w = cfg.warmup
        if step <= self.nw:  # ref exp.py:175-176 (applies while <= nw)
            lr_bias = _interp(step, self.nw, w.warmup_bias_lr, lr_sched)
            lr_other = _interp(step, self.nw, 0.0, lr_sched)
            mom = _interp(step, self.nw, w.warmup_momentum, cfg.momentum)
        else:
            lr_bias = lr_other = lr_sched
            mom = cfg.momentum
        return float(f32(lr_bias)), float(f32(lr_other)), float(f32(mom))

    def hyper_table(self, start: int, steps: int, device=None) -> torch.Tensor:
        """``(steps, 3)`` f32 rows ``(lr_bias, lr_other, momentum)`` of the
        global steps ``start .. start + steps - 1``: on the host (pinned when
        the parameters are on the card), or copied to ``device`` without
        blocking the host."""
        rows = np.asarray([self.hyperparams(start + i) for i in range(steps)], np.float32).reshape(steps, 3)
        table = torch.from_numpy(rows)
        if self.device.type == "cuda":
            table = table.pin_memory()
        return table if device is None else table.to(device, non_blocking=True)

    def zero_grad(self) -> None:
        for _, ps, _ in self.groups:
            for p in ps:
                p.grad = None

    @torch.no_grad()
    def step(self, hp: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one update with ``hp``, a (3,) f32 row of ``hyper_table`` on
        the parameters' device (by default the row of ``step_count``);
        returns the step's ``lr_other``, a 0-d tensor on that device."""
        cfg = self.config
        if hp is None:
            hp = self.hyper_table(self.step_count, 1, self.device)[0]
        lr_bias, lr_other, mom = hp[0], hp[1], hp[2]
        for grp, ps, bufs in self.groups:
            g = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
            if grp == GROUP_DECAY and cfg.weight_decay:
                g = torch._foreach_add(g, torch._foreach_mul(ps, cfg.weight_decay))
            torch._foreach_mul_(bufs, mom)
            torch._foreach_add_(bufs, g)
            if cfg.nesterov:
                d = torch._foreach_mul(bufs, mom)
                torch._foreach_add_(d, g)
            else:
                d = [b.clone() for b in bufs]
            torch._foreach_mul_(d, lr_bias if grp == GROUP_BIAS else lr_other)
            torch._foreach_sub_(ps, d)
        self.step_count += 1
        return lr_other
