"""Assignment, loss and SmartSGD in plain float32, and the steps that follow
the program's first training steps.

The YOLOv5 recipe as ``configs/model/yv5.yaml`` and ``configs/nn/`` state
it, in the form the measured program computes it (frozen copies):

  * assignment: each target to the anchors whose w/h ratio lies within 4,
    at its own cell and the nearer x and y neighbour (3 slots an anchor);
    each level's valid slots compacted to the first 128 B;
  * loss: CIoU box loss, objectness BCE against the clamped IoU (levels
    weighted 4 / 1 / 0.4), class BCE; lambdas 0.05 / 1 (x (S/640)^2) /
    0.5 (x nc/80); the step minimises B times their sum;
  * SmartSGD: Nesterov momentum, weight decay 5e-4 on conv kernels only, a
    linear schedule over 300 epochs, warm-up over max(3 epochs, 100) steps
    (bias lr from 0.1, momentum from 0.8).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.feed import Batch
from reference.network import BatchNorm, YOLOv5

ANCHORS = (((10, 13), (16, 30), (33, 23)), ((30, 61), (62, 45), (59, 119)), ((116, 90), (156, 198), (373, 326)))
STRIDES = (8, 16, 32)
THRESHOLD = 4.0
COMPACT_SLOTS = 128


class Recipe(NamedTuple):
    lr0: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    lrf: float = 0.01
    max_epochs: int = 300
    warmup_epochs: float = 3.0
    warmup_bias_lr: float = 0.1
    warmup_momentum: float = 0.8


# ------------------------------------------------------------- assignment
class Slots(NamedTuple):
    b: torch.Tensor
    a: torch.Tensor
    gy: torch.Tensor
    gx: torch.Tensor
    txywh: torch.Tensor
    labels: torch.Tensor
    anchor_wh: torch.Tensor
    valid: torch.Tensor


def _xyxy_to_cxcywh(b):
    return torch.stack([(b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
                        b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]], -1)


def _cxcywh_to_xyxy(b):
    return torch.stack([b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                        b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2], -1)


def assign_level(boxes, labels, mask, anchors_px, stride: int, size: int) -> Slots:
    B, T, _ = boxes.shape
    A = len(anchors_px)
    dev = boxes.device
    grid = size / stride
    out = size // stride
    anc = torch.tensor(anchors_px, dtype=torch.float32, device=dev) / stride
    t = _xyxy_to_cxcywh(boxes.float()) / float(stride)
    cxcy, wh = t[..., 0:2], t[..., 2:4]
    ratio = wh[:, :, None, :] / anc[None, None]
    ok = (torch.maximum(ratio, 1.0 / ratio).amax(-1) < THRESHOLD) & mask[:, :, None]
    gx, gy = cxcy[..., 0], cxcy[..., 1]
    j = (torch.remainder(gx, 1.0) < 0.5) & (gx > 1.0)
    k = (torch.remainder(gy, 1.0) < 0.5) & (gy > 1.0)
    l_ = (torch.remainder(grid - gx, 1.0) < 0.5) & (grid - gx > 1.0)
    m = (torch.remainder(grid - gy, 1.0) < 0.5) & (grid - gy > 1.0)
    half, zeros = torch.full_like(gx, 0.5), torch.zeros_like(gx)
    off_x, off_y = torch.where(j, half, -half), torch.where(k, half, -half)
    offsets = torch.stack([torch.stack([zeros, zeros], -1), torch.stack([off_x, zeros], -1),
                           torch.stack([zeros, off_y], -1)], -2)  # (B, T, 3, 2)
    off_ok = torch.stack([torch.ones_like(j), j | l_, k | m], -1)
    valid = ok[..., None] & off_ok[:, :, None, :]  # (B, T, A, 3)
    gij = torch.floor(cxcy[:, :, None, :] - offsets)
    txy = (cxcy[:, :, None, :] - gij)[:, :, None]
    gij = gij.to(torch.int64)
    gi = gij[..., 0].clamp(0, out - 1)[:, :, None, :]
    gj = gij[..., 1].clamp(0, out - 1)[:, :, None, :]
    shape = (B, T, A, 3)
    K = B * T * A * 3

    def bc(x, extra=()):
        return x.expand(shape + extra).reshape((K,) + extra)

    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    v = valid.reshape(K)
    z = torch.zeros((), dtype=torch.int64, device=dev)
    return Slots(torch.where(v, bc(ar(B)[:, None, None, None]), z), torch.where(v, bc(ar(A)[None, None, :, None]), z),
                 torch.where(v, bc(gj), z), torch.where(v, bc(gi), z),
                 torch.cat([bc(txy, (2,)), bc(wh[:, :, None, None, :], (2,))], -1),
                 torch.where(v, bc(labels.long()[:, :, None, None]), z), bc(anc[None, None, :, None, :], (2,)), v)


def compact(s: Slots, cap: int) -> Slots:
    idx = torch.argsort((~s.valid).to(torch.int8), stable=True)[:min(cap, s.valid.shape[0])]
    return Slots(*(f[idx] for f in s))


# ------------------------------------------------------------------- loss
def _ciou(b1, b2, eps=1e-7):
    x1, y1, x2, y2 = b1.unbind(-1)
    x1g, y1g, x2g, y2g = b2.unbind(-1)
    iw = (torch.minimum(x2, x2g) - torch.maximum(x1, x1g)).clamp(min=0)
    ih = (torch.minimum(y2, y2g) - torch.maximum(y1, y1g)).clamp(min=0)
    inter = iw * ih
    union = (x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - inter
    iou = inter / (union + eps)
    cw = torch.maximum(x2, x2g) - torch.minimum(x1, x1g)
    ch = torch.maximum(y2, y2g) - torch.minimum(y1, y1g)
    d = (((x1 + x2) * 0.5 - (x1g + x2g) * 0.5) ** 2 + ((y1 + y2) * 0.5 - (y1g + y2g) * 0.5) ** 2) / (cw**2 + ch**2 + eps)
    v = (4.0 / math.pi**2) * (torch.atan((x2g - x1g) / (y2g - y1g + eps)) - torch.atan((x2 - x1) / (y2 - y1 + eps))) ** 2
    alpha = (v / ((1.0 - iou) + v + eps)).detach()
    return iou - d - alpha * v


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def level_loss(raw: torch.Tensor, s: Slots, A: int, nc: int):
    B, H, W, _ = raw.shape
    valid = s.valid.float()
    n_valid = valid.sum().clamp(min=1.0)
    rows = raw[s.b, s.gy, s.gx]
    sel = F.one_hot(s.a, A).to(rows.dtype)
    K = rows.shape[0]
    p = (rows[:, :A * 4].reshape(K, A, 4) * sel[:, :, None]).sum(1)
    xy = torch.sigmoid(p[:, 0:2]) * 2.0 - 0.5
    wh = (torch.sigmoid(p[:, 2:4]) * 2.0) ** 2 * s.anchor_wh
    iou = _ciou(_cxcywh_to_xyxy(torch.cat([xy, wh], -1)), _cxcywh_to_xyxy(s.txywh))
    loc = ((1.0 - iou) * valid).sum() / n_valid
    iou_t = iou.clamp(min=0.0).detach()
    matched = (rows[:, A * 4:A * 5] * sel).sum(1)
    obj = (_softplus(raw[..., A * 4:A * 5]).sum() - (iou_t * matched * valid).sum()) / (B * H * W * A)
    pc = (rows[:, A * 5:].reshape(K, A, nc) * sel[:, :, None]).sum(1)
    t = F.one_hot(s.labels, nc).float()
    cls_el = t * _softplus(-pc) + (1.0 - t) * _softplus(pc)
    cls = (cls_el * valid[:, None]).sum() / (valid.sum() * nc).clamp(min=1.0)
    return loc, obj, cls


def loss(heads: Sequence[torch.Tensor], batch: Batch, nc: int, size: int, A: int = 3):
    """-> (total = B (box + obj + cls), box, obj, cls)."""
    B = batch.images.shape[0]
    loc = obj = cls = 0.0
    for raw, anc, stride, w in zip(heads, ANCHORS, STRIDES, (4.0, 1.0, 0.4)):
        s = compact(assign_level(batch.boxes, batch.labels, batch.mask, anc, stride, size), COMPACT_SLOTS * B)
        lo, ob, cl = level_loss(raw, s, A, nc)
        loc, obj, cls = loc + lo, obj + w * ob, cls + cl
    box, obj, cls = 0.05 * loc, 1.0 * (size / 640.0) ** 2 * obj, 0.5 * (nc / 80.0) * cls
    return B * (box + obj + cls), box, obj, cls


# ---------------------------------------------------------------- SmartSGD
f32 = np.float32


def _interp(x, x1, y0, y1):
    t = np.clip(f32(x) / f32(max(x1, 1)), f32(0.0), f32(1.0))
    return y0 + t * (y1 - y0)


def hyperparams(step: int, steps_per_epoch: int, r: Recipe) -> Tuple[float, float, float]:
    """(lr_bias, lr_other, momentum) of a global step."""
    nw = max(round(steps_per_epoch * r.warmup_epochs), 100)
    epoch = step // steps_per_epoch
    sch = (1.0 - f32(epoch) / r.max_epochs) * (1.0 - r.lrf) + r.lrf
    lr = f32(r.lr0 * f32(sch))
    if step <= nw:
        return (float(f32(_interp(step, nw, r.warmup_bias_lr, lr))), float(f32(_interp(step, nw, 0.0, lr))),
                float(f32(_interp(step, nw, r.warmup_momentum, r.momentum))))
    return float(lr), float(lr), float(f32(r.momentum))


def param_groups(net: YOLOv5) -> Dict[str, str]:
    """Parameter name -> "bias" (every bias), "norm" (BatchNorm weights) or
    "decay" (conv kernels)."""
    norm = {f"{n}.weight" for n, m in net.named_modules() if isinstance(m, BatchNorm)}
    return {n: "bias" if n.endswith(".bias") else "norm" if n in norm else "decay" for n, _ in net.named_parameters()}


class SGD:
    def __init__(self, net: YOLOv5, steps_per_epoch: int, recipe: Recipe = Recipe()):
        self.params = dict(net.named_parameters())
        self.groups = param_groups(net)
        self.momentum = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.steps_per_epoch, self.recipe, self.step_count = steps_per_epoch, recipe, 0

    @torch.no_grad()
    def step(self) -> None:
        lr_bias, lr_other, mom = hyperparams(self.step_count, self.steps_per_epoch, self.recipe)
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if self.groups[n] == "decay":
                g = g + p * self.recipe.weight_decay
            buf = self.momentum[n]
            buf.mul_(mom).add_(g)
            p.sub_((g + buf * mom) * (lr_bias if self.groups[n] == "bias" else lr_other))
            p.grad = None
        self.step_count += 1


def train_steps(net: YOLOv5, batches, steps_per_epoch: int, nc: int, size: int) -> Tuple[List[float],
                                                                                    Dict[str, torch.Tensor]]:
    """Run the reference step on each batch: -> (each step's total loss,
    the momentum after the first step: the first gradient as SmartSGD
    takes it, decay included)."""
    opt = SGD(net, steps_per_epoch)
    losses, first = [], None
    net.train()
    for batch in batches:
        total, *_ = loss(net(batch.images), batch, nc, size)
        total.backward()
        opt.step()
        losses.append(float(total.detach()))
        if first is None:
            first = {n: b.clone() for n, b in opt.momentum.items()}
    return losses, first
