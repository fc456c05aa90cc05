"""YOLOv5 n/s/m/l: the family of ``configs/yolov5s.json`` and
``configs/yolov5l.json``, under the names ``networks/__init__.py`` lists.

The reference is ``reference/network.py`` (CSPDarknet, SPPF, PAFPN, three
anchor heads), trained by ``reference/train.py`` and decoded by
``reference/detect.py``; the program builds the same network from its
``size`` keywords (``models/yolov5.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from counts.bn_silu import bn_elements as _bn_elements
from counts.flops import conv_flops as _conv_flops
from harness.inputs import STREAM_WEIGHTS, generator
from reference import detect, train
from reference.network import BatchNorm, Conv, YOLOv5, head_priors

KEYS = ("nc", "depth_multiple", "width_multiple")
HEADS = ("ll_head", "ml_head", "hl_head")


def reference(cfg: dict) -> YOLOv5:
    return YOLOv5(cfg["nc"], cfg["depth_multiple"], cfg["width_multiple"])


def weights(seed: int, cfg: dict, device) -> Dict[str, torch.Tensor]:
    """The network's f32 state, drawn on ``device`` in one call: conv
    kernels and head biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the head
    kernels times the assumed ``head_scale``, YOLOv5's obj / cls priors on
    the head biases; BatchNorm scale the assumed ``batchnorm_scale``, shift
    0, running mean 0, running variance 1."""
    a = cfg["assumed"]
    bn_scale, head_scale = a["batchnorm_scale"], a["head_scale"]
    net = reference(cfg).to("meta")
    state = net.state_dict()
    bounds = {}
    for name, mod in net.named_modules():
        if hasattr(mod, "weight") and mod.weight is not None and mod.weight.dim() == 4:
            fan_in = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
            bounds[f"{name}.weight"] = 1.0 / fan_in ** 0.5
            if getattr(mod, "bias", None) is not None:
                bounds[f"{name}.bias"] = 1.0 / fan_in ** 0.5
    drawn = [k for k in state if k in bounds]
    flat = torch.rand(sum(state[k].numel() for k in drawn), generator=generator(seed, STREAM_WEIGHTS, device),
                      device=device)
    out, at = {}, 0
    for k, v in state.items():
        if k in bounds:
            n = v.numel()
            out[k] = ((flat[at:at + n] * 2.0 - 1.0) * bounds[k]).reshape(v.shape)
            at += n
        elif k.endswith("running_var"):
            out[k] = torch.ones(v.shape, device=device)
        elif k.endswith(".weight") and v.dim() == 1:
            out[k] = torch.full(v.shape, float(bn_scale), device=device)
        else:
            out[k] = torch.zeros(v.shape, device=device)
    for prefix in HEADS:
        head = getattr(net, prefix)
        A, (obj_add, cls_add) = head.anchors, head_priors(cfg["nc"], head.stride)
        out[f"{prefix}.conv.weight"] *= head_scale
        b = out[f"{prefix}.conv.bias"]
        b[A * 4:A * 5] += obj_add
        b[A * 5:] += cls_add
    return out


def calibrated(cfg: dict, state: Dict[str, torch.Tensor], images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``state`` with each BatchNorm's running statistics set to the batch
    statistics of ``images`` ((B, S, S, 3) in [0, 1]) in the float32
    reference: random weights whose eval-mode activations neither vanish
    nor blow up, so that every image's detections carry information."""
    from reference import plain_math

    net = reference(cfg).to(images.device)
    net.load_state_dict(state)
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 1.0
    with plain_math(), torch.no_grad():
        net.train()(images)
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _size(cfg: dict) -> dict:
    return {"deepen_factor": cfg["depth_multiple"], "widen_factor": cfg["width_multiple"]}


def trainer_keywords(cfg: dict) -> dict:
    return {"size": _size(cfg)}


def eval_network(cfg: dict, device):
    """The program's network in bf16 and its anchors."""
    from object_detection_cib_torch.core.types import default_anchors
    from object_detection_cib_torch.models.yolov5 import build_network

    return build_network(cfg["nc"], _size(cfg), dtype=torch.bfloat16, device=device), default_anchors()


def train_steps(cfg: dict, net: YOLOv5, batches, steps_per_epoch: int, size: int):
    return train.train_steps(net, batches, steps_per_epoch, cfg["nc"], size)


def decode(cfg: dict, heads) -> detect.Decoded:
    return detect.decode(heads, cfg["nc"])


def conv_flops(cfg: dict, size: int) -> int:
    return _conv_flops(reference(cfg).to("meta"), size, Conv)


def bn_elements(cfg: dict, size: int) -> Tuple[int, int]:
    return _bn_elements(reference(cfg).to("meta"), size, BatchNorm)


def parameters(cfg: dict) -> int:
    return sum(p.numel() for p in reference(cfg).to("meta").parameters())
