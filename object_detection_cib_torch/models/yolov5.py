"""YOLOv5 network: CSPDarknet backbone + SPPF + PAFPN neck + anchor heads.

Counterpart of ``object_detection_cib_tpu/models/yolov5.py`` (parity:
kod/nn/networks/yolov5.py, kod/nn/backbones/yolov5.py:85-131,
kod/nn/necks/yolov5_pafpn.py, kod/nn/heads/yolov5.py:12-178).

Public contract (the JAX package's): images in as (B, H, W, 3); each head's
``raw`` out as (B, H, W, A*(5+nc)) in the channel order
[box(A*4) | obj(A) | cls(A*nc)]. Inside, activations are NCHW tensors in
``torch.channels_last`` memory format, so the NHWC <-> NCHW permutes at the
two ends are views, not copies.

``dtype`` sets the compute dtype (``torch.bfloat16`` in production): the
parameters stay f32, the input is cast once, every conv casts its weight to
the activation dtype, and each head casts its kernel, bias and input as the
JAX package does (models/yolov5.py:300-303). ``dtype=None`` computes in the
input's dtype.

Each head's three logical 1x1 convs (box, obj, cls; separate flax params) are
one ``nn.Conv2d`` here whose weight is their concatenation in that order.

Under DP x SP spatial sharding (``models/layers.py:set_spatial``) the
network takes a band of each image's rows and returns each head's map
gathered over the model axis along H, whole (JAX's ``head_sharding``
constraint, ``train/steps.py:148-155``); the gather's backward hands this
rank its own slice of the gradient (``parallel/spatial.py``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from object_detection_cib_torch.models.layers import (
    ConvBnAct,
    CSPLayer,
    SPPFBottleneck,
    conv2d,
    upsample_nearest_2x,
)
from object_detection_cib_torch.utils.device import resolve_device

ANCHORS_PER_CELL = 3  # anchors a grid cell, the network's default


def make_divisible(x: float, widen_factor: float = 1.0, divisor: int = 8) -> int:
    """ceil(x*widen/divisor)*divisor (ref kod/nn/utils.py:7-13)."""
    return math.ceil(x * widen_factor / divisor) * divisor


def make_round(x: float, deepen_factor: float = 1.0) -> int:
    """round(x*deepen), min 1 when x>1 (ref kod/nn/utils.py:16-22)."""
    return int(max(round(x * deepen_factor), 1) if x > 1 else x)


class StageConfig(NamedTuple):
    in_channels: int
    out_channels: int
    num_blocks: int
    add_identity: bool
    use_spp: bool


# P5 stage table (ref kod/nn/networks/yolov5.py:26-31)
P5_STAGES: Tuple[StageConfig, ...] = (
    StageConfig(64, 128, 3, True, False),
    StageConfig(128, 256, 6, True, False),
    StageConfig(256, 512, 9, True, False),
    StageConfig(512, 1024, 3, False, True),
)


class DetectionHeadResult(NamedTuple):
    """One level's predictions, kept flat.

    raw: (B, H, W, A*(5+nc)) — channel blocks [box(A*4) | obj(A) | cls(A*nc)].
    """

    raw: torch.Tensor
    num_anchors: int
    num_classes: int

    @property
    def box(self) -> torch.Tensor:
        """(B, H, W, A, 4) logical view."""
        A = self.num_anchors
        b, h, w, _ = self.raw.shape
        return self.raw[..., : A * 4].reshape(b, h, w, A, 4)

    @property
    def obj(self) -> torch.Tensor:
        """(B, H, W, A, 1) logical view."""
        A = self.num_anchors
        b, h, w, _ = self.raw.shape
        return self.raw[..., A * 4 : A * 5].reshape(b, h, w, A, 1)

    @property
    def cls(self) -> torch.Tensor:
        """(B, H, W, A, nc) logical view."""
        A, nc = self.num_anchors, self.num_classes
        b, h, w, _ = self.raw.shape
        return self.raw[..., A * 5 :].reshape(b, h, w, A, nc)


class Yolov5NetworkResult(NamedTuple):
    ll: DetectionHeadResult  # stride 8
    ml: DetectionHeadResult  # stride 16
    hl: DetectionHeadResult  # stride 32

    def levels(self) -> Tuple[DetectionHeadResult, ...]:
        return (self.ll, self.ml, self.hl)


class Yolov5Backbone(nn.Module):
    """CSPDarknet (ref kod/nn/backbones/yolov5.py:85-131)."""

    def __init__(self, deepen_factor: float = 1.0, widen_factor: float = 1.0):
        super().__init__()
        md = partial(make_divisible, widen_factor=widen_factor)
        self.stages = stages = P5_STAGES
        # stem: 6x6 stride 2 pad 2 (ref backbones/yolov5.py:102-110)
        self.stem = ConvBnAct(3, md(stages[0].in_channels), 6, 2, padding=2)
        prev = md(stages[0].in_channels)
        for idx, cfg in enumerate(stages):
            name = f"stage{idx + 1}"
            out = md(cfg.out_channels)
            self.add_module(f"{name}_conv", ConvBnAct(prev, out, 3, 2))
            self.add_module(
                f"{name}_csp",
                CSPLayer(
                    out, out,
                    num_blocks=make_round(cfg.num_blocks, deepen_factor),
                    add_identity=cfg.add_identity,
                ),
            )
            if cfg.use_spp:
                self.add_module(f"{name}_sppf", SPPFBottleneck(out, out))
            prev = out

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        outs = []
        for idx, cfg in enumerate(self.stages):
            name = f"stage{idx + 1}"
            x = getattr(self, f"{name}_conv")(x)
            x = getattr(self, f"{name}_csp")(x)
            if cfg.use_spp:
                x = getattr(self, f"{name}_sppf")(x)
            outs.append(x)
        return outs  # 4 stage outputs; network uses the last 3


class Yolov5PAFPN(nn.Module):
    """PANet feature pyramid over P3/P4/P5 (ref kod/nn/necks/yolov5_pafpn.py).

    Topology: 1x1 reduce on topmost; top-down nearest-2x upsample + concat +
    CSP(no identity) with an extra 1x1 lateral reduce after the P4 merge;
    bottom-up 3x3/s2 downsample + concat + CSP.
    """

    def __init__(
        self,
        in_channels_list: Sequence[int],
        deepen_factor: float = 1.0,
        widen_factor: float = 1.0,
    ):
        super().__init__()
        md = partial(make_divisible, widen_factor=widen_factor)
        nb = make_round(3, deepen_factor)  # 3 blocks per CSP (ref yolov5_pafpn.py)
        csp = partial(CSPLayer, num_blocks=nb, add_identity=False)
        chs = list(in_channels_list)
        n = self.n = len(chs)

        # reduce: 1x1 only on the topmost level (ref yolov5_pafpn.py:56-75)
        self.reduce_top = ConvBnAct(md(chs[-1]), md(chs[-2]), 1)

        # top-down (ref yolov5_pafpn.py:177-191)
        inner_ch = md(chs[-2])
        for idx in range(n - 1, 0, -1):
            self.add_module(
                f"top_down_csp{idx}", csp(inner_ch + md(chs[idx - 1]), md(chs[idx - 1]))
            )
            inner_ch = md(chs[idx - 1])
            if idx != 1:
                # extra 1x1 lateral reduce (ref make_top_down_layer idx!=1)
                self.add_module(
                    f"top_down_reduce{idx}", ConvBnAct(inner_ch, md(chs[idx - 2]), 1)
                )
                inner_ch = md(chs[idx - 2])

        # bottom-up (ref yolov5_pafpn.py:193-200); the inner level idx+1 has
        # md(chs[idx]) channels (after its lateral reduce) except the top one
        for idx in range(n - 1):
            inner_next = md(chs[-2]) if idx + 1 == n - 1 else md(chs[idx])
            self.add_module(f"downsample{idx}", ConvBnAct(md(chs[idx]), md(chs[idx]), 3, 2))
            self.add_module(
                f"bottom_up_csp{idx}", csp(md(chs[idx]) + inner_next, md(chs[idx + 1]))
            )

    def forward(self, feats: Sequence[torch.Tensor]):
        n = self.n
        reduce_outs = list(feats)
        reduce_outs[-1] = self.reduce_top(feats[-1])

        inner = [reduce_outs[-1]]
        for idx in range(n - 1, 0, -1):
            up = upsample_nearest_2x(inner[0])
            cat = torch.cat([up, reduce_outs[idx - 1]], dim=1)
            y = getattr(self, f"top_down_csp{idx}")(cat)
            if idx != 1:
                y = getattr(self, f"top_down_reduce{idx}")(y)
            inner.insert(0, y)

        outs = [inner[0]]
        for idx in range(n - 1):
            down = getattr(self, f"downsample{idx}")(outs[-1])
            cat = torch.cat([down, inner[idx + 1]], dim=1)
            outs.append(getattr(self, f"bottom_up_csp{idx}")(cat))
        return tuple(outs)


def head_bias_priors(num_classes: int, stride: int):
    """(obj_add, cls_add) yv5 prior offsets of the head bias (ref heads/yolov5.py:66,114).

    obj += log(8/(640/stride)^2), cls += log(0.6/(nc-0.99999)). The JAX head's
    RetinaNet-style alternative has no caller and is not ported.
    """
    obj_add = math.log(8.0 / (640.0 / stride) ** 2)
    cls_add = math.log(0.6 / (num_classes - 0.99999))
    return obj_add, cls_add


class Yolov5Head(nn.Module):
    """Box(4A), obj(A), cls(nc*A) 1x1 convs as one conv (ref heads/yolov5.py:139-178)."""

    def __init__(self, in_channels: int, num_anchors_per_cell: int, num_classes: int,
                 stride: int):
        super().__init__()
        self.num_anchors = num_anchors_per_cell
        self.num_classes = num_classes
        self.stride = stride
        self.conv = nn.Conv2d(in_channels, num_anchors_per_cell * (5 + num_classes), 1)

    def forward(self, x: torch.Tensor) -> DetectionHeadResult:
        raw = conv2d(x, self.conv)  # kernel and bias in x's dtype
        return DetectionHeadResult(
            raw=raw.permute(0, 2, 3, 1),  # NHWC view of the channels_last map
            num_anchors=self.num_anchors,
            num_classes=self.num_classes,
        )


class Yolov5Network(nn.Module):
    """Full detector (ref kod/nn/networks/yolov5.py:40-108).

    Size variants via deepen/widen factors:
      n: 0.33/0.25, s: 0.33/0.50 (ref configs/experiment/yv5{n,s}.yaml),
      m: 0.67/0.75, l: 1.0/1.0 (upstream YOLOv5 convention).
    """

    def __init__(
        self,
        num_classes: int,
        num_anchors_per_cell: int = ANCHORS_PER_CELL,
        widen_factor: float = 1.0,
        deepen_factor: float = 1.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.spatial = None  # set by set_spatial: images are bands of rows, heads gathered whole
        md = partial(make_divisible, widen_factor=widen_factor)
        self.backbone = Yolov5Backbone(deepen_factor=deepen_factor, widen_factor=widen_factor)
        in_chs = tuple(s.out_channels for s in P5_STAGES[1:])
        self.neck = Yolov5PAFPN(
            in_channels_list=in_chs, deepen_factor=deepen_factor, widen_factor=widen_factor
        )
        for name, ch, stride in zip(("ll_head", "ml_head", "hl_head"), in_chs, (8, 16, 32)):
            self.add_module(name, Yolov5Head(md(ch), num_anchors_per_cell, num_classes, stride))

    def forward(self, images: torch.Tensor) -> Yolov5NetworkResult:
        """(B, H, W, 3) images -> three heads' (B, H/s, W/s, A*(5+nc)) raw maps;
        spatially sharded, (B, H/M, W, 3) bands -> the whole maps."""
        x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last strides
        if self.dtype is not None:
            x = x.to(self.dtype)
        _, c3, c4, c5 = self.backbone(x)  # stage1 output discarded
        p3, p4, p5 = self.neck([c3, c4, c5])
        heads = (self.ll_head(p3), self.ml_head(p4), self.hl_head(p5))
        if self.spatial is not None:
            heads = (h._replace(raw=self.spatial.gather_rows(h.raw, 1)) for h in heads)
        return Yolov5NetworkResult(*heads)


SIZE_VARIANTS = {
    "n": dict(deepen_factor=0.33, widen_factor=0.25),
    "s": dict(deepen_factor=0.33, widen_factor=0.50),
    "m": dict(deepen_factor=0.67, widen_factor=0.75),
    "l": dict(deepen_factor=1.0, widen_factor=1.0),
}


def init_weights(net: Yolov5Network, generator: torch.Generator) -> None:
    """The JAX package's init, drawn from ``generator`` (on the CPU).

    Conv kernels: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's Conv2d default
    == flax variance_scaling(1/3, fan_in, uniform)); BN scale 1, bias 0,
    mean 0, var 1; head biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) plus the
    obj / cls prior of ``head_bias_priors``. The numbers differ from
    ``jax.random``'s; the distributions are the same.
    """

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                bound = 1.0 / math.sqrt(fan_in)
                mod.weight.copy_(uniform(mod.weight.shape, bound))
                if mod.bias is not None:
                    mod.bias.copy_(uniform(mod.bias.shape, bound))
        for head in (net.ll_head, net.ml_head, net.hl_head):
            A, nc = head.num_anchors, head.num_classes
            obj_add, cls_add = head_bias_priors(nc, head.stride)
            head.conv.bias[A * 4 : A * 5] += obj_add
            head.conv.bias[A * 5 :] += cls_add


def build_network(
    num_classes: int,
    size: Union[str, Mapping[str, float]] = "s",
    num_anchors_per_cell: int = ANCHORS_PER_CELL,
    dtype: Optional[torch.dtype] = None,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> Yolov5Network:
    """A randomly initialised YOLOv5 (``seed``) on ``device``, channels_last.

    ``size`` names a variant of ``SIZE_VARIANTS`` or gives its factors,
    ``{"deepen_factor": d, "widen_factor": w}`` (``model.net`` of a config).

    Runs on CUDA unless ``device="cpu"`` is passed; raises if CUDA is asked
    for and there is no card.
    """
    dev = resolve_device(device)
    net = Yolov5Network(
        num_classes=num_classes,
        num_anchors_per_cell=num_anchors_per_cell,
        dtype=dtype,
        **(SIZE_VARIANTS[size] if isinstance(size, str) else dict(size)),
    )
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(device=dev, memory_format=torch.channels_last)
