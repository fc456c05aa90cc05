"""Every input of a run, made from its seed: the corpus's manifest and
targets, the corpus images on the card, the weights, the request pool.

The same seed gives the same inputs, on the card in a few large calls. The
program gets them through its public types; the reference gets the same
arrays, or makes them again from the seed after the program is gone.
"""

from __future__ import annotations

from datetime import datetime
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from reference.feed import FILL, content_size
from reference.network import YOLOv5, head_priors

STREAM_CORPUS, STREAM_WEIGHTS, STREAM_POOL, STREAM_PICK = 1, 2, 3, 4


def stream(seed: int, k: int) -> int:
    """The seed of input stream ``k`` of a run: distinct, deterministic and
    within a generator's 64 bits for any seed the driver gives."""
    return int(np.random.SeedSequence([int(seed) & (2**63 - 1), k]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, k: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, k))


class Manifest(NamedTuple):
    """The corpus's images (their original (h, w)) and targets, with the
    configuration's class names: ``assumed`` in the configuration file."""

    shapes: List[Tuple[int, int]]  # (h, w) of each original image
    boxes: List[np.ndarray]  # (n_i, 4) xyxy in original pixels
    labels: List[np.ndarray]  # (n_i,) class index
    classes: List[str]


def zipf_pmf(nc: int, a: float) -> np.ndarray:
    p = np.arange(1, nc + 1, dtype=np.float64) ** -a
    return p / p.sum()


def manifest(seed: int, n: int, size: int, nc: int, boxes_per_image: Tuple[int, int], zipf_a: float) -> Manifest:
    """``n`` images of sides in [size/2, 2 size), each with 1-9 boxes (an
    eighth to a half of each side) of classes drawn Zipf(``zipf_a``)."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 0])
    lo, hi = boxes_per_image
    wh = rng.integers(size // 2, size * 2, (n, 2))
    counts = rng.integers(lo, hi + 1, n)
    pmf = zipf_pmf(nc, zipf_a)
    shapes, boxes, labels = [], [], []
    for (w, h), k in zip(wh, counts):
        bw = rng.integers(max(w // 8, 2), max(w // 2, 3), k)
        bh = rng.integers(max(h // 8, 2), max(h // 2, 3), k)
        x1 = (rng.random(k) * np.maximum(w - bw, 1)).astype(np.int64)
        y1 = (rng.random(k) * np.maximum(h - bh, 1)).astype(np.int64)
        shapes.append((int(h), int(w)))
        boxes.append(np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32))
        labels.append(rng.choice(nc, size=k, p=pmf).astype(np.int64))
    return Manifest(shapes, boxes, labels, [f"class_{i}" for i in range(nc)])


def dataset_info(m: Manifest, name: str = "bench"):
    """The manifest as the program's ``DatasetInfo``."""
    from object_detection_cib_torch.data.cache import DatasetInfo, ImageMetadata, SampleInfo, TargetInfo, XYXYBox

    samples = []
    for i, ((h, w), b, lab) in enumerate(zip(m.shapes, m.boxes, m.labels)):
        targets = [TargetInfo(XYXYBox(*map(float, bb)), m.classes[int(c)]) for bb, c in zip(b, lab)]
        samples.append(SampleInfo(f"{name}-{i}", f"{name}/{i:05d}.jpg", ImageMetadata(int(w), int(h), 3, "image/jpeg", 0),
                                  targets))
    return DatasetInfo(name=name, date=datetime(2020, 1, 1), classes=list(m.classes), samples=samples)


def corpus(seed: int, m: Manifest, size: int, device, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The corpus on ``device``: planar (N, 3, S, S) uint8 rows, random
    content in each image's top-left content window and FILL elsewhere
    (what the letterbox leaves), and the (N, 2) int32 content sizes."""
    n = len(m.shapes)
    sizes = torch.tensor([content_size(h, w, size) for h, w in m.shapes], dtype=torch.int32)
    gen = generator(seed, STREAM_CORPUS, device)
    images = torch.empty((n, 3, size, size), dtype=torch.uint8, device=device)
    pos = torch.arange(size, device=device)
    dev_sizes = sizes.to(device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows = torch.randint(0, 256, (hi - lo, 3, size, size), generator=gen, device=device, dtype=torch.uint8)
        h, w = dev_sizes[lo:hi, 0], dev_sizes[lo:hi, 1]
        inside = (pos[None, :, None] < h[:, None, None]) & (pos[None, None, :] < w[:, None, None])
        images[lo:hi] = torch.where(inside[:, None], rows, torch.full((), int(FILL), dtype=torch.uint8, device=device))
    return images, dev_sizes


def of_config(seed: int, cfg: dict, device) -> Dict[str, torch.Tensor]:
    """``weights`` of a configuration, with its assumed scales."""
    a = cfg["assumed"]
    return weights(seed, cfg["nc"], cfg["deepen_factor"], cfg["widen_factor"], device, a["batchnorm_scale"],
                   a["head_scale"])


def weights(seed: int, nc: int, deepen: float, widen: float, device, bn_scale: float = 1.0,
            head_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The network's f32 state, drawn on ``device`` in one call: conv
    kernels and head biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the head
    kernels times ``head_scale``, YOLOv5's obj / cls priors on the head
    biases; BatchNorm scale ``bn_scale``, shift 0, running mean 0, running
    variance 1."""
    net = YOLOv5(nc, deepen, widen).to("meta")
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
    for prefix in ("ll_head", "ml_head", "hl_head"):
        head = getattr(net, prefix)
        A, (obj_add, cls_add) = head.anchors, head_priors(nc, head.stride)
        out[f"{prefix}.conv.weight"] *= head_scale
        b = out[f"{prefix}.conv.bias"]
        b[A * 4:A * 5] += obj_add
        b[A * 5:] += cls_add
    return out


def pool(seed: int, n: int, size: int, device) -> torch.Tensor:
    """``n`` uint8 (S, S, 3) request images, made on ``device`` and held in
    pinned host memory (plain host memory without a card)."""
    img = torch.randint(0, 256, (n, size, size, 3), generator=generator(seed, STREAM_POOL, device), device=device,
                        dtype=torch.uint8)
    host = torch.empty(img.shape, dtype=torch.uint8, pin_memory=torch.device(device).type == "cuda")
    host.copy_(img)
    return host


def calibrated(state: Dict[str, torch.Tensor], nc: int, deepen: float, widen: float,
               images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``state`` with each BatchNorm's running statistics set to the batch
    statistics of ``images`` ((B, S, S, 3) in [0, 1]) in the float32
    reference: random weights whose eval-mode activations neither vanish
    nor blow up, so that every image's detections carry information."""
    from reference import plain_math
    from reference.network import BatchNorm

    net = YOLOv5(nc, deepen, widen).to(images.device)
    net.load_state_dict(state)
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 1.0
    with plain_math(), torch.no_grad():
        net.train()(images)
    return {k: v.detach().clone() for k, v in net.state_dict().items()}
