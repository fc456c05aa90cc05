"""Every input of a run, made from its seed: the corpus's manifest and
targets, the corpus images on the card, the request pool, and the streams
from which each network family draws its weights (``networks/``).

The same seed gives the same inputs, on the card in a few large calls. The
program gets them through its public types; the reference gets the same
arrays, or makes them again from the seed after the program is gone.
"""

from __future__ import annotations

from datetime import datetime
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from reference.feed import FILL, content_size

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


def pool(seed: int, n: int, size: int, device) -> torch.Tensor:
    """``n`` uint8 (S, S, 3) request images, made on ``device`` and held in
    pinned host memory (plain host memory without a card)."""
    img = torch.randint(0, 256, (n, size, size, 3), generator=generator(seed, STREAM_POOL, device), device=device,
                        dtype=torch.uint8)
    host = torch.empty(img.shape, dtype=torch.uint8, pin_memory=torch.device(device).type == "cuda")
    host.copy_(img)
    return host
