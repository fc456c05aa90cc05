"""Dataset orchestration + fixed-shape batching + a threaded feed: the host
pipeline (``data.pipeline=host``, the repo's default config).

A copy of ``object_detection_cib_tpu/data/pipeline.py`` (capability parity:
kod/data/detection.py:40-156 — mosaic co-sampling, RAM cache, mixup as a
second mosaic — and kod/lightning/data_module.py:24-174 — loaders,
collate). The same seed gives the same samples:

  * ``DetectionDataset``: reader + mosaic + augmentor (+ mixup) per item,
    numpy and cv2 on the host; extra mosaic indices are drawn from the
    sampler's ``sampler_indices`` weighted by ``image_repeat_factors``
    (ref detection.py:112-123) by ``random.Random.choices``;
  * ``collate_fixed`` pads targets to a static capacity and returns the
    port's ``Batch`` as torch tensors with uint8 HWC images; ``upload``
    normalizes them on the device (``utils/device.py:to_unit``), bitwise
    the f32 division the JAX package does on the host, at a quarter of the
    traffic;
  * ``Prefetcher``: worker threads and a bounded queue. Batches are
    collated into pinned host memory (on a machine with a card) and copied
    to ``device`` without blocking the host; torch's pinned allocator hands
    a buffer out again only after its copy has ended.

The dataset shares one ``rng`` and one ``pyrng`` across the Prefetcher's
worker threads, as in the JAX package, so its stream is reproducible with
``num_threads=1`` only. Not ported: ``shard_for_host`` (the multi-host
feed, ROADMAP A7).
"""

from __future__ import annotations

import queue
import random as pyrandom
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from object_detection_cib_torch.data.cache import DatasetInfo
from object_detection_cib_torch.data.host_augment import mixup, mosaic4
from object_detection_cib_torch.data.reader import AugmentedSample, SampleReader
from object_detection_cib_torch.train.steps import Batch
from object_detection_cib_torch.utils.device import resolve_device, to_unit
from object_detection_cib_torch.utils.threads import put_unless_stopped


class DetectionDataset:
    """Map-style dataset: reader + mosaic + augmentor (+mixup) per item."""

    def __init__(
        self,
        dataset_info: DatasetInfo,
        sample_reader: SampleReader,
        sample_augmentor: Callable,
        enable_ram_cache: bool = False,
        use_mosaic: bool = False,
        mosaic_target_size: Optional[int] = None,
        mixup_prob: float = 0.0,
        sampler=None,
        seed: int = 0,
    ):
        if mixup_prob > 0.0 and not use_mosaic:
            raise ValueError("mixup requires mosaic (ref detection.py:58-59)")
        self.dataset_info = dataset_info
        self.sample_reader = sample_reader
        self.sample_augmentor = sample_augmentor
        self.use_mosaic = use_mosaic
        self.mosaic_target_size = mosaic_target_size
        self.mixup_prob = mixup_prob
        self.sampler = sampler
        self.rng = np.random.default_rng(seed)
        self.pyrng = pyrandom.Random(seed)

        self._cache: List[Optional[AugmentedSample]] = [None] * len(
            dataset_info.samples
        )
        self.enable_ram_cache = enable_ram_cache
        if enable_ram_cache:
            # pre-resized, letterboxed only when mosaic won't run
            # (ref detection.py:66-76)
            for i, s in enumerate(dataset_info.samples):
                self._cache[i] = self.sample_reader(s, not use_mosaic)

        self.image_repeat_factors = getattr(sampler, "image_repeat_factors", None)

    def __len__(self) -> int:
        return len(self.dataset_info.samples)

    @property
    def num_classes(self) -> int:
        return len(self.dataset_info.classes)

    def _read(self, i: int) -> AugmentedSample:
        if self.enable_ram_cache and self._cache[i] is not None:
            return self._cache[i]
        return self.sample_reader(self.dataset_info.samples[i], not self.use_mosaic)

    def _co_indices(self, k: int) -> List[int]:
        pool = getattr(self.sampler, "sampler_indices", None)
        if pool is None:
            pool = range(len(self.dataset_info.samples))
        return self.pyrng.choices(pool, k=k, weights=self.image_repeat_factors)

    def __getitem__(self, idx: int) -> AugmentedSample:
        if not self.use_mosaic:
            return self.sample_augmentor(self._read(idx))

        indices = [idx] + self._co_indices(3)
        self.pyrng.shuffle(indices)
        sample, border = mosaic4(
            [self._read(i) for i in indices], self.mosaic_target_size, self.rng
        )
        sample = self.sample_augmentor(sample, border)

        if self.pyrng.random() < self.mixup_prob:
            # second mosaic, blended in (ref detection.py:134-145)
            s2, border2 = mosaic4(
                [self._read(i) for i in self._co_indices(4)],
                self.mosaic_target_size,
                self.rng,
            )
            s2 = self.sample_augmentor(s2, border2)
            sample = mixup(sample, s2, self.rng)
        return sample


def collate_fixed(
    samples: Sequence[AugmentedSample], max_targets: int, pin_memory: bool = False
) -> Tuple[Batch, int]:
    """Stack images and pad targets to capacity -> (Batch, overflow).

    The Batch holds host tensors (pinned with ``pin_memory``): images
    (B, H, W, 3) uint8, boxes (B, T, 4) f32, labels (B, T) int32, mask
    (B, T) bool. Targets beyond ``max_targets`` are dropped and counted in
    ``overflow``.
    """
    B = len(samples)
    h, w = samples[0].image.shape[:2]

    def empty(shape, dtype):
        return torch.zeros(shape, dtype=dtype, pin_memory=pin_memory)

    batch = Batch(images=empty((B, h, w, 3), torch.uint8), boxes=empty((B, max_targets, 4), torch.float32),
                  labels=empty((B, max_targets), torch.int32), mask=empty((B, max_targets), torch.bool))
    images, boxes, labels, mask = (t.numpy() for t in batch)
    overflow = 0
    for i, s in enumerate(samples):
        if s.image.dtype != np.uint8:
            raise TypeError(f"sample {i}: image is {s.image.dtype}, the feed carries uint8")
        images[i] = s.image
        n = min(len(s.bboxes), max_targets)
        overflow += max(0, len(s.bboxes) - max_targets)
        if n:
            boxes[i, :n] = s.bboxes[:n]
            labels[i, :n] = s.labels[:n]
            mask[i, :n] = True
    return batch, overflow


def upload(batch: Batch, device: torch.device, feed_dtype: torch.dtype = torch.float32) -> Batch:
    """A collated host batch on ``device``, images normalized there as
    ``to_unit`` (the JAX host division, bit for bit) and cast to
    ``feed_dtype``. The copy does not
    block the host where the batch is pinned."""
    images, *targets = (t.to(device, non_blocking=True) for t in batch)
    return Batch(to_unit(images).to(feed_dtype), *targets)


class Prefetcher:
    """Threaded batch producer with a bounded queue (double buffering).

    Yields ``Batch``es on ``device`` (images normalized, ``feed_dtype``), or
    with ``device=None`` the collated host batches (uint8 images, pinned on
    a machine with a card) for a caller that uploads them itself.
    ``overflow_total`` counts the targets dropped by ``max_targets``, and
    ``wait_seconds`` the host time the consumer spent waiting on the queue.
    With ``rows`` (a rank's rows of a global batch, ``parallel.mesh.
    batch_sharding``) each batch is made whole, from the whole seeded
    stream, and only those rows are yielded; ``overflow_total`` counts the
    whole batch's.
    """

    def __init__(
        self,
        dataset: DetectionDataset,
        batch_size: int,
        max_targets: int,
        sampler=None,
        num_threads: int = 8,
        prefetch: int = 2,
        drop_last: bool = True,
        device: Union[str, torch.device, None] = "cuda",
        feed_dtype: torch.dtype = torch.float32,
        rows: Optional[slice] = None,
    ):
        self.dataset = dataset
        self.rows = rows
        self.batch_size = batch_size
        self.max_targets = max_targets
        self.sampler = sampler
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device = None if device is None else resolve_device(device)
        self.feed_dtype = feed_dtype
        self.pin_memory = (self.device.type == "cuda" if self.device is not None
                           else torch.cuda.is_available())
        self.overflow_total = 0
        self.wait_seconds = 0.0
        # sampler-debug support: primary indices of each epoch actually
        # consumed, FIFO (mosaic co-samples are drawn inside the dataset's
        # __getitem__ and are not recorded here)
        self.consumed_plan_log: deque = deque(maxlen=8)

    def _epoch_indices(self) -> np.ndarray:
        if self.sampler is not None:
            return np.asarray(self.sampler.epoch_indices())
        return np.arange(len(self.dataset))

    def __len__(self) -> int:
        # samplers define the epoch length (repeat-factor/class-aware epochs
        # differ from the dataset size)
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        indices = self._epoch_indices()
        n_batches = len(indices) // self.batch_size
        if not self.drop_last and len(indices) % self.batch_size:
            n_batches += 1
        # per-step rows so the trainer can trim to batches actually
        # consumed (drop_last=False's final partial batch is not logged)
        full = len(indices) // self.batch_size
        self.consumed_plan_log.append(
            np.asarray(indices[: full * self.batch_size]).reshape(
                full, self.batch_size
            )
        )

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for bi in range(n_batches):
                        if stop.is_set():
                            return
                        chunk = indices[
                            bi * self.batch_size : (bi + 1) * self.batch_size
                        ]
                        samples = list(pool.map(self.dataset.__getitem__, chunk))
                        item = collate_fixed(samples, self.max_targets, self.pin_memory)
                        if not put_unless_stopped(q, item, stop):
                            return
            except Exception as e:  # surface worker errors to the consumer
                put_unless_stopped(q, e, stop)
            finally:
                put_unless_stopped(q, None, stop)

        t = threading.Thread(target=producer, daemon=True, name="prefetcher")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_seconds += time.perf_counter() - t0
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, ovf = item
                self.overflow_total += ovf  # counted as the batch is handed out
                if self.rows is not None:
                    batch = Batch(*(t[self.rows] for t in batch))
                yield batch if self.device is None else upload(batch, self.device, self.feed_dtype)
        finally:
            stop.set()
