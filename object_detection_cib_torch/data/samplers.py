"""Imbalance-aware index samplers (host-side, numpy).

A copy of ``object_detection_cib_tpu/data/samplers.py``: the same seed gives
the same index stream, number for number.

Capability parity: kod/data/samplers.py:17-138 —
  * RandomCycleSampler: infinite shuffled-cycle iterator
  * ClassAwareSampler: round-robin over a shuffled class cycle, drawing the
    next image from that class's shuffled image cycle (algorithm per the
    reference README "class-aware sampling" section)
  * RepeatFactorSampler: r_c = max(1, t/f_c) (sqrt option), image factor =
    mean or max over its instances, weighted sampling with replacement
    (fixed seed 2023, ref samplers.py:131-132)

``shard_indices(indices, host_id, num_hosts)`` is the interleaved per-process
view of an epoch's index stream for data-parallel runs (the
DistributedSampler analog); the port's pipeline is one process and does not
call it yet.

Both samplers expose the duck-typed attributes the dataset couples to
(ref detection.py:78-80,114-116): ``sampler_indices`` (class-aware) and
``image_repeat_factors`` (repeat-factor) for mosaic co-sampling.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np

from object_detection_cib_torch.data.cache import DatasetInfo


class RandomCycleSampler:
    """Infinite iterator over `data`, reshuffled every full pass."""

    def __init__(self, data: Sequence[int], rng: Optional[np.random.Generator] = None):
        self.data = list(data)
        self.rng = rng if rng is not None else np.random.default_rng()
        self._perm = self.rng.permutation(len(self.data))
        self._pos = 0

    def __iter__(self):
        return self

    def __len__(self) -> int:
        return len(self.data)

    def __next__(self) -> int:
        if self._pos == len(self.data):
            self._perm = self.rng.permutation(len(self.data))
            self._pos = 0
        idx = self.data[int(self._perm[self._pos])]
        self._pos += 1
        return idx


class ClassAwareSampler:
    """Uniform-over-classes sampling (ref samplers.py:41-77)."""

    def __init__(self, dataset_info: DatasetInfo, seed: Optional[int] = None):
        self.dataset_info = dataset_info
        rng = np.random.default_rng(seed)
        img_ids = [s.id for s in dataset_info.samples]
        id_to_index = {x: i for i, x in enumerate(img_ids)}

        self.per_class_cycles: dict = {}
        populated = []
        for ci, cname in enumerate(dataset_info.classes):
            members = dataset_info.filter(cname, [cname]).samples
            if not members:  # classes with zero instances can't be drawn
                continue
            populated.append(ci)
            self.per_class_cycles[ci] = RandomCycleSampler(
                [id_to_index[s.id] for s in members], rng
            )
        self.class_cycle = RandomCycleSampler(populated, rng)
        self.sampler_indices: List[int] = list(range(len(dataset_info.samples)))

    def __len__(self) -> int:
        return len(self.dataset_info.samples)

    def __iter__(self) -> Iterator[int]:
        indices: List[int] = []
        while len(indices) < len(self.dataset_info.samples):
            ci = next(self.class_cycle)
            indices.append(next(self.per_class_cycles[ci]))
        self.sampler_indices = indices
        return iter(indices)

    def epoch_indices(self) -> np.ndarray:
        return np.asarray(list(iter(self)), np.int64)


class RepeatFactorSampler:
    """LVIS-style repeat-factor sampling (ref samplers.py:80-138)."""

    def __init__(
        self,
        dataset_info: DatasetInfo,
        reduction: Optional[str] = None,
        threshold: float = 1.0,
        use_sqrt: bool = True,
        seed: int = 2023,  # ref samplers.py:131-132
    ):
        self.dataset_info = dataset_info
        counts = dataset_info.get_instance_count()
        total = sum(counts.values())
        freq = {k: v / total for k, v in counts.items()}
        rc = {k: max(1.0, threshold / freq[k]) for k in dataset_info.classes}
        if use_sqrt:
            rc = {k: math.sqrt(v) for k, v in rc.items()}
        self.class_repeat_factor = rc

        factors: List[float] = []
        for s in dataset_info.samples:
            acc, mx = 0.0, 0.0
            for t in s.targets:
                acc += rc[t.class_name]
                mx = max(mx, rc[t.class_name])
            if reduction == "max":
                factors.append(mx)
            else:
                factors.append(acc / (len(s.targets) + 1e-6))
        self.image_repeat_factors = factors
        self._p = np.asarray(factors) / np.sum(factors)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset_info.samples)

    def __iter__(self) -> Iterator[int]:
        return iter(self.epoch_indices())

    def epoch_indices(self) -> np.ndarray:
        return self.rng.choice(
            len(self.dataset_info.samples),
            size=len(self.dataset_info.samples),
            replace=True,
            p=self._p,
        )


class ShuffleSampler:
    """Plain per-epoch shuffle (DataLoader(shuffle=True) equivalent)."""

    def __init__(self, dataset_info: DatasetInfo, seed: Optional[int] = None):
        self.n = len(dataset_info.samples)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[int]:
        return iter(self.epoch_indices())

    def epoch_indices(self) -> np.ndarray:
        return self.rng.permutation(self.n)


def shard_indices(indices: np.ndarray, host_id: int, num_hosts: int) -> np.ndarray:
    """Interleaved per-host shard of a global epoch index stream."""
    return np.asarray(indices)[host_id::num_hosts]


class FixedSampler:
    """Yield a fixed index sequence every epoch (per-host validation shards:
    the DistributedSampler(shuffle=False) analog for the eval path)."""

    def __init__(self, indices: np.ndarray):
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def epoch_indices(self) -> np.ndarray:
        return self.indices
