"""The rank layout of data parallelism, and each rank's rows of a batch.

Counterpart of ``object_detection_cib_tpu/parallel/mesh.py``. The JAX
package builds a ``(data, model)`` device mesh in one program per host: the
batch is sharded over ``data``, XLA inserts the gradient all-reduce and
computes BatchNorm statistics over the global batch. The port runs one
process per card (``parallel/distributed.py:launch``), and a ``DataMesh``
tells each process where it stands: ``size`` ranks on the data axis over
``hosts`` hosts of ``local_size`` ranks each, this one ``rank`` (``host *
local_size + local_rank``), its card, and the process group its collectives
go over. JAX's "process" is the port's host, and JAX's local devices are
that host's ranks; a rank's card is its local rank. The collectives
themselves are written where the JAX package leaves them to XLA: the
BatchNorm statistics (``models/layers.py``), the loss's denominators
(``train/loss.py``), the gradient bucket (``train/steps.py``), the sharded
corpus's exchange (``data/device_pipeline.py``) and the mAP merge
(``eval/coco_map.py``).

``group`` None is one process with no collectives: the single-card path.
A ``DataMesh`` with a group of one rank runs every collective (on one card
under NCCL they are captured in the fused epoch's CUDA graph like any other
work). ``hosts`` 1 is the one-host mesh. The ``model`` axis (DP x SP
spatial sharding, JAX ``jit_train_step(spatial=True)``) is not ported:
``num_model > 1`` raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.distributed as dist


class DataMesh(NamedTuple):
    """``size`` ranks on the data axis over ``hosts`` hosts; this process is
    ``rank``, on ``device``."""

    size: int
    rank: int
    device: torch.device
    group: Optional["dist.ProcessGroup"] = None  # None: one process, no collectives
    backend: Optional[str] = None  # "nccl" or "gloo" under a group
    hosts: int = 1  # hosts the ranks are spread over, local_size ranks each

    @property
    def local_size(self) -> int:
        """Ranks on each host."""
        return self.size // self.hosts

    @property
    def host(self) -> int:
        """This rank's host (JAX's ``process_index``)."""
        return self.rank // self.local_size

    @property
    def local_rank(self) -> int:
        """This rank on its host: the index of its card there."""
        return self.rank % self.local_size

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device: Union[str, torch.device, None] = None, hosts: int = 1) -> DataMesh:
    """The rank layout of this process (JAX ``make_mesh``).

    In a process of a group (``torch.distributed`` initialised, as
    ``parallel.distributed.launch`` does for each rank) the data axis is
    the whole group, spread over ``hosts`` hosts, and ``num_data`` None or
    its size; without one it is this process alone, and ``num_data`` None
    or 1. ``device`` defaults to the current card and raises where there is
    none: the CPU is taken only when asked for (``device="cpu"``).
    """
    if num_model != 1:
        raise NotImplementedError(f"num_model={num_model}: DP x SP spatial sharding (JAX jit_train_step("
                                  "spatial=True)) is not ported, ROADMAP A")
    joined = dist.is_available() and dist.is_initialized()
    size = dist.get_world_size() if joined else 1
    if num_data not in (None, size):
        raise ValueError(f"num_data={num_data} but the process group has {size} ranks" if joined else
                         f"num_data={num_data} needs {num_data} ranks: launch them with "
                         "object_detection_cib_torch.parallel.distributed.launch")
    if hosts < 1 or size % hosts:
        raise ValueError(f"{size} ranks do not spread evenly over {hosts} hosts")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device=None) takes the current card, and torch.cuda.is_available() "
                               "is False; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if joined:
        return DataMesh(size, dist.get_rank(), device, dist.group.WORLD, dist.get_backend(), hosts)
    return DataMesh(1, 0, device)


def batch_sharding(mesh: Optional[DataMesh], global_rows: int) -> slice:
    """This rank's rows ``[r * n / N, (r + 1) * n / N)`` of a leading axis of
    ``global_rows`` over every rank (JAX ``batch_sharding``: ``P("data")``).
    Raises unless the rows divide evenly over the ranks."""
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    return _share(global_rows, size, rank, "ranks")


def host_batch_sharding(mesh: Optional[DataMesh], host_rows: int) -> slice:
    """This rank's rows of a leading axis of ``host_rows`` that its host
    feeds (JAX: a host's batch over its local devices): by ``local_rank``
    over ``local_size``. Over one host it is ``batch_sharding``."""
    size, rank = (1, 0) if mesh is None else (mesh.local_size, mesh.local_rank)
    return _share(host_rows, size, rank, "ranks of a host")


def _share(rows: int, size: int, rank: int, what: str) -> slice:
    if rows % size:
        raise ValueError(f"{rows} rows do not divide over {size} {what}")
    per = rows // size
    return slice(rank * per, (rank + 1) * per)


def shard_batch_pytree(batch, mesh: Optional[DataMesh]):
    """This rank's rows of every leaf of a global batch (a tensor, or a
    tuple of them, ``NamedTuple``s included; None leaves stay None)."""
    if batch is None:
        return None
    if isinstance(batch, tuple):
        leaves = [shard_batch_pytree(t, mesh) for t in batch]
        return type(batch)(*leaves) if hasattr(batch, "_fields") else type(batch)(leaves)
    return batch[batch_sharding(mesh, batch.shape[0])]
