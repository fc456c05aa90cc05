"""The rank layout of data parallelism, and each rank's rows of a global batch.

Counterpart of ``object_detection_cib_tpu/parallel/mesh.py``. The JAX
package builds a ``(data, model)`` device mesh in one program: the batch is
sharded over ``data``, XLA inserts the gradient all-reduce and computes
BatchNorm statistics over the global batch. The port runs one process per
card (``parallel/distributed.py:launch``), and a ``DataMesh`` tells each
process where it stands: ``size`` ranks on the data axis, this one
``rank``, its card, and the process group its collectives go over. The
collectives themselves are written where the JAX package leaves them to
XLA: the BatchNorm statistics (``models/layers.py``), the loss's
denominators (``train/loss.py``), the gradient bucket (``train/steps.py``),
the sharded corpus's exchange (``data/device_pipeline.py``) and the mAP
merge (``eval/coco_map.py``).

``group`` None is one process with no collectives: the single-card path.
A ``DataMesh`` with a group of one rank runs every collective (on one card
under NCCL they are captured in the fused epoch's CUDA graph like any other
work). The ``model`` axis (DP x SP spatial sharding, JAX
``jit_train_step(spatial=True)``) is a later slice: ``num_model > 1``
raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.distributed as dist


class DataMesh(NamedTuple):
    """``size`` ranks on the data axis; this process is ``rank``, on ``device``."""

    size: int
    rank: int
    device: torch.device
    group: Optional["dist.ProcessGroup"] = None  # None: one process, no collectives
    backend: Optional[str] = None  # "nccl" or "gloo" under a group

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device: Union[str, torch.device, None] = None) -> DataMesh:
    """The rank layout of this process (JAX ``make_mesh``).

    In a process of a group (``torch.distributed`` initialised, as
    ``parallel.distributed.launch`` does for each rank) the data axis is
    the whole group and ``num_data`` None or its size; without one it is
    this process alone, and ``num_data`` None or 1. ``device`` defaults to
    the current card, or the CPU where there is none.
    """
    if num_model != 1:
        raise NotImplementedError(f"num_model={num_model}: DP x SP spatial sharding (JAX jit_train_step("
                                  "spatial=True)) is a later slice of the port, ROADMAP A")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size()
        if num_data not in (None, size):
            raise ValueError(f"num_data={num_data} but the process group has {size} ranks")
        return DataMesh(size, dist.get_rank(), device, dist.group.WORLD, dist.get_backend())
    if num_data not in (None, 1):
        raise ValueError(f"num_data={num_data} needs {num_data} ranks: launch them with "
                         "object_detection_cib_torch.parallel.distributed.launch")
    return DataMesh(1, 0, device)


def batch_sharding(mesh: Optional[DataMesh], global_rows: int) -> slice:
    """This rank's rows ``[r * n / N, (r + 1) * n / N)`` of a leading axis of
    ``global_rows`` (JAX ``batch_sharding``: ``P("data")``). Raises unless
    the rows divide evenly over the ranks."""
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if global_rows % size:
        raise ValueError(f"{global_rows} rows do not divide over {size} ranks")
    per = global_rows // size
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
