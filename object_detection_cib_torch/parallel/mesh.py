"""The rank layout of data parallelism and of DP x SP spatial sharding, and
each rank's part of a batch.

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
work). ``hosts`` 1 is the one-host mesh.

The ``model`` axis (``make_mesh(num_data, num_model > 1)``; DP x SP spatial
sharding, JAX ``jit_train_step(spatial=True)``) lays the ranks out as JAX's
row-major grid ``devices.reshape(num_data, num_model)``: world rank ``r = d *
num_model + m``, so a rank's model neighbours are the ranks beside it. Each
rank then holds three groups: ``group``, the data group (the ranks of its
``m``; ``size`` and ``rank`` are its data axis), ``model_group`` (the ranks of
its ``d``; ``model_size``, ``model_rank``), over which the row halos
(``parallel/spatial.py``) and the heads' gather move, and ``world_group``,
every rank, over which the BatchNorm statistics and the gradient bucket are
summed (``world``). ``shard_batch_pytree(..., spatial=True)`` gives a rank
its data rows of every leaf and, of the images, its band of rows.

Which axis each reader means: every ``size``, ``rank`` and ``group`` in
``train/``, ``data/``, ``eval/`` and ``parallel/distributed.py`` is the data
axis (the loss's valid counts and image count, the compaction's prefix,
``cap`` and ``total`` in the train step, the corpus, the plans, the host
feed, validation, ``allgather_bytes``, ``barrier``, ``broadcast_module_``).
Only the BatchNorms and the gradient bucket of ``train/steps.py`` read
``world``. With ``model_size`` 1 the data group is the world and nothing
changes. A mesh with a model axis is taken by ``make_train_step`` alone,
as JAX's trainer never builds one: ``Trainer`` and ``DeviceDataPipeline``
refuse it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.distributed as dist


class DataMesh(NamedTuple):
    """``size`` ranks on the data axis over ``hosts`` hosts; this process is
    ``rank`` there, on ``device``; ``model_size`` ranks on the model axis,
    this one ``model_rank`` (module docstring)."""

    size: int
    rank: int
    device: torch.device
    group: Optional["dist.ProcessGroup"] = None  # the data group; None: one process, no collectives
    backend: Optional[str] = None  # "nccl" or "gloo" under a group
    hosts: int = 1  # hosts the ranks are spread over, local_size ranks each
    model_size: int = 1  # ranks on the model axis: the bands an image is cut into
    model_rank: int = 0  # this rank's band
    model_group: Optional["dist.ProcessGroup"] = None  # the ranks of this rank's images
    world_group: Optional["dist.ProcessGroup"] = None  # every rank, where model_size > 1

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
    def world(self):
        """The group of every rank: the data group where there is no model axis."""
        return self.group if self.world_group is None else self.world_group

    @property
    def world_rank(self) -> int:
        return self.rank * self.model_size + self.model_rank

    @property
    def is_main(self) -> bool:
        return self.world_rank == 0


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device: Union[str, torch.device, None] = None, hosts: int = 1) -> DataMesh:
    """The rank layout of this process (JAX ``make_mesh``).

    In a process of a group (``torch.distributed`` initialised, as
    ``parallel.distributed.launch`` does for each rank) the mesh is the
    whole group: ``num_model`` ranks on the model axis and ``num_data``
    (None: the rest) on the data axis, spread over ``hosts`` hosts; without
    one it is this process alone, and ``num_data`` None or 1, ``num_model``
    1. With ``num_model`` > 1 every rank creates every data and model group
    (``dist.new_group`` is collective: each in the same order on every rank)
    and keeps its own. ``device`` defaults to the current card and raises
    where there is none: the CPU is taken only when asked for
    (``device="cpu"``).
    """
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    if num_model < 1 or world % num_model:
        raise ValueError(f"num_model={num_model} does not divide the {world} ranks of the process group"
                         if joined else f"num_model={num_model} needs {num_model} ranks: launch them with "
                         "object_detection_cib_torch.parallel.distributed.launch")
    size = world // num_model
    if num_data not in (None, size):
        raise ValueError(f"num_data={num_data} x num_model={num_model} but the process group has {world} ranks"
                         if joined else
                         f"num_data={num_data} needs {num_data} ranks: launch them with "
                         "object_detection_cib_torch.parallel.distributed.launch")
    if hosts < 1 or size % hosts or (num_model > 1 and hosts != 1):
        raise ValueError(f"{size} ranks on the data axis do not spread evenly over {hosts} hosts" if num_model == 1
                         else f"a mesh with a model axis runs on one host, not {hosts}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device=None) takes the current card, and torch.cuda.is_available() "
                               "is False; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if not joined:
        return DataMesh(1, 0, device)
    backend, me = dist.get_backend(), dist.get_rank()
    if num_model == 1:
        return DataMesh(size, me, device, dist.group.WORLD, backend, hosts)
    d, m = divmod(me, num_model)
    data_group = model_group = None
    for j in range(num_model):  # the data groups, one per model rank
        g = dist.new_group([i * num_model + j for i in range(size)])
        data_group = g if j == m else data_group
    for i in range(size):  # the model groups, one per data rank
        g = dist.new_group([i * num_model + j for j in range(num_model)])
        model_group = g if i == d else model_group
    return DataMesh(size, d, device, data_group, backend, hosts, num_model, m, model_group, dist.group.WORLD)


def refuse_model_axis(mesh: Optional[DataMesh]) -> None:
    """Raise for a mesh with a model axis: the trainer and its pipelines run
    on the data axis alone, as the JAX trainer (which never builds a model
    axis); the spatial step is ``make_train_step``'s."""
    if mesh is not None and mesh.model_size > 1:
        raise ValueError(f"a mesh with a model axis of {mesh.model_size} ranks (DP x SP spatial sharding) is taken "
                         "by make_train_step alone; the trainer and its pipelines run on the data axis "
                         "(make_mesh(num_model=1)), as the JAX trainer does")


def batch_sharding(mesh: Optional[DataMesh], global_rows: int) -> slice:
    """This rank's rows ``[r * n / N, (r + 1) * n / N)`` of a leading axis of
    ``global_rows`` over the data axis (JAX ``batch_sharding``: ``P("data")``).
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


def band_sharding(mesh: Optional[DataMesh], height: int) -> slice:
    """This rank's band of ``height`` image rows, ``[m * H / M, (m + 1) * H
    / M)`` over the model axis (JAX ``P("data", "model")``'s second axis).
    Raises unless the rows divide evenly over the bands."""
    size, rank = (1, 0) if mesh is None else (mesh.model_size, mesh.model_rank)
    return _share(height, size, rank, "bands of the model axis")


def shard_batch_pytree(batch, mesh: Optional[DataMesh], spatial: bool = False):
    """This rank's rows of every leaf of a global batch (a tensor, or a
    tuple of them, ``NamedTuple``s included; None leaves stay None). With
    ``spatial``, ``batch`` has an ``images`` leaf (B, H, W, C), of which the
    rank gets its rows and its band of image rows; the other leaves get
    their rows only (JAX ``P("data", "model")`` against ``P("data")``)."""
    if batch is None:
        return None
    if spatial:
        rows = shard_batch_pytree(batch, mesh)
        return rows._replace(images=rows.images[:, band_sharding(mesh, rows.images.shape[1])])
    if isinstance(batch, tuple):
        leaves = [shard_batch_pytree(t, mesh) for t in batch]
        return type(batch)(*leaves) if hasattr(batch, "_fields") else type(batch)(leaves)
    return batch[batch_sharding(mesh, batch.shape[0])]
