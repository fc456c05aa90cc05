"""DP x SP spatial sharding: the row halo of a band of image rows, and the
gather of the heads' maps over the model axis.

The JAX package shards the image height over its mesh's ``model`` axis
(``jit_train_step(spatial=True)``) and GSPMD inserts the halo exchanges that
let each device's convs and pools read the rows beyond its band. The port
writes them by hand. A rank of a ``(data, model)`` mesh
(``parallel/mesh.py``) holds band ``m`` of ``M``, rows ``[m H / M, (m + 1) H
/ M)`` of its data rows' images. Before a conv of kernel ``k``, stride ``s``
and padding ``p`` (the band's first row a multiple of ``s``) it needs
``conv_reach(k, s, p) = (p, k - s - p)`` rows above and below its band:
the stem (6/2/2) 2 and 2, every 3x3/2 1 and 0, every 3x3/1 1 and 1, each
5x5/1 pool of SPPF 2 and 2; 1x1 convs, the upsample and the concats read
no row beyond the band (each pyramid level's band is twice the next
coarser level's). ``Spatial.exchange`` is that exchange as an autograd
function:

* forward: this band's top ``below`` rows go to the model neighbour above
  (they are the rows it reads below its own band) and its bottom ``above``
  rows to the one below; the rows received come back as ``[halo_above, x,
  halo_below]`` along H, a new ``channels_last`` tensor (cuDNN's NHWC path).
  At the image's true top and bottom edges the halo is padding instead: 0
  for a conv, the dtype's lowest value for a max pool (JAX
  ``models/layers.py:309-320``); the layer then runs with no H padding;
* backward: the gradient of each received halo goes back to the rank that
  owns those rows and is added into its edge rows; the padding's gradient
  is dropped.

``Spatial.gather_rows`` puts a head's map back together over the model
axis (JAX ``head_sharding``, ``train/steps.py:148-155``), so the assigner
and the loss see the whole map of their data rows. Every model rank then
computes the same loss, so its backward hands this rank its own slice of
the map's gradient: a backward that summed over the model ranks (as
``torch.distributed.nn.functional.all_gather``'s does) would make every
gradient ``M`` times too large (``tests/test_torch_spatial.py``).

Transport. Under NCCL the halos move by ``dist.batch_isend_irecv`` over the
model group (one coalesced launch of the sends and receives) and the gather
by ``dist.all_gather``, tensors on the card. Gloo moves no CUDA tensor
point to point, so a gloo group whose ranks are on a card (several ranks
sharing one, as ``chip_smoke.py``'s one-card phases run them) stages both
through the CPU: a copy to the host, the gloo transfer, a copy back. That is
a test set-up's path, chosen over ``all_gather`` (which gloo takes on CUDA
tensors) because the one point-to-point code then serves both backends; a
gloo group on the CPU sends its tensors as they are.

The exchange is issued in the same order on every model rank: every band
runs the same layers on tensors of one shape, and the autograd engine
walks identical graphs in one order. A layer rematerialised by
``models/layers.py:Remat`` exchanges its halo outside the checkpoint region,
so its recompute reads the halo'd tensor that the region saved as its input
and sends nothing. ``HaloCounts`` counts what this process issued.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


def conv_reach(kernel: int, stride: int, padding: int) -> Tuple[int, int]:
    """(rows above, rows below) a band that a conv or pool of this kernel,
    stride and padding reads, the band starting at a multiple of the stride."""
    return padding, kernel - stride - padding


class Spatial(NamedTuple):
    """This rank's place on the model axis: band ``rank`` of ``size``, over
    ``group``, whose ranks in band order are ``peers`` (global ranks)."""

    size: int
    rank: int
    group: "dist.ProcessGroup"
    peers: Tuple[int, ...]
    staged: bool  # gloo: move CUDA tensors through the CPU

    def exchange(self, x: torch.Tensor, above: int, below: int, fill: float = 0.0) -> torch.Tensor:
        """``x`` (N, C, h, W), this band, with ``above`` rows of the band
        above and ``below`` of the band below (``fill`` at the image's
        edges): (N, C, above + h + below, W), channels_last."""
        return _HaloExchange.apply(x, self, above, below, fill)

    def gather_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every band's ``x`` concatenated along ``dim`` in band order; the
        backward gives this band its own slice of the gradient."""
        return _GatherBands.apply(x, self, dim)


def spatial_of(mesh) -> Optional[Spatial]:
    """The ``Spatial`` of a mesh with a model axis; None without one."""
    if mesh is None or mesh.model_size == 1:
        return None
    first = mesh.rank * mesh.model_size
    return Spatial(mesh.model_size, mesh.model_rank, mesh.model_group,
                   tuple(range(first, first + mesh.model_size)), mesh.backend == "gloo")


class HaloCounts:
    """What this process's halo exchanges issued, forward and backward (an
    observation, as ``all_reduce_sum_.calls`` is)."""

    calls = 0  # batches of sends and receives
    bytes_sent = 0


def _swap(sp: Spatial, sends: Dict[int, torch.Tensor], recvs: Dict[int, tuple],
          like: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Send ``sends[band]`` to each band and receive a tensor of shape
    ``recvs[band]`` from each, all at once; the received tensors by band."""
    staged = sp.staged and like.is_cuda
    wire = torch.device("cpu") if staged else like.device
    bufs = {b: torch.empty(shape, dtype=like.dtype, device=wire) for b, shape in recvs.items()}
    ops = [dist.P2POp(dist.irecv, buf, sp.peers[b], sp.group) for b, buf in bufs.items()]
    for b, t in sends.items():
        t = t.contiguous().to(wire)
        HaloCounts.bytes_sent += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t, sp.peers[b], sp.group))
    if ops:
        HaloCounts.calls += 1
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return {b: buf.to(like.device) for b, buf in bufs.items()}


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp: Spatial, above: int, below: int, fill: float):
        N, C, h, W = x.shape
        if above > h or below > h:
            raise ValueError(f"a halo of {above} rows above and {below} below does not fit in a band of {h} rows")
        up = sp.rank - 1 if sp.rank > 0 else None
        down = sp.rank + 1 if sp.rank < sp.size - 1 else None
        sends, recvs = {}, {}
        if up is not None and below:
            sends[up] = x[:, :, :below]
        if down is not None and above:
            sends[down] = x[:, :, h - above:]
        if up is not None and above:
            recvs[up] = (N, C, above, W)
        if down is not None and below:
            recvs[down] = (N, C, below, W)
        got = _swap(sp, sends, recvs, x)
        out = torch.empty((N, C, above + h + below, W), dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        out[:, :, above:above + h] = x
        if above:
            out[:, :, :above] = got[up] if up is not None else fill
        if below:
            out[:, :, above + h:] = got[down] if down is not None else fill
        ctx.sp, ctx.above, ctx.below, ctx.h, ctx.up, ctx.down = sp, above, below, h, up, down
        return out

    @staticmethod
    def backward(ctx, g):
        sp, above, below, h, up, down = ctx.sp, ctx.above, ctx.below, ctx.h, ctx.up, ctx.down
        N, C, _, W = g.shape
        dx = g[:, :, above:above + h].clone(memory_format=torch.channels_last)
        sends, recvs = {}, {}
        if up is not None and above:
            sends[up] = g[:, :, :above]  # rows the band above owns
        if down is not None and below:
            sends[down] = g[:, :, above + h:]
        if up is not None and below:
            recvs[up] = (N, C, below, W)  # the gradient of this band's top rows, read by the band above
        if down is not None and above:
            recvs[down] = (N, C, above, W)
        got = _swap(sp, sends, recvs, g)
        if up is not None and below:
            dx[:, :, :below] += got[up]
        if down is not None and above:
            dx[:, :, h - above:] += got[down]
        return dx, None, None, None, None


class _GatherBands(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp: Spatial, dim: int):
        staged = sp.staged and x.is_cuda
        part = x.contiguous().cpu() if staged else x.contiguous()
        parts = [torch.empty_like(part) for _ in range(sp.size)]
        dist.all_gather(parts, part, group=sp.group)
        ctx.sp, ctx.dim, ctx.rows = sp, dim, x.shape[dim]
        return torch.cat(parts, dim).to(x.device)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.sp.rank * ctx.rows, ctx.rows), None, None
