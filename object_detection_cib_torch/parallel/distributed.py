"""Process groups, rank-zero guards, the collectives of the port, and the
launcher of one process per card.

Counterpart of ``object_detection_cib_tpu/parallel/distributed.py``. The
JAX package joins a pod with ``jax.distributed.initialize`` and lets one
SPMD program drive every chip of a host. The port runs one process per card
(the usual shape of PyTorch data parallelism): ``launch`` spawns ``N``
ranks, each of which selects its card before anything else, joins a
``torch.distributed`` group over a TCP store on this host (NCCL on the
card, gloo on the CPU, each with an explicit timeout; the store is served
by the launching process) and calls the given
function with its ``DataMesh``. A rank that fails ends ``launch`` with an
exception and stops the others; ``join_timeout_s`` bounds the whole run.

``initialize_multihost`` and ``maybe_initialize_from_env`` join a group as
the JAX functions do (the ``KOD_*`` variables); the trainer refuses a group
it was not launched into (joining from the environment, one process per
host over several hosts, is ROADMAP A's next slice).

The collectives go through ``all_reduce_sum_`` and ``reduce_scatter_sum``,
which count their calls (``.calls``) as an observation of what a step
issues; under a CUDA graph capture they count once, at capture.
"""

from __future__ import annotations

import functools
import gc
import os
import pickle
import queue
import time
import traceback
import warnings
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from object_detection_cib_torch.parallel.mesh import DataMesh, make_mesh

DEFAULT_TIMEOUT_S = 600.0  # a collective that waits longer raises
EXIT_GRACE_S = 120.0  # a rank's time to exit after handing back its result


def backend_for(device_type: str) -> str:
    """NCCL for ``cuda``, gloo for ``cpu``."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type {device_type!r}")


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device_type: str = "cuda",
                         backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a group of ``num_processes`` over a TCP store at
    ``coordinator_address`` ("host:port", served by process 0). Returns
    False, joining nothing, when no address is given (single-process mode);
    a failure to join raises."""
    if not coordinator_address:
        return False
    backend = backend or backend_for(device_type)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                            rank=int(process_id), timeout=timedelta(seconds=timeout_s))
    return True


def maybe_initialize_from_env(device_type: str = "cuda") -> bool:
    """Join a group if ``KOD_COORDINATOR_ADDRESS`` (with ``KOD_NUM_PROCESSES``
    and ``KOD_PROCESS_ID``) is set, the JAX package's spellings."""
    addr = os.environ.get("KOD_COORDINATOR_ADDRESS")
    if not addr:
        return False
    return initialize_multihost(addr, int(os.environ["KOD_NUM_PROCESSES"]),
                                int(os.environ["KOD_PROCESS_ID"]), device_type)


def is_main_process() -> bool:
    """True in a process outside any group and on rank 0 of one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def rank_zero_only(fn):
    """Run ``fn`` only on the main process; None elsewhere."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
        return None

    return wrapped


@rank_zero_only
def rank_zero_print(*args, **kwargs):
    kwargs.setdefault("flush", True)
    print(*args, **kwargs)


def host_info():
    """(rank, ranks, cards visible to this process)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), torch.cuda.device_count()
    return 0, 1, torch.cuda.device_count()


def per_host_batch_size(global_batch_size: int) -> int:
    """A rank's part of the global batch; raises unless it divides evenly."""
    n = host_info()[1]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} ranks")
    return global_batch_size // n


# ------------------------------------------------------------ collectives
def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (no-op for None); returns ``t``."""
    if group is not None:
        all_reduce_sum_.calls += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def reduce_scatter_sum(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """``out`` = rank r's chunk of ``inp`` summed over ``group``: ``inp``'s
    leading axis is ``size`` chunks of ``out``'s."""
    reduce_scatter_sum.calls += 1
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, op=dist.ReduceOp.SUM, group=group)
    return out


all_reduce_sum_.calls = 0
reduce_scatter_sum.calls = 0


def allgather_bytes(data: bytes, mesh: Optional[DataMesh] = None) -> List[bytes]:
    """Every rank's byte string, in rank order (``[data]`` without a group).

    Two-phase, as the JAX function: the lengths first, then the payloads
    zero-padded to the longest, as uint8 tensors on the mesh's device (NCCL
    moves only device tensors)."""
    if mesh is None or mesh.group is None:
        return [data]
    dev = mesh.device
    n = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    lens = [torch.zeros_like(n) for _ in range(mesh.size)]
    dist.all_gather(lens, n, group=mesh.group)
    lens = [int(x) for x in lens]
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    buf[: len(data)] = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    buf = buf.to(dev)
    bufs = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(bufs, buf, group=mesh.group)
    return [bytes(b[:k].cpu().numpy().tobytes()) for b, k in zip(bufs, lens)]


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait for every rank of the mesh's group (no-op without one)."""
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def broadcast_module_(module: torch.nn.Module, mesh: Optional[DataMesh]) -> None:
    """Rank 0's parameters and buffers copied into every rank's ``module``
    in place (once, at start: every rank then starts from the same state)."""
    if mesh is None or mesh.group is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)


# ---------------------------------------------------------------- launch
def _rank_main(fn, rank: int, size: int, port: int, device: torch.device, backend: str, timeout_s: float,
               args: tuple, results) -> None:
    """One rank: select the card, join the group over the launcher's store
    at ``port``, run ``fn(mesh, *args)``, hand back ``(rank, ok, result or
    traceback)``, leave the group."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        timeout = timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", port, is_master=False, timeout=timeout)
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=rank, world_size=size, timeout=timeout, **kw)
        out = fn(make_mesh(size, device=device), *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # pickled here: a queue would share a tensor's storage by a file
    # descriptor, which dies with this process
    results.put((rank, True, pickle.dumps(out)))
    del out
    # a CUDA graph that captured collectives holds its communicator: free
    # such graphs (a trainer and its fused epoch form a reference cycle)
    # and let the card finish before the group is destroyed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: Sequence = (), device_type: str = "cuda",
           backend: Optional[str] = None, devices: Optional[Sequence[Union[int, str, torch.device]]] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S, join_timeout_s: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``nprocs`` spawned processes, one rank
    each, and return their results in rank order.

    Rank r runs on ``devices[r]``, by default card r (``cuda``) or the CPU;
    the backend is NCCL on the card and gloo on the CPU unless ``backend``
    says otherwise (gloo ranks may share one card). ``fn`` and ``args`` are
    pickled: ``fn`` is a function a fresh interpreter can import. A rank
    that raises or dies makes ``launch`` stop the others and raise
    ``RuntimeError`` with its traceback; past ``join_timeout_s`` seconds it
    stops them all and raises ``TimeoutError``. A rank that has handed back
    its result and does not exit within ``EXIT_GRACE_S`` is terminated with
    a warning. No process outlives the call.
    """
    import multiprocessing as mp

    if nprocs < 1:
        raise ValueError(f"nprocs={nprocs}")
    if devices is None:
        devices = [torch.device("cuda", r) if device_type == "cuda" else torch.device("cpu")
                   for r in range(nprocs)]
    devices = [torch.device("cuda", d) if isinstance(d, int) else torch.device(d) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    if device_type == "cuda" and any(d.index is None or d.index >= torch.cuda.device_count() for d in devices):
        raise ValueError(f"ranks on {[str(d) for d in devices]} but {torch.cuda.device_count()} cards are visible")
    backend = backend or backend_for(device_type)
    # the group's store is served from here, on a port the system picks: no
    # other launch on this host can take it between choosing and binding
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                          timeout=timedelta(seconds=timeout_s))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}", daemon=False,
                         args=(fn, r, nprocs, store.port, devices[r], backend, timeout_s, tuple(args), results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    out = {}
    try:
        while len(out) < nprocs:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                gone = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                if gone:
                    time.sleep(1.0)  # a result put just before exit may still be in the pipe
                    try:
                        rank, ok, payload = results.get(timeout=1.0)
                    except queue.Empty:
                        r, code = gone[0]
                        raise RuntimeError(f"rank {r} of {nprocs} exited with code {code} and no result") from None
                elif deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks did not finish within {join_timeout_s} s") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{payload}")
            out[rank] = pickle.loads(payload)  # bytes a rank of this call wrote
        for r, p in enumerate(procs):
            p.join(timeout=EXIT_GRACE_S)
            if p.exitcode is None:  # its result is in: stopped below, and said
                warnings.warn(f"rank {r} of {nprocs} handed back its result but had not exited after "
                              f"{EXIT_GRACE_S} s (leaving the process group); it is terminated")
            elif p.exitcode != 0:
                raise RuntimeError(f"rank {r} of {nprocs} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        del store
    return [out[r] for r in range(nprocs)]
