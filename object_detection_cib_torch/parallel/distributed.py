"""Process groups, rank-zero guards, the collectives of the port, joining a
group from the environment, and the launcher of one process per card.

Counterpart of ``object_detection_cib_tpu/parallel/distributed.py``. The
JAX package joins a pod with ``jax.distributed.initialize`` and lets one
SPMD program drive every chip of a host. The port runs one process per card
(the usual shape of PyTorch data parallelism): ``launch`` spawns a host's
ranks, each of which selects its card before anything else, joins a
``torch.distributed`` group over a TCP store (NCCL on the card, gloo on the
CPU, each with an explicit timeout) and calls the given function with its
``DataMesh``. On one host the launching process serves the store on a port
the system picks; over several hosts (``hosts``, ``host``, ``coordinator``:
JAX's ``KOD_NUM_PROCESSES``, ``KOD_PROCESS_ID`` and
``KOD_COORDINATOR_ADDRESS``) the launcher of host 0 serves it at the
coordinator's address and every host's ranks join the one group of
``hosts * nprocs`` ranks there; a launcher is never a rank itself. A rank
that fails ends ``launch`` with an exception and stops the others;
``join_timeout_s`` bounds the whole run.

The environment names a multi-host run one of two ways (``env_layout``):
torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``GROUP_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
where each process already is one rank and joins in place
(``join_torchrun``), or the ``KOD_*`` variables, one process per host that
launches that host's ranks (``cli/train.py``). Variables that disagree
raise, naming the variable. ``initialize_multihost`` and
``maybe_initialize_from_env`` keep the JAX signatures: this process joins
as one host with one card (JAX's one process per host).

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
from typing import Callable, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

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
    ``coordinator_address`` ("host:port", served by process 0), this
    process being host ``process_id`` with one card (JAX's one process per
    host). Returns False, joining nothing, when no address is given
    (single-process mode); a failure to join raises. The caller builds the
    group's ``DataMesh`` (``make_mesh(device=..., hosts=num_processes)``)
    and hands it to the trainer."""
    if not coordinator_address:
        return False
    backend = backend or backend_for(device_type)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                            rank=int(process_id), timeout=timedelta(seconds=timeout_s))
    return True


def maybe_initialize_from_env(device_type: str = "cuda") -> bool:
    """Join a group if ``KOD_COORDINATOR_ADDRESS`` (with ``KOD_NUM_PROCESSES``
    and ``KOD_PROCESS_ID``) is set, the JAX package's spellings."""
    layout = _kod_layout(os.environ)
    if layout is None:
        return False
    return initialize_multihost(layout.address, layout.hosts, layout.host, device_type)


class HostLayout(NamedTuple):
    """This process's place in a multi-host run, as its environment names it."""

    route: str  # "torchrun": this process is one rank; "kod": it launches its host's ranks
    hosts: int
    host: int
    address: str  # "host:port" of the group's store
    rank: Optional[int] = None  # torchrun's RANK, LOCAL_WORLD_SIZE and LOCAL_RANK
    local_size: Optional[int] = None
    local_rank: Optional[int] = None


def _env_int(env: Mapping[str, str], name: str) -> int:
    if name not in env:
        raise ValueError(f"{name} is not set")
    try:
        return int(env[name])
    except ValueError:
        raise ValueError(f"{name}={env[name]!r} is not an integer") from None


def _torchrun_layout(env: Mapping[str, str]) -> HostLayout:
    world, rank = _env_int(env, "WORLD_SIZE"), _env_int(env, "RANK")
    local_size, local_rank = _env_int(env, "LOCAL_WORLD_SIZE"), _env_int(env, "LOCAL_RANK")
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        if not env.get(k):
            raise ValueError(f"{k} is not set: torchrun's variables name the group's store by MASTER_ADDR and "
                             "MASTER_PORT")
    if local_size < 1 or not 0 <= local_rank < local_size:
        raise ValueError(f"LOCAL_RANK={local_rank} is not a rank of LOCAL_WORLD_SIZE={local_size}")
    if world < 1 or world % local_size:
        raise ValueError(f"WORLD_SIZE={world} is not a number of hosts times LOCAL_WORLD_SIZE={local_size}")
    hosts = world // local_size
    if "GROUP_WORLD_SIZE" in env and _env_int(env, "GROUP_WORLD_SIZE") != hosts:
        raise ValueError(f"WORLD_SIZE={world} is not GROUP_WORLD_SIZE={env['GROUP_WORLD_SIZE']} x "
                         f"LOCAL_WORLD_SIZE={local_size}")
    if not 0 <= rank < world or rank % local_size != local_rank:
        raise ValueError(f"RANK={rank} is not host x LOCAL_WORLD_SIZE={local_size} + LOCAL_RANK={local_rank} "
                         f"within WORLD_SIZE={world}")
    host = rank // local_size
    if "GROUP_RANK" in env and _env_int(env, "GROUP_RANK") != host:
        raise ValueError(f"GROUP_RANK={env['GROUP_RANK']} but RANK={rank} is on host {host} "
                         f"(RANK // LOCAL_WORLD_SIZE)")
    return HostLayout("torchrun", hosts, host, f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", rank, local_size,
                      local_rank)


def _kod_layout(env: Mapping[str, str]) -> Optional[HostLayout]:
    address = env.get("KOD_COORDINATOR_ADDRESS")
    if not address:
        return None
    n, p = _env_int(env, "KOD_NUM_PROCESSES"), _env_int(env, "KOD_PROCESS_ID")
    if n < 1 or not 0 <= p < n:
        raise ValueError(f"KOD_PROCESS_ID={p} is not a host of KOD_NUM_PROCESSES={n}")
    _split_address(address, "KOD_COORDINATOR_ADDRESS")
    return HostLayout("kod", n, p, address)


def env_layout(environ: Optional[Mapping[str, str]] = None) -> Optional[HostLayout]:
    """The multi-host run this process's environment names, or None.

    torchrun's variables (any of ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE`` set; then all of them and ``MASTER_ADDR``,
    ``MASTER_PORT``; ``GROUP_RANK`` and ``GROUP_WORLD_SIZE`` checked where
    set) make this process one rank; ``KOD_COORDINATOR_ADDRESS`` (with
    ``KOD_NUM_PROCESSES`` and ``KOD_PROCESS_ID``) one host's launcher. Both
    may be set where they agree (torchrun's wins: the process is a rank). A
    world size that is not hosts times ranks a host, a missing variable or
    two that disagree raise ``ValueError`` naming the variable."""
    env = os.environ if environ is None else environ
    tr = None
    if any(k in env for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")):
        tr = _torchrun_layout(env)
    kod = _kod_layout(env)
    if tr is not None and kod is not None:
        if kod.hosts != tr.hosts:
            raise ValueError(f"KOD_NUM_PROCESSES={kod.hosts} but torchrun's variables give {tr.hosts} hosts "
                             "(WORLD_SIZE / LOCAL_WORLD_SIZE)")
        if kod.host != tr.host:
            raise ValueError(f"KOD_PROCESS_ID={kod.host} but torchrun's variables put this process on host "
                             f"{tr.host} (RANK // LOCAL_WORLD_SIZE)")
    return tr or kod


def _split_address(address: str, name: str = "coordinator") -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"{name}={address!r} is not 'host:port'")
    return host, int(port)


def join_torchrun(layout: HostLayout, device_type: str = "cuda", backend: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> DataMesh:
    """Join the group torchrun's variables describe, in place: rank ``RANK``
    of ``WORLD_SIZE`` on card ``LOCAL_RANK`` (``device_type`` "cuda") or
    the CPU, over the store at ``MASTER_ADDR:MASTER_PORT`` (``env://``,
    which takes torchrun's agent store where there is one)."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a rank on the card, and torch.cuda.is_available() is False; run on the CPU by "
                               "asking for it (trainer=cpu)")
        if layout.local_rank >= torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK={layout.local_rank} but {torch.cuda.device_count()} cards are visible "
                             "(CUDA_VISIBLE_DEVICES)")
        device = torch.device("cuda", layout.local_rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    backend = backend or backend_for(device.type)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=layout.rank,
                            world_size=layout.hosts * layout.local_size, timeout=timedelta(seconds=timeout_s), **kw)
    return make_mesh(device=device, hosts=layout.hosts)


def leave_group(device: torch.device) -> None:
    """Leave the process group: a CUDA graph that captured collectives
    holds its communicator, so such graphs are freed first (a trainer and
    its fused epoch form a reference cycle) and the card finishes."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.destroy_process_group()


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


def host_group(mesh: DataMesh):
    """A gloo group of the ranks on this rank's host. ``dist.new_group`` is
    collective: every rank of the mesh calls this, and each makes every
    host's group in host order, keeping its own."""
    mine = None
    for h in range(mesh.hosts):
        group = dist.new_group(list(range(h * mesh.local_size, (h + 1) * mesh.local_size)), backend="gloo")
        if h == mesh.host:
            mine = group
    return mine


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
def _rank_main(fn, rank: int, size: int, hosts: int, address: Tuple[str, int], device: torch.device,
               backend: str, timeout_s: float, args: tuple, results) -> None:
    """One rank: select the card, join the group of ``size`` ranks over the
    store at ``address``, run ``fn(mesh, *args)``, hand back ``(rank, ok,
    result or traceback)``, leave the group."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        timeout = timedelta(seconds=timeout_s)
        store = dist.TCPStore(*address, is_master=False, timeout=timeout)
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=rank, world_size=size, timeout=timeout, **kw)
        out = fn(make_mesh(size, device=device, hosts=hosts), *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # pickled here: a queue would share a tensor's storage by a file
    # descriptor, which dies with this process
    results.put((rank, True, pickle.dumps(out)))
    del out
    leave_group(device)


def launch(fn: Callable, nprocs: int, args: Sequence = (), device_type: str = "cuda",
           backend: Optional[str] = None, devices: Optional[Sequence[Union[int, str, torch.device]]] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S, join_timeout_s: Optional[float] = None,
           hosts: int = 1, host: int = 0, coordinator: Optional[str] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``nprocs`` spawned processes, one rank
    each, and return their results in rank order.

    Rank r runs on ``devices[r]``, by default card r (``cuda``) or the CPU;
    the backend is NCCL on the card and gloo on the CPU unless ``backend``
    says otherwise (gloo ranks may share one card). With ``hosts`` > 1 this
    call is host ``host``'s launcher: its ranks are ``host * nprocs + r``
    of one group of ``hosts * nprocs`` ranks over the store at
    ``coordinator`` ("host:port"), which host 0's launcher serves and every
    host runs ``nprocs`` ranks; the results are this host's ranks'. ``fn``
    and ``args`` are pickled: ``fn`` is a function a fresh interpreter can
    import. A rank that raises or dies makes ``launch`` stop the others
    and raise ``RuntimeError`` with its traceback; past ``join_timeout_s``
    seconds it stops them all and raises ``TimeoutError``. A rank that has
    handed back its result and does not exit within ``EXIT_GRACE_S`` is
    terminated with a warning. No process outlives the call.
    """
    import multiprocessing as mp

    if nprocs < 1:
        raise ValueError(f"nprocs={nprocs}")
    if hosts < 1 or not 0 <= host < hosts:
        raise ValueError(f"host {host} of {hosts} hosts")
    if hosts > 1 and not coordinator:
        raise ValueError(f"{hosts} hosts join one group over a store at a coordinator's address: coordinator="
                         "'host:port' (KOD_COORDINATOR_ADDRESS)")
    if devices is None:
        devices = [torch.device("cuda", r) if device_type == "cuda" else torch.device("cpu")
                   for r in range(nprocs)]
    devices = [torch.device("cuda", d) if isinstance(d, int) else torch.device(d) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    if device_type == "cuda" and any(d.index is None or d.index >= torch.cuda.device_count() for d in devices):
        raise ValueError(f"ranks on {[str(d) for d in devices]} but {torch.cuda.device_count()} cards are visible")
    backend = backend or backend_for(device_type)
    timeout = timedelta(seconds=timeout_s)
    store = None
    if coordinator:
        address = _split_address(coordinator)
        if host == 0:  # the group's store, which every host's ranks join
            store = dist.TCPStore(address[0], address[1], is_master=True, wait_for_workers=False, timeout=timeout)
    else:
        # served from here, on a port the system picks: no other launch on
        # this host can take it between choosing and binding
        store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False, timeout=timeout)
        address = ("127.0.0.1", store.port)
    size, first = hosts * nprocs, host * nprocs
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank-{first + r}", daemon=False,
                         args=(fn, first + r, size, hosts, address, devices[r], backend, timeout_s, tuple(args),
                               results))
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
                        raise RuntimeError(f"rank {first + r} of {size} exited with code {code} and no "
                                           "result") from None
                elif deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks did not finish within {join_timeout_s} s") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {size} failed:\n{payload}")
            out[rank - first] = pickle.loads(payload)  # bytes a rank of this call wrote
        for r, p in enumerate(procs):
            p.join(timeout=EXIT_GRACE_S)
            if p.exitcode is None:  # its result is in: stopped below, and said
                warnings.warn(f"rank {first + r} of {size} handed back its result but had not exited after "
                              f"{EXIT_GRACE_S} s (leaving the process group); it is terminated")
            elif p.exitcode != 0:
                raise RuntimeError(f"rank {first + r} of {size} exited with code {p.exitcode}")
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
