"""Port parity: training and validation over several hosts (the JAX
package's multi-host trainer: ``jax.process_index``/``process_count``).

The JAX package is one process per host; the port's host is a group of
ranks, one per card, and a run over several hosts joins one group from the
environment, by torchrun's variables (each process a rank) or by the
``KOD_*`` variables (each host's process launches its ranks). On the CPU
every rank is a gloo rank holding torch to one thread; yolov5n at 64 px,
a host's batch of 4 (two rows a rank over two ranks a host).

Without processes (JAX's side simulated by monkeypatching
``jax.process_index``/``process_count``, as ``tests/test_device_pipeline.py``
does), exactly:
  * each host's step-loop plan (groups and mixup co-samples, with and
    without mosaic, with a sampler) equals the JAX ``_epoch_plan()`` of that
    host over two epochs, for 2 and 3 hosts; the fused epoch's global plan
    equals JAX's ``_epoch_plan(B * hosts, shard_for_host=False)``;
  * the host feed's ``Prefetcher._epoch_indices`` and ``__len__`` equal the
    JAX ``Prefetcher(shard_for_host=True)``'s;
  * the environment's layout (torchrun's and the ``KOD_*`` variables), and
    what disagrees raising, naming the variable; the two refusals of a run
    asked for on the card where there is none (``make_mesh()``, and
    ``cli.train.main`` under ``KOD_*`` without ``trainer=cpu``).

Three groups, each spawned once through the environment and read by every
test of its configuration: 2 hosts x 1 rank (``KOD_*``), 2 hosts x 2 ranks
through ``KOD_*`` and through torchrun's variables set by the test, each
subprocess with a timeout. Tolerances:
  * each rank's plan is its host's ``_epoch_plan``, exactly;
  * three f64 steps of the step loop: every parameter and BatchNorm
    statistic within rtol 1e-12 and atol 1e-12 of one process stepping on
    the concatenation of the hosts' batches in host order (the sums run in
    another order over the ranks: ~1e-16 relative a step); the ranks'
    states bitwise equal;
  * three f64 steps of the fused epoch: bitwise equal to the one-host run
    of the port's launcher on ``hosts * local`` ranks (the same rows and
    draws on each rank, the same collectives);
  * the merged mAP dicts, both validation feeds, equal to one process's at
    the same global batch (each rank validating at its share of its host's
    batch);
  * the step loop's batches from the sharded corpus (every host's plan side
    by side, one exchange) bitwise those of the replicated one;
  * the host feed's dataset seed and ``steps_per_epoch`` against JAX
    ``Trainer(cfg)`` under the patch; its shards cover the stream;
  * ``cli.train.main`` on 2 x 2 ranks by each route: one set of run files,
    ``steps_per_epoch = len(train) // (batch_size * hosts)``;
  * a three-job ``-m`` sweep on 2 x 1 ranks by ``KOD_*``, one group for the
    whole sweep: each job's metric dict equal to that job run alone over
    the same two hosts and its checkpoint bitwise; the job that raises on
    every rank recorded as failed, the sweep going on; the summary printed
    and written by host 0 alone.
The entry points (``entry.py``): ``dryrun_multichip(2)`` on gloo (dry runs
1 to 4, dry run 2 over a ``(1, 2)`` mesh; again with the corpus in the
flat layout, dry runs 3 and 4 bitwise the planar corpus's), and the
yolov5s forward of ``entry()`` against the JAX ``entry()``'s on converted
weights (bf16 on both sides, 2 images at 128 px: every head value within
one bf16 rounding, 2**-7, of the largest head value; measured equal on
this CPU).
"""

import hashlib
import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from object_detection_cib_torch.cli import train as t_cli
from object_detection_cib_torch.core.types import FeatureShape, default_anchors
from object_detection_cib_torch.data import device_pipeline as tdp
from object_detection_cib_torch.data import reader as t_reader
from object_detection_cib_torch.data import samplers as tsamplers
from object_detection_cib_torch.data.host_augment import AugParams
from object_detection_cib_torch.data.pipeline import Prefetcher
from object_detection_cib_torch.data.synthetic import build_fake_manifest
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.parallel import distributed as tdist
from object_detection_cib_torch.parallel import mesh as tmesh
from object_detection_cib_torch.train import checkpoint as tck
from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
from object_detection_cib_torch.train.steps import Batch, make_train_step
from object_detection_cib_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
S, B, NC, STEPS, SEED = 64, 4, 3, 3, 3  # B: the batch of one host
N_TRAIN, N_VAL = 24, 10
TIMEOUT, JOIN, SUBPROCESS = 60, 240, 300  # init_process_group's; a launch's; a subprocess's (seconds)
CONFIGS = {"2x1 kod": (2, 1, "kod"), "2x2 kod": (2, 2, "kod"), "2x2 torchrun": (2, 2, "torchrun")}


def _stable_hash(key) -> int:
    """A digest of the sample id, the same in every process (``hash`` of a
    ``str`` is salted per process), for the host reader's fake images."""
    return int.from_bytes(hashlib.blake2b(str(key).encode(), digest_size=8).digest(), "little")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_reader, "hash", _stable_hash, raising=False)
        yield
    torch.set_num_threads(n)


def _infos():
    return (build_fake_manifest(num_images=N_TRAIN, num_classes=NC, image_size=S, seed=2),
            build_fake_manifest(num_images=N_VAL, num_classes=NC, image_size=S, seed=1))


def _np(batch) -> dict:
    return {k: v.numpy().copy() for k, v in batch._asdict().items()}


def _state(net) -> dict:
    return {k: v.detach().double().numpy().copy() for k, v in net.state_dict().items()}


def _sampler(mod, info, kind):
    return None if kind is None else {"class_aware": lambda: mod.ClassAwareSampler(info, seed=0),
                                      "repeat_factor": lambda: mod.RepeatFactorSampler(info)}[kind]()


def _fake_mesh(hosts, host, local=1, local_rank=0) -> tmesh.DataMesh:
    """A host's rank in a layout, with a stand-in group (no collective runs)."""
    return tmesh.DataMesh(hosts * local, host * local + local_rank, torch.device("cpu"), group=object(),
                          backend="gloo", hosts=hosts)


def _port_pipe(mesh=None, sampler=None, **kw):
    info, _ = _infos()
    return tdp.DeviceDataPipeline(info, S, B, AugParams(), max_targets=40, seed=SEED, device="cpu",
                                  device_cache=False, mesh=mesh, sampler=_sampler(tsamplers, info, sampler), **kw)


# ------------------------------------------------------------ what a rank runs

def _steps(mesh, fused: bool, batch_size: int = B) -> dict:
    """Three f64 steps over the corpus on the card with mosaic and mixup 0.5,
    at a host's batch ``batch_size``: the step loop (its batches kept) or
    the fused epoch; the state after."""
    info, _ = _infos()
    pipe = tdp.DeviceDataPipeline(info, S, batch_size, AugParams(), max_targets=40, seed=SEED, device="cpu",
                                  feed_dtype=torch.float64, mesh=mesh, mixup_prob=0.5)
    net = build_network(NC, "n", device="cpu", seed=5).double()
    opt = SmartSGD(net, OptimizerConfig(), 6)
    step = make_train_step(net, default_anchors(), FeatureShape(S, S), opt, mesh=mesh)
    out = {}
    if fused:
        pipe.build_fused_epoch_fn(lambda b, hp: step(b, hp), stack_metrics=True)(
            pipe.epoch_host_arrays(STEPS), opt.hyper_table(0, STEPS))
    else:
        out["batches"] = []
        for batch, _ in pipe.epoch(STEPS):
            out["batches"].append(_np(batch))
            step(batch)
        out["plan"] = pipe.consumed_plan_log[0]
    out["state"] = _state(net)
    return out


def _trainer(mesh, batch_size=B, **kw):
    info, val = _infos()
    return Trainer(info, val, size="n", image_size=S, batch_size=batch_size, max_targets=40, seed=7,
                   dtype=None, device="cpu", fake_mode=True, num_workers=1, max_epochs=4, mesh=mesh, **kw)


def _validation(mesh, batch_size=B) -> dict:
    """mAP through both validation feeds."""
    return {feed: _trainer(mesh, batch_size, pipeline="device", device_cache=True,
                           val_device_cache=feed == "cache").validate()
            for feed in ("cache", "host")}


def _host_feed(mesh) -> dict:
    t = _trainer(mesh, pipeline="host", use_mosaic=True)
    ds = t.prefetcher.dataset
    return dict(seed_state=ds.rng.bit_generator.state, pyrng=ds.pyrng.getstate(),
                steps_per_epoch=t.steps_per_epoch, len=len(t.prefetcher),
                indices=t.prefetcher._epoch_indices().tolist(), rows=t.prefetcher.rows)


def _corpus_batches(mesh) -> dict:
    """Two step-loop batches from the replicated and the sharded corpus
    (over several hosts every host's plan side by side), mixup 0.5."""
    info, _ = _infos()
    return {sharding: [_np(b) for b, _ in tdp.DeviceDataPipeline(
        info, S, B, AugParams(), max_targets=40, seed=4, device="cpu", feed_dtype=torch.float32, mesh=mesh,
        corpus_sharding=sharding, mixup_prob=0.5).epoch(2)] for sharding in ("replicated", "sharded")}


def _rank_checks(mesh) -> dict:
    """Every rank-side check of one group."""
    torch.set_num_threads(1)
    t_reader.hash = _stable_hash
    return dict(layout=(mesh.size, mesh.rank, mesh.hosts, mesh.host, mesh.local_size, mesh.local_rank),
                steps=_steps(mesh, fused=False), fused=_steps(mesh, fused=True)["state"],
                validation=_validation(mesh), host_feed=_host_feed(mesh), corpus=_corpus_batches(mesh))


def _fused_only(mesh, batch_size: int) -> dict:
    torch.set_num_threads(1)
    return _steps(mesh, fused=True, batch_size=batch_size)["state"]


# -------------------------------------------- the processes of a configuration

CLI = ["experiment=yv5n", "dataset_name=fake", "trainer=cpu", "model.net.dtype=null",
       "model.net.widen_factor=0.25", "data.batch_size=4", "data.target_image_size=64", "data.max_targets=40",
       "data.num_workers=1", "data.pipeline=device", "data.device_cache=True", "callbacks.model_summary=null",
       "logger=csv", "print_config=False", "model.val_nms_max_candidates=256", "data.fake_num_images=16",
       "debug=fdr", "hydra=static", "extras.enforce_tags=False"]


SWEEP = ("model.assign_compact_slots", ("1", "x", "128"))  # a planted overflow, a value that raises, none


def _kod_host(out_file: str, local: int, cli_argv: list, sweep_argv: list = ()) -> None:
    """A host's process under ``KOD_*``: launch its ranks of the checks'
    group, then ``cli.train.main`` over a second coordinator address; with
    ``sweep_argv``, then a two-job ``-m`` sweep of ``SWEEP`` and each of its
    jobs alone (each port picked by host 0 just before it binds it)."""
    host, ports = int(os.environ["KOD_PROCESS_ID"]), Path(out_file).parent

    def coordinator(name):
        os.environ["KOD_COORDINATOR_ADDRESS"] = f"127.0.0.1:{_shared_port(ports / f'{name}.port', host == 0)}"

    coordinator("checks")
    layout = tdist.env_layout()
    ranks = tdist.launch(_rank_checks, local, device_type="cpu", hosts=layout.hosts, host=layout.host,
                         coordinator=layout.address, timeout_s=TIMEOUT, join_timeout_s=JOIN)
    cli = sweep = None
    if cli_argv:
        coordinator("cli")
        cli = t_cli.main(cli_argv)
    if sweep_argv:
        key, values = SWEEP
        coordinator("sweep")
        sweep = dict(results=t_cli.main(["-m", *sweep_argv, f"{key}={','.join(values)}",
                                         f"paths.output_dir={ports / 'sweep'}"]), alone={})
        for i, v in enumerate(values):
            if v.isdigit():
                coordinator(f"alone{i}")
                sweep["alone"][i] = t_cli.main([*sweep_argv, f"{key}={v}", f"paths.output_dir={ports / f'alone{i}'}"])
    Path(out_file).write_bytes(pickle.dumps(dict(ranks=ranks, cli=cli, sweep=sweep)))


def _torchrun_rank(out_file: str, cli_argv: list) -> None:
    """A rank's process under torchrun's variables: join in place, run the
    checks, leave; then ``cli.train.main`` over a second port (each port
    picked by rank 0, which serves the store, just before it binds it)."""
    main, ports = os.environ["RANK"] == "0", Path(out_file).parent
    os.environ["MASTER_PORT"] = str(_shared_port(ports / "checks.port", main))
    mesh = tdist.join_torchrun(tdist.env_layout(), "cpu", timeout_s=TIMEOUT)
    out = _rank_checks(mesh)
    tdist.barrier(mesh)
    tdist.leave_group(mesh.device)
    os.environ["MASTER_PORT"] = str(_shared_port(ports / "cli.port", main))
    cli = t_cli.main(cli_argv)
    Path(out_file).write_bytes(pickle.dumps(dict(ranks=[out], cli=cli)))


def _shared_port(path: Path, pick: bool) -> int:
    """A free port for a group's store: picked by the process that serves
    it (``pick``) right before it binds it, and read from ``path`` by the
    group's other processes."""
    if pick:
        port = _free_port()
        path.with_suffix(".tmp").write_text(str(port))
        path.with_suffix(".tmp").replace(path)
        return port
    deadline = time.monotonic() + JOIN
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no port published at {path} within {JOIN} s")
        time.sleep(0.05)
    return int(path.read_text())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _python(call: str, env: dict, log: Path) -> subprocess.Popen:
    code = f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); import test_torch_hosts as m; m.{call}"
    full = {**os.environ, "OMP_NUM_THREADS": "1", **env}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT",
              "KOD_COORDINATOR_ADDRESS", "KOD_NUM_PROCESSES", "KOD_PROCESS_ID"):
        if k not in env:
            full.pop(k, None)
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=full, stdout=log.open("w"),
                            stderr=subprocess.STDOUT)


def _start(name: str, tmp: Path) -> list:
    """The processes of one configuration: (process, result file, log)."""
    hosts, local, route = CONFIGS[name]
    cfg_dir = tmp / name.replace(" ", "_")
    cfg_dir.mkdir()
    cli_argv = CLI + [f"paths.output_dir={cfg_dir / 'cli'}", f"trainer.num_devices={local}"] if local > 1 else []
    sweep_argv = CLI + ["trainer.num_devices=1"] if local == 1 else []
    procs = []
    if route == "kod":
        for h in range(hosts):
            env = {"KOD_NUM_PROCESSES": str(hosts), "KOD_PROCESS_ID": str(h)}  # the address: host 0's port
            out, log = cfg_dir / f"host{h}.pkl", cfg_dir / f"host{h}.log"
            procs.append((_python(f"_kod_host({str(out)!r}, {local}, {cli_argv!r}, {sweep_argv!r})", env, log),
                          out, log))
    else:
        for r in range(hosts * local):
            env = {"RANK": str(r), "WORLD_SIZE": str(hosts * local), "LOCAL_RANK": str(r % local),
                   "LOCAL_WORLD_SIZE": str(local), "GROUP_RANK": str(r // local), "MASTER_ADDR": "127.0.0.1"}
            out, log = cfg_dir / f"rank{r}.pkl", cfg_dir / f"rank{r}.log"
            procs.append((_python(f"_torchrun_rank({str(out)!r}, {cli_argv!r})", env, log), out, log))
    return procs


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every configuration's processes started at once, and beside them the
    one-host fused runs of the port's launcher on 2 and 4 ranks at the
    global batch of two hosts; -> {name:
    {"ranks": results in rank order, "cli": each process's CLI result,
    "dir": its directory}, "one host": {ranks: states}}."""
    tmp = tmp_path_factory.mktemp("hosts")
    started = {name: _start(name, tmp) for name in CONFIGS}
    one_host, errors = {}, []

    def run_one_host(n):
        try:
            one_host[n] = tdist.launch(_fused_only, n, (2 * B,), device_type="cpu", timeout_s=TIMEOUT,
                                       join_timeout_s=JOIN)
        except Exception as e:  # raised below, in the fixture
            errors.append(e)

    threads = [threading.Thread(target=run_one_host, args=(n,)) for n in (2, 4)]
    for t in threads:
        t.start()
    out = {}
    try:
        for name, procs in started.items():
            ranks, cli, sweeps = [], [], []
            for proc, res, log in procs:
                try:
                    code = proc.wait(timeout=SUBPROCESS)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    raise
                assert code == 0, f"{name}: exit {code}\n{log.read_text()[-4000:]}"
                got = pickle.loads(res.read_bytes())
                ranks += got["ranks"]
                cli.append(got["cli"])
                sweeps.append(got.get("sweep"))
            out[name] = dict(ranks=ranks, cli=cli, sweeps=sweeps, dir=res.parent,
                             logs=[log.read_text() for _, _, log in procs])
    finally:
        for procs in started.values():
            for proc, _, _ in procs:
                if proc.poll() is None:
                    proc.kill()
        for t in threads:
            t.join(timeout=SUBPROCESS)
    if errors:
        raise errors[0]
    out["one host"] = one_host
    return out


# ------------------------------------------------------------- plan parity

@pytest.mark.parametrize("recipe", ["mosaic", "mixup", "no_mosaic", "class_aware_mixup", "repeat_factor"])
@pytest.mark.parametrize("hosts", [2, 3])
def test_step_loop_plan_of_each_host_matches_jax(monkeypatch, hosts, recipe):
    import jax

    from object_detection_cib_tpu.data import device_pipeline as jdp
    from object_detection_cib_tpu.data import samplers as jsamplers
    from object_detection_cib_tpu.data.host_augment import AugParams as JAug
    from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest

    kw, sampler = {"mosaic": ({}, None), "mixup": (dict(mixup_prob=0.5), None),
                   "no_mosaic": (dict(use_mosaic=False), None),
                   "class_aware_mixup": (dict(mixup_prob=0.5), "class_aware"),
                   "repeat_factor": (dict(use_mosaic=False), "repeat_factor")}[recipe]
    jinfo = j_manifest(num_images=N_TRAIN, num_classes=NC, image_size=S, seed=2)
    states = []
    for h in range(hosts):
        with monkeypatch.context() as mp:
            mp.setattr(jax, "process_count", lambda: hosts)
            mp.setattr(jax, "process_index", lambda p=h: p)
            jp = jdp.DeviceDataPipeline(jinfo, target_size=S, batch_size=B, aug_params=JAug(), max_targets=40,
                                        seed=SEED, fake_mode=True, sampler=_sampler(jsamplers, jinfo, sampler), **kw)
            want = [jp._epoch_plan()[:2] for _ in range(2)]
        tp = _port_pipe(_fake_mesh(hosts, h), sampler, **kw)
        for (jg, jsec), (tg, tsec) in zip(want, [tp._epoch_plan() for _ in range(2)]):
            np.testing.assert_array_equal(tg, jg, err_msg=f"host {h}")
            np.testing.assert_array_equal(tsec, jsec, err_msg=f"host {h}")
        assert tg.shape[0] == (N_TRAIN // hosts + (h < N_TRAIN % hosts)) // B
        states.append(tp.pyrng.getstate())
    assert all(st == states[0] for st in states)  # every host's pyrng advanced alike: epochs in step


@pytest.mark.parametrize("hosts", [2, 3])
def test_fused_plan_is_the_jax_global_plan(monkeypatch, hosts):
    import jax

    from object_detection_cib_tpu.data import device_pipeline as jdp
    from object_detection_cib_tpu.data.host_augment import AugParams as JAug
    from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest

    jinfo = j_manifest(num_images=N_TRAIN, num_classes=NC, image_size=S, seed=2)
    with monkeypatch.context() as mp:
        mp.setattr(jax, "process_count", lambda: hosts)
        mp.setattr(jax, "process_index", lambda: 1)
        jp = jdp.DeviceDataPipeline(jinfo, target_size=S, batch_size=B, aug_params=JAug(), max_targets=40,
                                    seed=SEED, fake_mode=True, mixup_prob=0.5)
        jg, jsec, _ = jp._epoch_plan(B=B * hosts, shard_for_host=False)
    for h in range(hosts):
        tg, tsec = _port_pipe(_fake_mesh(hosts, h), mixup_prob=0.5)._planned(None, fused=True)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tsec, jsec)
    # and on one host of two ranks the global plan is the one-process plan
    one = _port_pipe(mixup_prob=0.5)._planned(None)
    two = _port_pipe(_fake_mesh(1, 0, local=2), mixup_prob=0.5)._planned(None, fused=True)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)


def test_rank_columns_of_host_and_global_plans():
    """A rank keeps its columns of its host's plan by its rank on the host,
    and of the fused plan by its global rank."""
    groups = np.arange(2 * 16).reshape(2, 16)
    for h in range(2):
        for lr in range(2):
            pipe = _port_pipe(_fake_mesh(2, h, local=2, local_rank=lr))
            np.testing.assert_array_equal(pipe._rank_plan(groups, np.zeros((2, 0)))[0], groups[:, lr * 8:(lr + 1) * 8])
            r = 2 * h + lr
            np.testing.assert_array_equal(pipe._rank_plan(groups, np.zeros((2, 0)), fused=True)[0],
                                          groups[:, r * 4:(r + 1) * 4])
            assert pipe.rows == slice(r * 2, (r + 1) * 2)  # its rows of the global batch's draws


# ---------------------------------------------------------- host feed parity

@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("sampler", [None, "class_aware"])
@pytest.mark.parametrize("hosts", [2, 3])
def test_prefetcher_host_shard_matches_jax(monkeypatch, hosts, sampler, drop_last):
    import jax

    from object_detection_cib_tpu.data import pipeline as jpipe
    from object_detection_cib_tpu.data import samplers as jsamplers
    from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest

    info, _ = _infos()
    jinfo = j_manifest(num_images=N_TRAIN, num_classes=NC, image_size=S, seed=2)
    data = list(range(N_TRAIN + 1))  # a dataset is read for its length only
    joined = []
    for h in range(hosts):
        with monkeypatch.context() as mp:
            mp.setattr(jax, "process_count", lambda: hosts)
            mp.setattr(jax, "process_index", lambda p=h: p)
            jp = jpipe.Prefetcher(data, 5, 40, sampler=_sampler(jsamplers, jinfo, sampler), drop_last=drop_last,
                                  shard_for_host=True)
            want = [jp._epoch_indices() for _ in range(2)], len(jp)
        tp = Prefetcher(data, 5, 40, sampler=_sampler(tsamplers, info, sampler), drop_last=drop_last,
                        device=None, host=h, hosts=hosts)
        got = [tp._epoch_indices() for _ in range(2)], len(tp)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
        assert got[1] == want[1]
        joined.append(got[0][0])
    n = N_TRAIN if sampler else N_TRAIN + 1
    assert sum(len(j) for j in joined) == n  # the shards cover the stream once


# ----------------------------------------------------------- the environment

TORCHRUN = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2", "GROUP_RANK": "1",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}
KOD = {"KOD_COORDINATOR_ADDRESS": "127.0.0.1:29600", "KOD_NUM_PROCESSES": "2", "KOD_PROCESS_ID": "1"}


def test_env_layouts():
    assert tdist.env_layout({}) is None
    assert tdist.env_layout(TORCHRUN) == tdist.HostLayout("torchrun", 2, 1, "127.0.0.1:29500", 3, 2, 1)
    assert tdist.env_layout(KOD) == tdist.HostLayout("kod", 2, 1, "127.0.0.1:29600")
    assert tdist.env_layout({**TORCHRUN, **KOD}).route == "torchrun"  # where both agree, each process is a rank
    m = tmesh.DataMesh(4, 3, torch.device("cpu"), hosts=2)
    assert (m.local_size, m.host, m.local_rank) == (2, 1, 1) and m.rank == m.host * m.local_size + m.local_rank


@pytest.mark.parametrize("env,name", [
    (dict(TORCHRUN, WORLD_SIZE="5"), "WORLD_SIZE"),
    (dict(TORCHRUN, GROUP_WORLD_SIZE="3"), "WORLD_SIZE"),
    (dict(TORCHRUN, GROUP_RANK="0"), "GROUP_RANK"),
    (dict(TORCHRUN, RANK="2"), "RANK"),
    (dict(TORCHRUN, LOCAL_RANK="2"), "LOCAL_RANK"),
    ({k: v for k, v in TORCHRUN.items() if k != "MASTER_PORT"}, "MASTER_PORT"),
    ({k: v for k, v in TORCHRUN.items() if k != "LOCAL_WORLD_SIZE"}, "LOCAL_WORLD_SIZE"),
    (dict(KOD, KOD_PROCESS_ID="2"), "KOD_PROCESS_ID"),
    (dict(KOD, KOD_COORDINATOR_ADDRESS="localhost"), "KOD_COORDINATOR_ADDRESS"),
    ({**TORCHRUN, **KOD, "KOD_NUM_PROCESSES": "4", "KOD_PROCESS_ID": "1"}, "KOD_NUM_PROCESSES"),
    ({**TORCHRUN, **KOD, "KOD_PROCESS_ID": "0"}, "KOD_PROCESS_ID"),
])
def test_env_layouts_that_disagree_raise_naming_the_variable(env, name):
    with pytest.raises(ValueError, match=rf"\b{name}\b"):
        tdist.env_layout(env)


def test_without_a_card_the_card_is_refused(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="current card.*device='cpu'"):
        tmesh.make_mesh()
    assert tmesh.make_mesh(device="cpu").device == torch.device("cpu")
    for k, v in KOD.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="trainer.platform=null runs on the card.*trainer=cpu"):
        t_cli.main(["experiment=yv5n", "dataset_name=fake", "print_config=False", f"paths.output_dir={tmp_path}"])
    assert (tmp_path / "error.log").is_file()


def test_a_group_joined_without_its_mesh_is_refused(tmp_path):
    """The group's hosts are the caller's to say: a trainer takes a joined
    group through the mesh handed to it, and refuses one without."""
    import torch.distributed as dist

    from object_detection_cib_torch.train.trainer import _check_mesh

    tcfg, cpu = {"platform": "cpu", "num_devices": 1}, torch.device("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="no DataMesh was handed over"):
            _check_mesh(tcfg, cpu, None)
        mesh = tmesh.make_mesh(device="cpu", hosts=1)
        assert _check_mesh(tcfg, cpu, mesh) is mesh
    finally:
        dist.destroy_process_group()


def test_launch_refuses_hosts_without_a_coordinator():
    with pytest.raises(ValueError, match="coordinator"):
        tdist.launch(_fused_only, 1, device_type="cpu", hosts=2, host=0)
    with pytest.raises(ValueError, match="host 2 of 2"):
        tdist.launch(_fused_only, 1, device_type="cpu", hosts=2, host=2, coordinator="127.0.0.1:1")


# -------------------------------------------------------- the group runs

def _global_batches(res) -> list:
    """The step loop's global batches: every rank's rows in rank order (the
    hosts' batches in host order)."""
    per_rank = [r["steps"]["batches"] for r in res["ranks"]]
    return [{k: np.concatenate([b[i][k] for b in per_rank]) for k in per_rank[0][i]} for i in range(STEPS)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_and_each_host_plan(groups, name):
    hosts, local, _ = CONFIGS[name]
    res = groups[name]
    assert [r["layout"] for r in res["ranks"]] == [
        (hosts * local, r, hosts, r // local, local, r % local) for r in range(hosts * local)]
    for r, got in enumerate(res["ranks"]):
        want = _port_pipe(_fake_mesh(hosts, r // local, local, r % local), mixup_prob=0.5)._epoch_plan()
        np.testing.assert_array_equal(got["steps"]["plan"], np.concatenate(want, 1))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_loop_equals_one_process_on_the_hosts_batches(groups, name):
    res = groups[name]
    net = build_network(NC, "n", device="cpu", seed=5).double()
    step = make_train_step(net, default_anchors(), FeatureShape(S, S), SmartSGD(net, OptimizerConfig(), 6))
    batches = _global_batches(res)
    for b in batches:
        assert b["images"].shape[0] == CONFIGS[name][0] * B
        step(Batch(*(torch.from_numpy(b[k]) for k in ("images", "boxes", "labels", "mask"))))
    want = _state(net)
    for r in res["ranks"]:
        got = r["steps"]["state"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
    # the hosts' batches differ: each host feeds its own shard
    hosts, local, _ = CONFIGS[name]
    first = batches[0]["images"]
    assert not np.array_equal(first[:B], first[B:2 * B])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ranks_hold_the_same_state(groups, name):
    ranks = groups[name]["ranks"]
    for key in ("steps", "fused"):
        states = [r["steps"]["state"] if key == "steps" else r["fused"] for r in ranks]
        assert all(np.array_equal(s[k], states[0][k]) for s in states for k in s), key


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_epoch_equals_the_one_host_run(groups, name):
    hosts, local, _ = CONFIGS[name]
    want = groups["one host"][hosts * local][0]
    for r in groups[name]["ranks"]:
        assert all(np.array_equal(r["fused"][k], v) for k, v in want.items())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_corpus_equals_replicated_over_hosts(groups, name):
    for r in groups[name]["ranks"]:
        got = r["corpus"]
        for a, b in zip(got["sharded"], got["replicated"], strict=True):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def one_process_maps():
    return _validation(None, batch_size=2 * B)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_merged_map_equals_one_process(groups, one_process_maps, name):
    assert not all(np.isnan(v) or v == 0 for v in one_process_maps["cache"].values())
    for r in groups[name]["ranks"]:
        assert r["validation"] == one_process_maps


@pytest.fixture(scope="module")
def jax_host_trainer(tmp_path_factory):
    """The JAX ``Trainer(cfg)`` of host 1 of 2 on the host pipeline (no
    checkpoint callback: Orbax's asks ``jax.distributed`` for the hosts)."""
    import jax

    from object_detection_cib_tpu.config import engine as j_engine
    from object_detection_cib_tpu.train.trainer import Trainer as JTrainer

    argv = ["experiment=yv5n", "dataset_name=fake", "trainer=cpu", "model.net.dtype=null",
            "model.net.widen_factor=0.25", "data.batch_size=4", "data.target_image_size=64", "data.num_workers=1",
            "data.max_targets=40", "callbacks=none", "logger=csv", "print_config=False",
            "data.fake_num_images=24", "seed=7", f"paths.output_dir={tmp_path_factory.mktemp('jax')}"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "process_count", lambda: 2)
        mp.setattr(jax, "process_index", lambda: 1)
        return JTrainer(j_engine.compose(ROOT / "configs", "train", argv))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_host_feed_seeds_shards_and_steps(groups, name):
    hosts, local, _ = CONFIGS[name]
    ranks = groups[name]["ranks"]
    stream = tsamplers.ShuffleSampler(_infos()[0], seed=7).epoch_indices()
    for r, res in enumerate(ranks):
        h, lr = r // local, r % local
        feed = res["host_feed"]
        assert feed["seed_state"] == np.random.default_rng(7 + h * 1000003).bit_generator.state
        assert feed["steps_per_epoch"] == N_TRAIN // (B * hosts)
        np.testing.assert_array_equal(feed["indices"], stream[h::hosts])
        assert feed["len"] == len(stream[h::hosts]) // B
        assert feed["rows"] == slice(lr * B // local, (lr + 1) * B // local)


def test_host_feed_seed_and_steps_match_jax_trainer(groups, jax_host_trainer):
    jt = jax_host_trainer
    feed = groups["2x2 kod"]["ranks"][2]["host_feed"]  # rank 2: host 1, local rank 0
    assert feed["seed_state"] == jt.train_ds.rng.bit_generator.state
    assert feed["pyrng"] == jt.train_ds.pyrng.getstate()
    assert feed["steps_per_epoch"] == jt.steps_per_epoch == N_TRAIN // (B * 2)


@pytest.mark.parametrize("name", ["2x2 kod", "2x2 torchrun"])
def test_cli_trains_two_hosts_of_two_ranks(groups, name):
    res = groups[name]
    out = res["dir"] / "cli"
    for f in ("checkpoints/last", "checkpoints/best", "checkpoints/meta.json", "csv/metrics.csv", "hparams.json"):
        assert (out / f).is_file(), f
    hp = json.loads((out / "hparams.json").read_text())
    assert hp["batch_size"] == 4 and hp["steps_per_epoch"] == 16 // (4 * 2)
    maps = [{k: v for k, v in m.items() if k != "images_per_sec"} for m in res["cli"]]  # each host's clock
    assert all("map" in m for m in maps)
    for m in maps:  # a class without ground truth in the validated batches reads NaN on every host
        np.testing.assert_equal(m, maps[0])


def test_sweep_over_two_hosts_runs_each_job_as_it_runs_alone(groups):
    """``-m`` under two ``KOD_*`` hosts joins one group for the sweep: each
    job's metric dict equals that job run alone over the same two hosts, its
    checkpoint bitwise, and the two jobs differ; a job that raises on every
    rank is recorded and the sweep goes on; host 0 alone writes the
    summary."""
    res = groups["2x1 kod"]
    key, values = SWEEP
    for sweep in res["sweeps"]:  # what each host's command returned
        assert [r["job"] for r in sweep["results"]] == [0, 1, 2]
        assert [r["overrides"] for r in sweep["results"]] == [[f"{key}={v}"] for v in values]
        assert ["error" in r for r in sweep["results"]] == [False, True, False]
        for i, alone in sweep["alone"].items():
            np.testing.assert_equal({k: v for k, v in sweep["results"][i]["metrics"].items() if k != "images_per_sec"},
                                    {k: v for k, v in alone.items() if k != "images_per_sec"})
    nets = []
    for i in (0, 2):
        swept = tck.load_state(res["dir"] / "sweep" / "multirun" / str(i) / "checkpoints" / "last")["net"]
        alone = tck.load_state(res["dir"] / f"alone{i}" / "checkpoints" / "last")["net"]
        assert all(torch.equal(v, alone[k]) for k, v in swept.items()), i
        nets.append(swept)
    assert not all(torch.equal(v, nets[1][k]) for k, v in nets[0].items())
    summary = json.loads((res["dir"] / "sweep" / "multirun" / "summary.json").read_text())
    np.testing.assert_equal(summary, res["sweeps"][0]["results"])
    assert ["── multirun summary" in log for log in res["logs"]] == [True, False]


# ---------------------------------------------------------------- entry.py

@pytest.fixture(scope="module")
def planar_dryrun():
    from object_detection_cib_torch.entry import dryrun_multichip

    return dryrun_multichip(2, device_type="cpu", join_timeout_s=JOIN)


def test_dryrun_multichip_on_two_gloo_ranks(planar_dryrun):
    got = planar_dryrun
    assert np.isfinite(got["loss"]) and np.isfinite(got["spatial"]["loss"])  # dry runs 1 and 2
    for part in ("fused", "sharded"):  # parts 3 and 4: a fused epoch of 8 steps at B=4, 32 images
        assert len(got[part]["losses"]) == 8 and np.isfinite(got[part]["losses"]).all()
    assert got["sharded"]["held_rows"] == 16 and got["fused"]["held_rows"] == 32
    np.testing.assert_allclose(got["sharded"]["losses"], got["fused"]["losses"], rtol=1e-6)


def test_dryrun_multichip_flat_corpus_on_two_gloo_ranks(planar_dryrun):
    """Dry runs 3 and 4 over the corpus held as NHWC rows (K3's gather):
    the same losses and weights as over the planar corpus, bit for bit."""
    from object_detection_cib_torch.entry import dryrun_multichip

    got = dryrun_multichip(2, device_type="cpu", join_timeout_s=JOIN, corpus_layout="flat")
    assert got["sharded"]["held_rows"] == 16 and got["fused"]["held_rows"] == 32
    for part in ("fused", "sharded"):
        assert got[part]["losses"] == planar_dryrun[part]["losses"], part
        assert got[part]["digest"] == planar_dryrun[part]["digest"], part


def test_entry_forward_matches_jax_entry_on_converted_weights():
    """The JAX ``entry()``'s network (``__graft_entry__.py``: yolov5s, nc=10,
    bf16, ``init`` from ``PRNGKey(0)``, ``apply(..., train=False)``), its
    variables made by a jitted ``init`` on a 64 px input (the parameters do
    not depend on the input's size; the entry's own eager ``init`` at 640
    px takes ~35 s on a CPU), converted into the port's ``entry()``."""
    import jax
    import jax.numpy as jnp

    from object_detection_cib_torch.entry import entry
    from object_detection_cib_torch.models.convert import flax_to_torch
    from object_detection_cib_tpu.models.yolov5 import build_network as j_build

    jnet = j_build(num_classes=10, size="s", dtype=jnp.bfloat16)
    variables = jax.jit(lambda k, x: jnet.init(k, x, train=False))(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    fn, (example,) = entry(device="cpu")
    assert tuple(example.shape) == (8, 640, 640, 3) and next(fn.parameters()).dtype == torch.float32
    fn.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, dict(variables))))
    images = np.random.default_rng(0).random((2, 128, 128, 3), np.float32)
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, jnp.asarray(images))
    with torch.no_grad():
        got = fn(torch.from_numpy(images))
    for g, w in zip(got.levels(), want.levels()):
        w = np.asarray(w.raw, np.float32)
        assert g.raw.dtype == torch.bfloat16 and tuple(g.raw.shape) == w.shape
        err = np.abs(g.raw.float().numpy() - w).max()
        assert err <= 2.0**-7 * max(1.0, np.abs(w).max()), err  # one bf16 rounding of the largest value


def test_entry_module_imports_without_jax():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'object_detection_cib_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import object_detection_cib_torch.entry as e\n"
            "print(e.entry.__name__, e.dryrun_multichip.__name__)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["entry", "dryrun_multichip"]
