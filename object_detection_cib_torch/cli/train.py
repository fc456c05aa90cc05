"""Training CLI, the port of the JAX package's ``cli/train.py`` (parity:
kod/cli/hydra_train.py). It composes the repo's ``configs/`` and runs
``train/trainer.py:train`` on the card (``trainer.platform`` null) or, with
``trainer=cpu``, on the CPU:

  python -m object_detection_cib_torch.cli.train experiment=yv5s \
      dataset_name=coco-zipf data.mixup_prob=0.3 use_loss_weights=True
  python -m object_detection_cib_torch.cli.train train=False test=True \
      ckpt_path=runs/train/checkpoints/best
  python -m object_detection_cib_torch.cli.train -m seed=1,2 optimized_metric=map50 ...

``-m``/``--multirun`` runs the cartesian product of comma-separated values
one job after another and writes ``<output_dir>/multirun/summary.json``;
the job with the largest ``optimized_metric`` is printed as "max" (the JAX
launcher calls it "best", which is wrong for a metric to minimize).

Several cards: ``trainer.num_devices`` N > 1 (``trainer=mesh`` sets null,
every visible card; ``trainer=mesh_sim`` 8 gloo ranks on the CPU) makes a
job spawn N ranks, one process per card (``parallel/distributed.py:
launch``), each running the same composed config as one rank of a
data-parallel run whose ``data.batch_size`` is the global batch
(``train/trainer.py``). The job returns rank 0's result; a rank that fails
fails the job. As in the JAX CLI, ``KOD_COORDINATOR_ADDRESS`` joins a
group from the environment, which the trainer then refuses (several hosts
are a later slice, ROADMAP A).

Run as a program, the CLI binds tensorboard to its no-TensorFlow stub
before anything imports it (``utils/loggers.py:
tensorboard_without_tensorflow``), so the default ``logger=many_loggers``
loads neither TensorFlow nor JAX; ``main`` called from Python leaves that
binding to its caller.
"""

from __future__ import annotations

import itertools
import json
import sys
import traceback
import warnings
from pathlib import Path

from object_detection_cib_torch.config import compose
from object_detection_cib_torch.parallel.distributed import is_main_process, launch, maybe_initialize_from_env
from object_detection_cib_torch.train.trainer import get_metric_value, num_devices_from_cfg, train
from object_detection_cib_torch.utils.loggers import tensorboard_without_tensorflow

DEFAULT_CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def _sweep_dims(argv):
    """Split overrides into fixed ones and comma-list sweep dimensions
    (hydra -m semantics: ``a=1,2 b=x,y`` -> 4 jobs; bracketed values like
    ``tags=[a,b]`` are single values, not sweeps)."""
    fixed, dims = [], []
    for a in argv:
        if "=" in a and not a.startswith("-"):
            k, v = a.split("=", 1)
            if "," in v and not v.lstrip().startswith(("[", "{")):
                dims.append((k, v.split(",")))
                continue
        fixed.append(a)
    return fixed, dims


def multirun(config_dir, fixed, dims):
    """Sequential sweep (parity: hydra's basic launcher under ``-m``): job i
    of the cartesian product runs with output_dir ``<base>/multirun/<i>``; a
    failing job is recorded and the sweep goes on; the summary is printed
    and written to ``<base>/multirun/summary.json``."""
    base_cfg = compose(config_dir, "train", fixed + [f"{k}={vs[0]}" for k, vs in dims])
    base_out = base_cfg.get("paths", {}).get("output_dir", "runs/train")
    jobs = list(itertools.product(*[[(k, v) for v in vs] for k, vs in dims]))
    results = []
    for i, combo in enumerate(jobs):
        ov = [f"{k}={v}" for k, v in combo]
        print(f"── multirun job {i}/{len(jobs) - 1}: {','.join(ov)}", flush=True)
        cfg = compose(config_dir, "train", fixed + ov + [f"paths.output_dir={base_out}/multirun/{i}"])
        try:
            r = run_job(cfg)
            results.append({"job": i, "overrides": ov, "metric": None if isinstance(r, dict) else r,
                            "metrics": r if isinstance(r, dict) else None})
        except Exception as e:  # one failing point must not kill the sweep
            print(f"multirun job {i} FAILED: {e!r}", flush=True)
            results.append({"job": i, "overrides": ov, "error": repr(e)[:300]})
    out = Path(base_out) / "multirun"
    out.mkdir(parents=True, exist_ok=True)
    (out / "summary.json").write_text(json.dumps(results, indent=2))
    print("── multirun summary")
    for r in results:
        tail = (f"metric={r['metric']}" if r.get("metric") is not None
                else (f"ERROR {r['error']}" if "error" in r else "done"))
        print(f"  job {r['job']}: {','.join(r['overrides'])}  {tail}")
    scored = [r for r in results if r.get("metric") is not None]
    if scored:
        top = max(scored, key=lambda r: r["metric"])
        print(f"  max: job {top['job']} ({','.join(top['overrides'])}) = {top['metric']}")
    return results


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = DEFAULT_CONFIG_DIR
    if argv and argv[0].startswith("--config-dir="):
        config_dir = Path(argv.pop(0).split("=", 1)[1])
    import torch

    maybe_initialize_from_env("cuda" if torch.cuda.is_available() else "cpu")
    if "-m" in argv or "--multirun" in argv:
        argv = [a for a in argv if a not in ("-m", "--multirun")]
        fixed, dims = _sweep_dims(argv)
        if dims:
            return multirun(config_dir, fixed, dims)
    return run_job(compose(config_dir, "train", argv))


def run_job(cfg):
    """One run of ``train(cfg)`` under the ``extras`` (warnings filter, tag
    enforcement, the config tree), in this process or, for
    ``trainer.num_devices`` > 1, in one spawned process per rank; returns
    the ``optimized_metric`` when one is named, else the metric dict. A
    failure writes ``error.log`` to the output directory and is raised
    again."""
    extras = cfg.get("extras") or {}
    if extras.get("ignore_warnings"):
        warnings.filterwarnings("ignore")
    if extras.get("enforce_tags") and not cfg.get("tags"):
        raise ValueError("extras.enforce_tags=True but no tags provided — pass 'tags=[...]' "
                         "(ref hydra_utils/rich.py enforce_tags)")
    if extras.get("print_config", cfg.get("print_config", True)) and is_main_process():
        import yaml

        print("── config " + "─" * 50)
        print(yaml.safe_dump(cfg, default_flow_style=False, sort_keys=False))
        print("─" * 60, flush=True)
    try:
        tcfg = cfg.get("trainer") or {}
        ranks = num_devices_from_cfg(tcfg)
        if ranks > 1:
            device_type = "cpu" if tcfg.get("platform") == "cpu" else "cuda"
            metrics = launch(_rank_job, ranks, (cfg,), device_type=device_type)[0]
        else:
            metrics = train(cfg)
        opt_name = cfg.get("optimized_metric")
        if opt_name:
            value = get_metric_value(metrics, opt_name)
            if is_main_process():
                print(f"optimized_metric {opt_name}={value}", flush=True)
            return value
        return metrics
    except Exception:
        out_dir = Path(cfg.get("paths", {}).get("output_dir", "."))
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "error.log").write_text(traceback.format_exc())
        raise


def _rank_job(mesh, cfg):
    """One rank of a job, the entry point of its process: ``train(cfg,
    mesh)`` with tensorboard bound to its no-TensorFlow stub (as the CLI
    program binds it) and, on the CPU, this rank's ``torch.set_num_threads``
    share of the host's cores."""
    tensorboard_without_tensorflow()
    if mesh.device.type == "cpu":
        import os

        import torch

        torch.set_num_threads(max(min(torch.get_num_threads(), (os.cpu_count() or 1) // mesh.size), 1))
    return train(cfg, mesh)


if __name__ == "__main__":
    tensorboard_without_tensorflow()
    main()
