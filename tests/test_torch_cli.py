"""Port parity: the training CLI and the two offline CLIs.

``object_detection_cib_torch.cli.train.main`` at a small size on the CPU
(yolov5n, 64 px, B = 4, ``trainer=cpu``): a fast dev run writes the run
files the JAX package's ``tests/test_e2e_train.py::test_fast_dev_run``
expects, and the JAX trainer writes (``checkpoints/{best,last,meta.json}``,
``csv/metrics.csv``, ``hparams.json``, ``tb/``); ``test=True ckpt_path=...``
returns a mAP dict from the restored weights; a two-job ``-m`` sweep writes
``summary.json`` and names the job with the largest metric "max";
``optimized_metric``, ``extras.enforce_tags`` and ``error.log`` behave as
the JAX CLI's. ``inspect_sampler`` writes the JAX CLI's statistics, number
for number.
"""

import json
from pathlib import Path

import pytest
import torch

from object_detection_cib_torch.cli import inspect_sampler as t_inspect
from object_detection_cib_torch.cli import train as cli
from object_detection_cib_torch.cli import visualize as t_visualize
from object_detection_cib_torch.data.cache import serialize_cached_dataset
from object_detection_cib_torch.data.synthetic import build_fake_manifest
from object_detection_cib_torch.train.checkpoint import load_state
from object_detection_cib_torch.train.trainer import Trainer, get_metric_value
from object_detection_cib_tpu.cli import inspect_sampler as j_inspect

SMALL = ["experiment=yv5n", "dataset_name=fake", "trainer=cpu", "model.net.dtype=null",
         "model.net.widen_factor=0.25", "data.batch_size=4", "data.target_image_size=64",
         "data.num_workers=1", "data.max_targets=40", "data.fake_num_images=8",
         "callbacks.model_summary=null", "extras.print_config=False", "model.val_nms_max_candidates=256"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small CPU runs gain little from torch's intra-op threads, and
    beside other test workers those threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def fdr_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("fdr")
    metrics = cli.main(SMALL + ["debug=fdr", f"paths.output_dir={out}"])
    return out, metrics


def test_fast_dev_run_writes_the_run_files(fdr_run):
    out, metrics = fdr_run
    assert 0.0 <= metrics["map"] <= 1.0 and any(k.startswith("map50_class_") for k in metrics)
    files = _files(out)
    for f in ("checkpoints/best", "checkpoints/last", "checkpoints/meta.json", "csv/metrics.csv",
              "hparams.json"):
        assert f in files
    assert any(f.startswith("tb/events.out.tfevents") for f in files)  # logger=many_loggers
    meta = json.loads((out / "checkpoints" / "meta.json").read_text())
    assert meta == {"best_value": metrics["map"], "monitor": "map"}
    assert load_state(out / "checkpoints" / "last")["optimizer"]["step_count"] == 1
    assert json.loads((out / "hparams.json").read_text())["steps_per_epoch"] == 2


def test_eval_from_checkpoint(fdr_run, tmp_path, monkeypatch):
    out, fit_metrics = fdr_run
    seen = {}
    real = Trainer.restore

    def spy(self, path):
        real(self, path)
        seen["net"], seen["step"] = self.net.state_dict(), self.optimizer.step_count

    monkeypatch.setattr(Trainer, "restore", spy)
    metrics = cli.main(SMALL + ["debug=fdr", f"paths.output_dir={tmp_path}", "train=False", "test=True",
                                f"ckpt_path={out}/checkpoints/last", "logger=csv"])
    saved = load_state(out / "checkpoints" / "last")
    assert seen["step"] == 1 and all(torch.equal(v, saved["net"][k]) for k, v in seen["net"].items())
    assert metrics.keys() == fit_metrics.keys() - {"images_per_sec"}
    assert metrics["map"] == pytest.approx(fit_metrics["map"], abs=1e-6)


def test_multirun_sweep_writes_a_summary(tmp_path, capsys):
    results = cli.main(["-m", *SMALL, "trainer.fast_dev_run=True", "seed=1,2", "optimized_metric=map50", "logger=csv",
                        f"paths.output_dir={tmp_path}/run"])
    assert [r["job"] for r in results] == [0, 1] and all("error" not in r for r in results)
    assert all(isinstance(r["metric"], float) for r in results)
    assert json.loads((tmp_path / "run" / "multirun" / "summary.json").read_text()) == results
    for i in (0, 1):
        assert (tmp_path / "run" / "multirun" / str(i) / "hparams.json").exists()
    out = capsys.readouterr().out
    assert "  max: job " in out and "best" not in out


def test_optimized_metric_and_its_errors(tmp_path):
    assert get_metric_value({"map": 0.5}, None) is None
    assert get_metric_value({"map": 0.5}, "map") == 0.5
    with pytest.raises(KeyError, match="Metric value not found"):
        get_metric_value({"map": 0.5}, "val/acc")
    value = cli.main(SMALL + ["trainer.fast_dev_run=True", "logger=csv", "+optimized_metric=map",
                              f"paths.output_dir={tmp_path}"])
    assert isinstance(value, float) and 0.0 <= value <= 1.0


def test_failures_write_error_log_and_tags_are_enforced(tmp_path):
    with pytest.raises(ValueError, match="unknown dataset 'no-such-set'"):
        cli.main(SMALL + ["dataset_name=no-such-set", f"paths.output_dir={tmp_path}"])
    assert "unknown dataset" in (tmp_path / "error.log").read_text()
    with pytest.raises(ValueError, match="enforce_tags"):
        cli.main(SMALL + ["tags=[]", f"paths.output_dir={tmp_path}"])
    with pytest.raises(FileNotFoundError, match="nope.yaml"):
        cli.main(SMALL + ["experiment=nope"])


def test_remat_and_dense_warp_train_through_the_cli(tmp_path):
    """``model.remat_policy`` and ``data.warp_pallas=False`` on the device
    pipeline's fused epoch, through ``cli.train.main``."""
    metrics = cli.main(SMALL + ["data.pipeline=device", "data.device_cache=True", "trainer.max_epochs=1",
                                "model.remat_policy=conv_out_bn_stats", "data.warp_pallas=False", "logger=csv",
                                "print_config=False", f"paths.output_dir={tmp_path}"])
    assert 0.0 <= metrics["map"] <= 1.0
    assert json.loads((tmp_path / "hparams.json").read_text())["steps_per_epoch"] == 2


def test_predict_writes_predictions(tmp_path):
    cli.main(SMALL + ["debug=fdr", "logger=csv", "train=False", "+predict=True", f"paths.output_dir={tmp_path}"])
    preds = json.loads((tmp_path / "predictions.json").read_text())
    assert len(preds) == 8 and set(preds[0]) == {"boxes", "scores", "classes"}


def test_inspect_sampler_matches_jax_and_visualize_draws(tmp_path, capsys):
    info = build_fake_manifest(name="fake", num_classes=4, num_images=24, image_size=64, seed=0, zipf_a=1.01)
    serialize_cached_dataset(info, "train", tmp_path)
    for sampler in ("shuffle", "class_aware", "repeat_factor", "repeat_factor_max"):
        args = ["--name", "fake", "--cache-dir", str(tmp_path), "--sampler", sampler, "--epochs", "3"]
        t_inspect.main(args + ["--out-dir", str(tmp_path / "t")])
        j_inspect.main(args + ["--out-dir", str(tmp_path / "j")])
        got = (tmp_path / "t" / f"{sampler}_stats.json").read_text()
        assert got == (tmp_path / "j" / f"{sampler}_stats.json").read_text()
        assert (tmp_path / "t" / f"{sampler}_hist.png").stat().st_size > 0
    t_visualize.main(["--name", "fake", "--cache-dir", str(tmp_path), "--fake", "--image-size", "64",
                      "--out", str(tmp_path / "mosaic.png")])
    assert (tmp_path / "mosaic.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
