"""Port parity: the dataset builders, the plots and the data CLI.

``data/builder.py``, ``utils/plots.py`` and ``cli/data.py`` of the port are
copies of the JAX package's. On ``tests/test_builder_cli.py``'s COCO JSON
(written by the test) both CLIs write the same manifests, and the builders
return equal manifests; ``make-synthetic`` writes the same JPEG bytes.
Exact throughout (manifests compared without their build time).
"""

import pytest

from object_detection_cib_torch.cli import data as t_cli
from object_detection_cib_torch.data import builder as tb
from object_detection_cib_torch.data.cache import deserialize_cached_dataset as t_load
from object_detection_cib_torch.utils import plots as t_plots
from object_detection_cib_tpu.cli import data as j_cli
from object_detection_cib_tpu.data import builder as jb
from object_detection_cib_tpu.data.cache import deserialize_cached_dataset as j_load
from test_builder_cli import _write_coco_json


def _same(t_info, j_info):
    """Equal manifests: the port's NamedTuples against the JAX package's."""
    assert t_info._replace(date=None) == j_info._replace(date=None)


@pytest.mark.parametrize("kw", [dict(), dict(num_classes=5, max_detections_per_image=4),
                                dict(num_classes=3, zipf_a=1.5, budget_scale=0.5, seed=2)])
def test_builders_match_jax(tmp_path, kw):
    j = _write_coco_json(tmp_path / "instances_train.json", n_classes=15, n_images=120)
    ti, ji = tb.load_coco_json(j, images_root="train"), jb.load_coco_json(j, images_root="train")
    _same(ti, ji)
    _same(tb.make_zipf_subset(ti, **kw), jb.make_zipf_subset(ji, **kw))
    ts, js = tb.do_analysis(ti, tmp_path / "t"), jb.do_analysis(ji, tmp_path / "j")
    assert ts == js
    assert ((tmp_path / "t" / f"{ti.name}-analysis.json").read_text()
            == (tmp_path / "j" / f"{ji.name}-analysis.json").read_text())


CASES = {
    "gen-cache": ["gen-cache", "--split", "train", "--name", "mycoco", "--images-root", "im"],
    "make-coco-zipf": ["make-coco-zipf", "--split", "validation", "--num-classes", "5",
                       "--max-dets", "6"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_writes_the_jax_manifest(tmp_path, case, capsys):
    j = _write_coco_json(tmp_path / "instances_train.json")
    args = CASES[case] + ["--annotations", str(j)]
    t_cli.main(args + ["--cache-dir", str(tmp_path / "t")])
    j_cli.main(args + ["--cache-dir", str(tmp_path / "j")])
    name, split = (("mycoco", "train") if case == "gen-cache" else ("coco-zipf", "validation"))
    _same(t_load(name, split, tmp_path / "t"), j_load(name, split, tmp_path / "j"))
    assert "wrote" in capsys.readouterr().out


def test_cli_make_synthetic_and_do_analysis(tmp_path, monkeypatch, capsys):
    manifests = {}
    for who, cli, load in (("t", t_cli, t_load), ("j", j_cli, j_load)):
        monkeypatch.setenv("KOD_DATA_ROOT_DIR", str(tmp_path / who))
        cli.main(["make-synthetic", "--name", "synthetic-hard-zipf", "--num-images", "6",
                  "--image-size", "64", "--seed", "4"])
        manifests[who] = load("synthetic-hard-zipf", "train")
        cli.main(["do-analysis", "--name", "synthetic-hard-zipf", "--out-dir",
                  str(tmp_path / who / "analysis")])
    _same(manifests["t"], manifests["j"])
    assert len(manifests["t"].samples) == 6
    for s in manifests["t"].samples:
        assert (tmp_path / "t" / s.image_path).read_bytes() == (tmp_path / "j" / s.image_path).read_bytes()
    assert ((tmp_path / "t" / "analysis" / "synthetic-hard-zipf-analysis.json").read_text()
            == (tmp_path / "j" / "analysis" / "synthetic-hard-zipf-analysis.json").read_text())
    assert "analysis written" in capsys.readouterr().out


def test_plots_write_images(tmp_path):
    pytest.importorskip("matplotlib")
    counts = {"a": 5, "b": 2, "c": 9}
    assert t_plots.plot_instance_histogram(counts, tmp_path / "h.png").stat().st_size > 0
    out = t_plots.plot_instances_per_class_per_epoch({0: counts, 1: counts}, tmp_path / "e.png")
    assert out.stat().st_size > 0
