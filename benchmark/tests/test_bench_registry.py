"""The benchmark's files load, keep to the contract's names and units, and
a cell, a configuration and a metric can each be added as new files."""

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from harness import registry

BENCH = registry.BENCH_DIR
SPEC = json.loads((registry.CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
LINE = re.compile(r"[^\t\n\r]{1,200}\Z")
# a network family of two convolutions, with every name a family module gives
STUB_FAMILY = '''"""A two-layer detector: a strided 3x3 conv and a 1x1 head."""
import torch

from counts.bn_silu import bn_elements as _bn
from counts.flops import conv_flops as _flops

KEYS = ("nc", "width")


class Net(torch.nn.Module):
    def __init__(self, nc, width):
        super().__init__()
        self.stem = torch.nn.Conv2d(3, width, 3, 2, 1)
        self.head = torch.nn.Conv2d(width, 5 + nc, 1)

    def set_quant(self, on):
        pass

    def forward(self, images):
        return (self.head(self.stem(images.permute(0, 3, 1, 2))).permute(0, 2, 3, 1),)


def reference(cfg):
    return Net(cfg["nc"], cfg["width"])


def weights(seed, cfg, device):
    return reference(cfg).to(device).state_dict()


def calibrated(cfg, state, images):
    return state


def trainer_keywords(cfg):
    return {}


def eval_network(cfg, device):
    raise NotImplementedError("the program has no such network")


def train_steps(cfg, net, batches, steps_per_epoch, size):
    raise NotImplementedError


def decode(cfg, heads):
    raise NotImplementedError


def conv_flops(cfg, size):
    return _flops(reference(cfg).to("meta"), size, torch.nn.Conv2d)


def bn_elements(cfg, size):
    return _bn(reference(cfg).to("meta"), size, torch.nn.BatchNorm2d)


def parameters(cfg):
    return sum(p.numel() for p in reference(cfg).parameters())
'''


def test_spec_keys_and_lengths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and (registry.CHECKOUT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and LINE.match(w["why"]) and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"]) and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("end_to_end", "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads_and_reports(cell):
    w = registry.workload(cell)
    listed = next(x for x in SPEC["workloads"] if x["name"] == cell)
    assert w["config"] == listed["config"] and w["chips"] == listed["chips"] and w["why"] == listed["why"]
    e2e = registry.metrics_for(cell, SPEC, traced=False)
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = registry.metrics_for(cell, SPEC, traced=True)
    assert layer
    for name in layer:
        assert callable(registry.reader(name))
        assert registry.reader(name)(None) is None


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_each_config_loads(config):
    cfg = registry.config(config)
    listed = next(x for x in SPEC["configs"] if x["name"] == config)
    assert cfg["source"] == listed["source"] and cfg["reduced"] == listed["reduced"]
    assert {"corpus_images", "boxes_per_image", "zipf_a", "batchnorm_scale"} <= set(cfg["assumed"])


def test_every_metric_has_a_reader_file_and_no_stray_reader():
    assert set(registry.names("metrics")) == {m["name"] for m in SPEC["per_layer"]}


def test_added_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "yolov5s.json").read_text())
    cfg.update(depth_multiple=0.67, width_multiple=0.75, source="https://github.com/ultralytics/yolov5/blob/v6.0/models/yolov5m.yaml")
    (root / "configs" / "yolov5m.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "train.yolov5s.416.b64.json").read_text())
    cell.update(config="yolov5m", why="a cell added as a file")
    (root / "workloads" / "train.yolov5m.416.b64.json").write_text(json.dumps(cell))
    (root / "metrics" / "steps_traced.py").write_text("def read(record):\n    return None if not record else record['steps']\n")
    (root / "networks" / "tinynet.py").write_text(STUB_FAMILY)
    (root / "configs" / "tinydet.json").write_text(json.dumps(dict(
        source="https://example.org/tinydet", reduced=[], network="tinynet", nc=3, width=8,
        assumed={"corpus_images": 32, "boxes_per_image": [1, 9], "zipf_a": 1.01, "batchnorm_scale": 1.0})))
    (root / "workloads" / "train.tinydet.64.b8.json").write_text(json.dumps(dict(cell, config="tinydet")))
    assert "train.yolov5m.416.b64" in registry.names("workloads", root)
    assert {"yolov5m", "tinydet"} <= set(registry.names("configs", root))
    assert "steps_traced" in registry.names("metrics", root)
    w = registry.workload("train.yolov5m.416.b64", root)
    assert w["model"]["depth_multiple"] == 0.67 and w["kind"] == "train"
    assert registry.family(w["model"]).conv_flops(w["model"], 416) > 0
    tiny = registry.workload("train.tinydet.64.b8", root)["model"]
    net = registry.family(tiny)
    assert Path(tiny["network_file"]) == root / "networks" / "tinynet.py"
    assert net.parameters(tiny) == 3 * 8 * 9 + 8 + 8 * (5 + 3) + (5 + 3)
    assert net.conv_flops(tiny, 64) == 2 * (32 * 32 * 8 * 27 + 32 * 32 * 8 * 8)
    assert net.bn_elements(tiny, 64) == (0, 0)
    assert net.reference(tiny)(torch.rand(2, 64, 64, 3))[0].shape == (2, 32, 32, 8)
    assert registry.reader("steps_traced", root)({"steps": 20}) == 20
    spec = dict(SPEC, per_layer=SPEC["per_layer"] + [
        {"name": "steps_traced", "unit": "steps", "better": "higher", "source": "host_clock", "layer": "device",
         "moves": "train_img_s", "workloads": ["train.yolov5m.416.b64"]}])
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["train.yolov5m.416.b64"])
                          if m["name"] == "train_img_s" else m for m in SPEC["end_to_end"]]
    assert registry.metrics_for("train.yolov5m.416.b64", spec, traced=True) == {"steps_traced": "steps"}
    assert set(registry.metrics_for("train.yolov5m.416.b64", spec, traced=False)) == {"train_img_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} changed"


def test_a_network_without_its_family_file_is_refused(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "yolov5s.json").read_text())
    (root / "configs" / "yolov8l.json").write_text(json.dumps(dict(cfg, network="yolov8")))
    with pytest.raises(FileNotFoundError, match=re.escape(str(root / "networks" / "yolov8.py"))):
        registry.config("yolov8l", root)
    (root / "configs" / "bad.json").write_text(json.dumps(dict(cfg, network="../yolov5")))
    with pytest.raises(ValueError, match="not a valid name"):
        registry.config("bad", root)
    del cfg["width_multiple"]
    (root / "configs" / "nowidth.json").write_text(json.dumps(cfg))
    with pytest.raises(KeyError, match="width_multiple"):
        registry.config("nowidth", root)


def test_a_cell_with_its_own_recipe_and_window_is_added_as_files(tmp_path):
    """A cell that changes the recipe (the augment's ranges, the step loop
    for the fused epoch) and a new kind of window are files alone."""
    from harness import train_cell

    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cell = json.loads((root / "workloads" / "train.yolov5s.416.b64.json").read_text())
    cell.update(aug=dict(cell["aug"], hue=0.0, scale=0.25), program={"fused_epoch": False},
                why="the step loop with a narrower scale and no hue jitter")
    (root / "workloads" / "train.yolov5s.416.b64.steploop.json").write_text(json.dumps(cell))
    (root / "harness" / "probe_cell.py").write_text('"""A window of another kind."""\n')
    (root / "workloads" / "probe.yolov5s.json").write_text(json.dumps(dict(cell, kind="probe")))
    w = registry.workload("train.yolov5s.416.b64.steploop", root)
    assert train_cell.aug(w).hue == 0.0 and train_cell.aug(w).scale == 0.25
    assert train_cell.program_keywords(w) == {"fused_epoch": False}
    assert "probe" in registry.kinds(root) and registry.workload("probe.yolov5s", root)["kind"] == "probe"
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} changed"


def test_a_recipe_the_reference_does_not_follow_is_refused():
    from harness import train_cell

    cell = dict(registry.workload("train.yolov5s.416.b64"), program={"mixup_prob": 0.3})
    with pytest.raises(ValueError, match="mixup_prob"):
        train_cell.program_keywords(cell)
    with pytest.raises(ValueError):
        registry.window("nothing")


def test_trace_readers_take_whole_launches_inside_the_window():
    """train_mfu: the step's FLOPs over the marker kernel's period; a
    roofline: the launches wholly inside the window, over their time."""
    from counts.bytes import hsv_planar
    from counts.peaks import BF16_FLOPS, HBM_BYTES

    k4 = hsv_planar(64, 416) / HBM_BYTES  # K4 at its bound
    kernels = [("gather_rows_kernel", 0.1 * i, 0.1 * i + 0.01) for i in range(-1, 6)]
    kernels += [("hsv_planar_kernel", 0.1 * i + 0.02, 0.1 * i + 0.02 + 2 * k4) for i in range(5)]
    kernels += [("hsv_planar_kernel", 0.49, 0.49 + 2 * k4)]  # past the window's end: not counted
    record = {"kind": "train", "kernels": kernels, "window_s": 0.5, "step_kernel": "gather_rows_kernel",
              "step_flops": 1e12, "chips": 1, "batch": 64, "image_size": 416}
    assert registry.reader("train_mfu")(record) == pytest.approx(100.0 * 1e12 / 0.1 / BF16_FLOPS)
    assert registry.reader("k4_hsv_roofline")(record) == pytest.approx(50.0)
    assert registry.reader("k1_nms_roofline")(record) is None


@pytest.mark.parametrize("bad", ["has space", "a/b", "", "x" * 65, "é"])
def test_names_outside_the_alphabet_are_refused(bad):
    with pytest.raises(ValueError):
        registry.check_name(bad)
