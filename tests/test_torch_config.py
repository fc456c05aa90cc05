"""Port parity: config composition and instantiation.

``object_detection_cib_torch.config`` is a copy of the JAX package's engine
over the same ``configs/`` tree. Composition must give equal dicts, exactly,
for every experiment and debug preset, the README's override spellings,
``+key``/``~key``, a group set to null and ``hydra=default`` with the clock
fixed. ``instantiate`` of every ``_target_`` in ``configs/`` gives port
objects whose fields equal the JAX objects', and the sampler partials give
the same three epochs of indices.
"""

import datetime
from pathlib import Path

import numpy as np
import pytest

from object_detection_cib_torch.config import engine as t_engine
from object_detection_cib_torch.data.synthetic import build_fake_manifest as t_manifest
from object_detection_cib_tpu.config import engine as j_engine
from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _presets(group):
    return sorted(str(p.relative_to(CONFIGS / group).with_suffix(""))
                  for p in (CONFIGS / group).rglob("*.yaml"))


CASES = (
    [[f"experiment={e}"] for e in _presets("experiment")]
    + [[f"debug={d}"] for d in _presets("debug")]
    + [
        [],
        ["experiment=yv5s", "dataset_name=coco-zipf"],
        ["experiment=imbalance/class_aware/default", "dataset_name=coco-zipf"],
        ["experiment=imbalance/repeat_factor/default", "dataset_name=coco-zipf"],
        ["experiment=yv5s", "use_loss_weights=True", "dataset_name=coco-zipf"],
        ["experiment=yv5s", "data.mixup_prob=0.3", "dataset_name=coco-zipf"],
        ["train=False", "test=True", "ckpt_path=runs/train/checkpoints/best", "dataset_name=coco-zipf"],
        ["debug=fdr", "data.fake_mode=True", "dataset_name=fake"],
        ["trainer=cpu", "debug=fdr", "dataset_name=fake", "data.pipeline=device", "data.device_cache=True"],
        ["+data.sampler.seed=7", "experiment=imbalance/class_aware/default"],
        ["+optimized_metric=map50", "~model.remat_policy", "~callbacks.model_summary"],
        ["logger=null", "callbacks=none"],
        ["experiment=null", "debug=null", "logger=csv"],
        ["callbacks=early_stopping", "callbacks.early_stopping.patience=3"],
        ["data=class_aware"],
        ["data/augmentations=albu/default", "tags=[a,b]"],
        ["hydra=default"],
        ["hydra=static", "paths.log_dir=/tmp/x"],
    ]
)


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


@pytest.mark.parametrize("overrides", CASES, ids=lambda ov: " ".join(ov) or "defaults")
def test_compose_matches_jax(overrides, monkeypatch):
    monkeypatch.setattr(datetime, "datetime", _FixedClock)  # ${now:...} of hydra=default
    got = t_engine.compose(CONFIGS, "train", overrides)
    assert got == j_engine.compose(CONFIGS, "train", overrides)
    if "hydra=default" in overrides:
        assert got["paths"]["output_dir"] == "runs/train/runs/2026-01-02_03-04-05"


def test_engine_helpers_match_jax(tmp_path):
    for p in sorted(CONFIGS.rglob("*.yaml")):
        assert t_engine.load_yaml(p) == j_engine.load_yaml(p), p
    for tree in ({"a": {"b": 3, "c": "${a.b}"}}, {"a": {"b": 3, "d": "x-${.b}"}},
                 {"a": {"b": 3}, "e": ["${a.b}", 1]}, {"a": {"b": 3}, "f": "${a}"}):
        assert t_engine.resolve_interpolations(tree) == j_engine.resolve_interpolations(tree)
    (tmp_path / "train.yaml").write_text("defaults:\n  - _self_\n  - g: one\nx: 1\n")
    (tmp_path / "g").mkdir()
    (tmp_path / "g" / "one.yaml").write_text("y: 2\n")
    for ov in ([], ["g=null"], ["+g.z=3", "x=5"]):
        assert t_engine.compose(tmp_path, "train", ov) == j_engine.compose(tmp_path, "train", ov)


def _targets(node, path=()):
    """(path, spec) of every _target_ node in a composed tree."""
    if isinstance(node, dict):
        if "_target_" in node:
            yield path, node
        for k, v in node.items():
            yield from _targets(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _targets(v, path + (i,))


def _target_files():
    return sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.rglob("*.yaml") if "_target_:" in p.read_text())


def _spec(rel: str) -> dict:
    """The composed spec of a config file that names a _target_."""
    if rel == "data/augmentations/default.yaml":  # has a defaults list: composed in place
        return j_engine.compose(CONFIGS, "train", [])["data"]["train_data_augmentor"]
    return j_engine.load_yaml(CONFIGS / rel)[0]


def _fields(obj):
    """An object's fields, recursively, for comparing objects of two packages."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return (type(obj).__name__, {k: _fields(v) for k, v in obj._asdict().items()})
    if isinstance(obj, (list, tuple)):
        return [_fields(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return (type(obj).__name__, {k: _fields(v) for k, v in vars(obj).items()
                                     if not isinstance(v, np.random.Generator)})
    return obj


@pytest.mark.parametrize("rel", _target_files())
def test_instantiate_every_target_matches_jax(rel):
    spec = _spec(rel)
    paths = [p for p, _ in _targets(spec)]
    assert paths and paths[0] == ()
    for p, node in _targets(spec):
        assert node["_target_"].startswith(t_engine.REFERENCE_PACKAGE + ".")
    got, want = t_engine.instantiate(spec), j_engine.instantiate(spec)
    if spec.get("_partial_"):  # a sampler: the same three epochs of indices
        assert got.func.__module__ == "object_detection_cib_torch.data.samplers"
        assert got.func.__name__ == want.func.__name__ and got.keywords == want.keywords
        kw = {"seed": 5} if "ClassAware" in want.func.__name__ else {}
        ts = got(t_manifest(num_classes=6, num_images=40, seed=2, zipf_a=1.01), **kw)
        js = want(j_manifest(num_classes=6, num_images=40, seed=2, zipf_a=1.01), **kw)
        for _ in range(3):
            np.testing.assert_array_equal(ts.epoch_indices(), js.epoch_indices())
        return
    assert type(got).__module__.startswith("object_detection_cib_torch.")
    assert _fields(got) == _fields(want)


def test_every_config_target_is_covered():
    """Each _target_ in configs/ sits in one of the files instantiated above."""
    named = {node["_target_"] for rel in _target_files() for _, node in _targets(_spec(rel))}
    in_tree = {line.split(":", 1)[1].strip() for p in CONFIGS.rglob("*.yaml")
               for line in p.read_text().splitlines() if line.strip().startswith(("_target_:", "- _target_:"))}
    assert named == in_tree and len(named) >= 12


def test_target_without_a_counterpart_raises_and_others_import_as_written():
    missing = t_engine.REFERENCE_PACKAGE + ".test_utils.anchor_boxes.voc_anchors"
    with pytest.raises(ImportError, match="object_detection_cib_torch.test_utils.anchor_boxes.voc_anchors"):
        t_engine.instantiate({"_target_": missing})
    from object_detection_cib_torch.parallel.mesh import make_mesh

    assert t_engine.instantiate({"_target_": t_engine.REFERENCE_PACKAGE + ".parallel.mesh.make_mesh",
                                 "_partial_": True}).func is make_mesh
    with pytest.raises(ImportError, match="has no counterpart"):
        t_engine.instantiate({"_target_": t_engine.REFERENCE_PACKAGE + ".data.samplers.NoSuchSampler"})
    od = t_engine.instantiate({"_target_": "collections.OrderedDict", "a": 1})
    assert type(od).__module__ == "collections" and od == {"a": 1}
    with pytest.raises(ModuleNotFoundError):
        t_engine.instantiate({"_target_": "no_such_module.thing"})
