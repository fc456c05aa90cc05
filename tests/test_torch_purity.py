"""The port stands alone: no JAX, flax or JAX-package import, and no silent CPU.

Scans the port's sources and ``chip_smoke.py`` for such imports, imports
every module of the port in a fresh interpreter where ``jax`` cannot be
imported, and checks that an entry point asked for the card without one
raises instead of running on the CPU.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "object_detection_cib_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|jaxlib|optax|orbax|chex|object_detection_cib_tpu)\b"
    r"|__import__\(\s*['\"](jax|flax|object_detection_cib_tpu)"
    r"|import_module\(\s*['\"](jax|flax|object_detection_cib_tpu)",
    re.M,
)


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


COPIES = ["data/enums.py", "data/filter.py", "data/samplers.py", "data/reader.py",
          "data/host_augment.py", "data/augmentor.py", "data/synthetic.py", "data/builder.py",
          "data/pipeline.py", "utils/plots.py", "cli/data.py", "utils/loggers.py",
          "cli/inspect_sampler.py", "cli/visualize.py", "cli/train.py"]


@pytest.mark.parametrize("module", COPIES)
def test_copied_data_modules_are_scanned_and_point_at_the_port(module):
    path = PORT / module
    assert path in _sources()
    text = path.read_text()
    assert not FORBIDDEN.search(text)
    assert "object_detection_cib_tpu" not in re.sub(r'""".*?"""', "", text, flags=re.S)


@pytest.mark.parametrize("module", ["parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py"])
def test_parallel_modules_are_scanned(module):
    """The data-parallel layer is the JAX package's ``parallel/``, which
    imports JAX; its port must not."""
    path = PORT / module
    assert path in _sources() and not FORBIDDEN.search(path.read_text())


def test_no_jax_imports_in_port_sources():
    offenders = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in _sources()
        for m in FORBIDDEN.finditer(p.read_text())
    ]
    assert not offenders, offenders


def test_port_imports_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'flax', 'object_detection_cib_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import object_detection_cib_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax') for k in sys.modules)\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


# what phases 1-9 of chip_smoke.py import: none of it may need cv2, Pillow or
# matplotlib, or the host pipeline, to load (a card machine may lack them)
CARD_PATH = ["train.trainer", "data.device_pipeline", "data.val_cache", "data.synthetic",
             "data.samplers", "ops.augment", "ops.build", "ops.gather", "ops.hsv", "ops.nms",
             "ops.warp", "models.yolov5", "eval.decode", "core.nms"]


def test_card_path_imports_without_host_image_libraries():
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('cv2', 'PIL', 'matplotlib'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {CARD_PATH!r}:\n"
        "    importlib.import_module('object_detection_cib_torch.' + m)\n"
        "assert 'object_detection_cib_torch.data.pipeline' not in sys.modules\n"
        "import object_detection_cib_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('cv2', 'PIL', 'matplotlib') for k in sys.modules)\n"
        "from object_detection_cib_torch.data.reader import longest_max_size\n"
        "import numpy as np\n"
        "try:\n"
        "    longest_max_size(np.zeros((4, 8, 3), np.uint8), np.zeros((0, 4)), 16)\n"
        "except ImportError as e:\n"
        "    print('needs', e)\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "needs blocked: cv2" in proc.stdout  # the rule holds because cv2 is imported late
    assert int(proc.stdout.split()[-1]) >= 28


def test_entry_points_refuse_the_cpu_without_asking(monkeypatch):
    from object_detection_cib_torch.core.types import default_anchors
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.train.trainer import Evaluator

    net = build_network(2, "n", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_network(2, "n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(net, default_anchors(), ["a", "b"], batch_size=2)


def test_nms_kernel_wrapper_never_falls_back(monkeypatch):
    """A non-CPU tensor never reaches the plain version; meta has no kernel."""
    from object_detection_cib_torch.ops import nms

    boxes = torch.zeros(1, 8, 4, device="meta")
    live = torch.zeros(1, 8, dtype=torch.bool, device="meta")
    monkeypatch.setattr(nms, "greedy_nms_mask_plain", lambda *a: pytest.fail("fell back"))
    before = nms.greedy_nms_mask.launches
    with pytest.raises(ValueError, match="no NMS kernel"):
        nms.greedy_nms_mask(boxes, live, 0.5)
    assert nms.greedy_nms_mask.launches == before


def test_training_entry_points_refuse_the_cpu_without_asking(monkeypatch):
    from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline
    from object_detection_cib_torch.data.host_augment import AugParams
    from object_detection_cib_torch.data.synthetic import build_fake_manifest
    from object_detection_cib_torch.train.trainer import Trainer

    info = build_fake_manifest(num_classes=2, num_images=8, image_size=64, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceDataPipeline(info, 64, 2, AugParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(info, info, size="n", image_size=64, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(info, info, size="n", image_size=64, batch_size=2, pipeline="host")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceDataPipeline(info, 64, 2, AugParams(), device_cache=False)
    from object_detection_cib_torch.data.pipeline import Prefetcher

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Prefetcher(None, 2, 8)


@pytest.mark.parametrize("kernel", ["gather_rows_planar", "gather_rows_flat", "hsv_planar",
                                    "warp_quadrants"])
def test_training_kernel_wrappers_never_fall_back(monkeypatch, kernel):
    """A non-CPU tensor never reaches a plain version; meta has no kernel."""
    from object_detection_cib_torch.ops import augment, gather, hsv, warp

    meta = dict(device="meta")
    for mod, plain in ((gather, "gather_rows_plain"), (hsv, "hsv_planar_plain"),
                       (warp, "warp_quadrants_plain"), (augment, "hsv_batch")):
        monkeypatch.setattr(mod, plain, lambda *a, **k: pytest.fail("fell back"))
    calls = {
        "gather_rows_planar": lambda: gather.gather_rows_planar(
            torch.zeros(4, 3, 8, 8, dtype=torch.uint8, **meta), torch.zeros(2, dtype=torch.int32, **meta)),
        "gather_rows_flat": lambda: gather.gather_rows_flat(
            torch.zeros(4, 8, 16, dtype=torch.uint8, **meta), torch.zeros(2, dtype=torch.int32, **meta)),
        "hsv_planar": lambda: hsv.hsv_planar(torch.zeros(2, 3, 8, 8, **meta), torch.ones(2, 3, **meta)),
        "warp_quadrants": lambda: warp.warp_quadrants(
            torch.zeros(1, 4, 3, 8, 8, dtype=torch.uint8, **meta),
            *(torch.zeros(1, 4, 8, dtype=dt, **meta)
              for dt in (torch.int32, torch.float32, torch.float32) * 2)),
    }
    fn = getattr({"gather_rows_planar": gather, "gather_rows_flat": gather, "hsv_planar": hsv,
                  "warp_quadrants": warp}[kernel], kernel)
    before = fn.launches
    with pytest.raises(ValueError, match="no .* kernel for device"):
        calls[kernel]()
    assert fn.launches == before


def test_every_config_target_instantiates_with_jax_blocked():
    """Each ``_target_`` of ``configs/`` builds a port object in a fresh
    interpreter where neither JAX nor the JAX package can be imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'object_detection_cib_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from object_detection_cib_torch.config import compose, instantiate, load_yaml\n"
        "from object_detection_cib_torch.data.synthetic import build_fake_manifest\n"
        "info = build_fake_manifest(num_classes=3, num_images=12, seed=0)\n"
        "specs = [compose('configs', 'train', [])['data']['train_data_augmentor']]\n"
        "specs += [load_yaml(f'configs/data/{n}.yaml')[0] for n in ('class_aware', 'repeat_factor',\n"
        "          'augmentations/aug_params', 'augmentations/no_aug_params', 'augmentations/albu/default')]\n"
        "made = [instantiate(s) for s in specs]\n"
        "made[1](info).epoch_indices(); made[2](info).epoch_indices()\n"
        "mods = {m.func.__module__ if hasattr(m, 'func') else type(m).__module__ for m in made}\n"
        "assert all(m.startswith('object_detection_cib_torch.') for m in mods), mods\n"
        "assert not any(k.split('.')[0] in ('jax', 'object_detection_cib_tpu') for k in sys.modules)\n"
        "print(len(made))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "6"


def test_from_config_refuses_the_cpu_without_asking(monkeypatch, tmp_path):
    """``trainer.platform`` null is the card; without one the trainer raises
    instead of training on the CPU (``trainer=cpu`` asks for it)."""
    from object_detection_cib_torch.config import compose
    from object_detection_cib_torch.train.trainer import Trainer

    cfg = compose(ROOT / "configs", "train", ["experiment=yv5n", "dataset_name=fake", "data.batch_size=2",
                                              "data.target_image_size=64", f"paths.output_dir={tmp_path}"])
    assert cfg["trainer"]["platform"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer.from_config(cfg)
    assert not (tmp_path / "hparams.json").exists()


def test_cli_program_loads_neither_tensorflow_nor_jax(tmp_path):
    """``python -m object_detection_cib_torch.cli.train`` with the default
    ``logger=many_loggers`` writes TensorBoard events through tensorboard's
    no-TensorFlow stub and ends with neither TensorFlow, JAX nor the JAX
    package loaded."""
    argv = ["experiment=yv5n", "dataset_name=fake", "trainer=cpu", "debug=fdr", "model.net.dtype=null",
            "model.net.widen_factor=0.25", "data.batch_size=4", "data.target_image_size=64",
            "data.num_workers=1", "data.fake_num_images=8", "callbacks.model_summary=null",
            "print_config=False", "model.val_nms_max_candidates=256", f"paths.output_dir={tmp_path}"]
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['train', *{argv!r}]\n"
        "runpy.run_module('object_detection_cib_torch.cli.train', run_name='__main__')\n"
        "bad = sorted({k.split('.')[0] for k in sys.modules} & {'jax', 'tensorflow', 'object_detection_cib_tpu'})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "clean"
    assert list((tmp_path / "tb").glob("events.out.tfevents*"))
    assert (tmp_path / "checkpoints" / "last").is_file()
