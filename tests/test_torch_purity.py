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
