"""Nothing of a run loads JAX or the JAX package, and the reference loads
nothing of the measured program (top-level module names compared whole)."""

import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "object_detection_cib_tpu"}


def _loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(BENCH), str(BENCH.parent)]))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, env=env, cwd=BENCH.parent, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(sub: str) -> list:
    return sorted(f"{sub}.{p.stem}" for p in (BENCH / sub).glob("*.py") if p.stem != "__init__")


def test_every_module_of_the_benchmark_loads_no_jax():
    imports = "\n".join(f"import {m}" for m in _modules("harness") + _modules("reference") + _modules("counts")
                        + _modules("networks"))
    readers = ("from harness import registry\n"
               "[registry.reader(n) for n in registry.names('metrics')]\n"
               "import importlib.util\n"
               "for f in ('run', 'calibrate'):\n"
               "    s = importlib.util.spec_from_file_location(f, registry.BENCH_DIR / (f + '.py'))\n"
               "    s.loader.exec_module(importlib.util.module_from_spec(s))\n")
    program = "import object_detection_cib_torch.train.trainer, object_detection_cib_torch.data.device_pipeline\n"
    loaded = _loaded(imports + "\n" + readers + program)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    """Nor does a network family until it builds the program's objects."""
    loaded = _loaded("\n".join(f"import {m}" for m in _modules("reference") + _modules("counts")
                                + _modules("networks")))
    assert "object_detection_cib_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_no_file_of_the_reference_names_the_program():
    for p in list((BENCH / "reference").glob("*.py")) + list((BENCH / "counts").glob("*.py")):
        text = p.read_text()
        assert "import object_detection_cib" not in text and "from object_detection_cib" not in text, p
