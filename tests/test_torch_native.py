"""The port's native loader library: a race-free first build.

``native/libodcib.so`` is built on first use. Built in place by concurrent
processes, a process could open the half-written file and fail; the JAX
package's loader remembers that failure for the rest of the process. The
port's loader builds in a temporary directory under an ``fcntl`` lock and
publishes with ``os.replace``; the root ``conftest.py`` runs that build
before any test module is collected.
"""

import ctypes
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from object_detection_cib_torch.data import native_loader
from object_detection_cib_tpu.data import native_loader as jax_native_loader

REPO = Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent("""
    import ctypes, sys
    sys.path.insert(0, sys.argv[1])
    from object_detection_cib_torch.data import native_loader
    path = native_loader.build(sys.argv[2], sys.argv[3])
    lib = ctypes.CDLL(str(path))
    assert lib.odcib_pack_batch is not None
    print("loaded", path)
""")


def _native_copy(tmp_path, source=None):
    native = tmp_path / "native"
    native.mkdir()
    shutil.copy2(native_loader.NATIVE_DIR / "Makefile", native / "Makefile")
    if source is None:
        shutil.copy2(native_loader.NATIVE_DIR / "loader.cpp", native / "loader.cpp")
    else:
        (native / "loader.cpp").write_text(source)
    return native


def test_concurrent_first_build_loads_everywhere(tmp_path, n_procs=6):
    native = _native_copy(tmp_path)
    lock_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(REPO), str(native), str(lock_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(n_procs)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.startswith("loaded")
    # one build: nothing staged is left beside the library
    assert sorted(p.name for p in native.iterdir()) == ["Makefile", native_loader.LIB_NAME, "loader.cpp"]
    assert list(lock_dir.iterdir()) == [lock_dir / f"{native_loader.LIB_NAME}.lock"]


def test_incomplete_library_is_rebuilt(tmp_path):
    native = _native_copy(tmp_path)
    lib = native / native_loader.LIB_NAME
    lib.write_bytes(b"\x7fELF" + b"\0" * 60)  # a half-written file
    assert native_loader.build(native, tmp_path / "build") == lib
    ctypes.CDLL(str(lib))


def test_failed_build_raises_with_compiler_message(tmp_path):
    native = _native_copy(tmp_path, source="int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match=r"(?s)make exit.*error"):
        native_loader.build(native, tmp_path / "build")
    assert not (native / native_loader.LIB_NAME).exists()


def test_jax_loader_sees_the_complete_library():
    assert jax_native_loader.available()
    assert native_loader.get_lib() is native_loader.get_lib()
