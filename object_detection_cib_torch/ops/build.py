"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is CUDA C++ for sm_90a with a plain C interface. ``build_all``
compiles every source with its own ``nvcc`` process, all started together,
into ``build/kernels/`` at the root of the checkout; ``load(name)`` returns
the ``ctypes`` library of ``csrc/<name>.cu``, building it first if needed,
once per process. A library's file name carries a hash of its source and
the flags, so an edited source is never served by a stale build.

Every kernel is compiled with ``--fmad=false``: the plain PyTorch versions
round after every multiply and add, and the kernels are held to them
bitwise, so no multiply-add may be contracted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
REPORTS: Dict[str, str] = {}  # ptxas' report per source, filled by build_all(verbose=True)


def sources() -> List[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    src = (csrc / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libodcib_{name}_{tag}.so"


def build_all(names: Optional[List[str]] = None, verbose: bool = False,
              csrc: Path = CSRC) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet.

    One ``nvcc`` per source, all running at once. Each compiler's register
    and shared-memory report (``-Xptxas -v``) is kept beside its library;
    with ``verbose`` the named sources' reports, whenever they were built,
    are printed and kept in ``REPORTS``. ``csrc`` is the directory of the
    sources (another checkout's, to time its kernels beside these). Raises
    if any compile fails.
    """
    names = sources() if names is None else list(names)
    out = {n: library_path(n, csrc) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for n in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(csrc / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for n, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{err}")
                continue
            _report_path(out[n]).write_text(err)
            os.replace(tmp, out[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    if verbose:
        for n in names:
            report = _report_path(out[n])
            REPORTS[n] = report.read_text() if report.exists() else ""
            print(f"[nvcc {n}.cu]\n{REPORTS[n]}", end="")
    return out


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def kernel_usage(report: str) -> Dict[str, Tuple[int, int]]:
    """(registers per thread, static shared bytes) per kernel entry in a
    ptxas report, keyed by the mangled entry name."""
    usage, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and entry:
            usage[entry] = (int(m.group(1)), int(m.group(2) or 0))
            entry = None
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _libs[name] = lib
    return lib


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
