"""The kernel build helpers that run without nvcc (``ops/build.py``)."""

from object_detection_cib_torch.ops import build as kbuild

# ptxas' -v report for two entries, as nvcc 12.8 prints it for sm_90a
REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11bulk_kernelPKhPh' for 'sm_90a'
ptxas info    : Function properties for _Z11bulk_kernelPKhPh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 128 bytes smem
ptxas info    : Compile time = 31.101 ms
ptxas info    : Compiling entry function '_Z10row_kernelPKhPf' for 'sm_90a'
ptxas info    : Function properties for _Z10row_kernelPKhPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compile time = 120.5 ms
"""


def test_kernel_usage_reads_registers_and_static_shared_memory():
    assert kbuild.kernel_usage(REPORT) == {
        "_Z11bulk_kernelPKhPh": (40, 128),
        "_Z10row_kernelPKhPf": (80, 0),
    }


def test_kernel_usage_of_an_empty_report():
    assert kbuild.kernel_usage("") == {}


def test_every_kernel_source_is_listed():
    assert kbuild.sources() == ["bn_silu", "gather", "hsv", "letterbox", "marks", "nms", "warp"]


def test_report_of_an_earlier_build_is_read_back(tmp_path, monkeypatch, capsys):
    # a library built before (here: stand-ins) is not rebuilt, and its kept
    # ptxas report still reaches REPORTS and the printout
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "REPORTS", {})
    lib = kbuild.library_path("gather")
    lib.write_bytes(b"")
    kbuild._report_path(lib).write_text(REPORT)
    assert kbuild.build_all(["gather"], verbose=True) == {"gather": lib}
    assert kbuild.REPORTS == {"gather": REPORT}
    assert "Used 40 registers" in capsys.readouterr().out
