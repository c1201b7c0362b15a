"""The kernel build keeps its log, and the smoke script reads K2's ptxas lines."""

import os

import pytest

from fhe_icp_tpu_torch import kernels

K2_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116ntt_block_kernelILb1ELb1ELi16EEEv4Args' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116ntt_block_kernelILb1ELb1ELi16EEEv4Args
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _ZN12_GLOBAL__N_115ntt_warp_kernelILb0ELb0ELi4EEEv4Args
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 31 registers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z17all_to_all_kernelv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 384 bytes cmem[0]
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc/ with one source and a build/ dir in tmp_path, in place of the package's."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    monkeypatch.setattr(kernels, "LIB_PATH", build / "libfhe_kernels.so")
    monkeypatch.setattr(kernels, "LOG_PATH", build / "build.log")
    monkeypatch.setattr(kernels, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    return csrc, build


def _touch_newer(path, than):
    path.write_bytes(b"")
    t = than.stat().st_mtime + 10
    os.utime(path, (t, t))


@pytest.mark.parametrize("case", ["up to date", "log missing", "source newer"])
def test_build_returns_the_kept_log_or_rebuilds(tree, case):
    """An up-to-date library returns the log of the build that made it; a
    library without its log, or older than a source, is built again."""
    csrc, build = tree
    lib, log = build / "libfhe_kernels.so", build / "build.log"
    _touch_newer(lib, csrc / "k.cu")
    if case != "log missing":
        log.write_text(K2_LOG)
    if case == "source newer":
        _touch_newer(csrc / "k.cu", lib)
    if case == "up to date":
        assert kernels.build() == K2_LOG
    else:
        with pytest.raises(RuntimeError, match="nvcc"):
            kernels.build()


def test_ptxas_report_names_k2_instances():
    import chip_smoke
    report = chip_smoke.ptxas_report(K2_LOG)
    assert report["ntt_block_kernel<1, 1, 16>"] == (64, 0)
    assert report["ntt_warp_kernel<0, 0, 4>"] == (31, 8)
    assert report["_Z17all_to_all_kernelv"] == (32, 0)
    assert len(report) == 3
