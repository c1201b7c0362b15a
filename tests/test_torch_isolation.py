"""The port stands alone: no JAX, nothing of the JAX package, card by default."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "fhe_icp_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'fhe_icp_tpu' or m.startswith('fhe_icp_tpu.')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(MODULES) >= 15


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PKG.rglob("*") if p.is_file()
                                        and p.suffix in (".py", ".cu", ".cuh")))
def test_no_reference_in_sources(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"fhe_icp_tpu(?!_torch)", text)


def test_runtime_defaults_to_the_card():
    from fhe_icp_tpu_torch.ops.runtime import FheRuntime
    if torch.cuda.is_available():
        assert FheRuntime("test-512").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FheRuntime("test-512")
    assert FheRuntime("test-512", device="cpu").ctx.p.device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for CPU tensors."""
    from fhe_icp_tpu_torch.ops import ntt_cuda, pack_cuda
    from fhe_icp_tpu_torch.ops.context import CryptoContext
    from fhe_icp_tpu_torch.ops.params import get_params
    ctx = CryptoContext(get_params("test-512"))
    x = torch.zeros((2, ctx.n), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError):
        ntt_cuda._launch(ctx.plan, x, forward=True)
    a = torch.zeros((2, 4, 2 * ctx.n), dtype=torch.int8, device="meta")
    v = torch.zeros((2, 2 * ctx.n, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        pack_cuda.packed_score_residues(ctx, a, v, 2, 4)
