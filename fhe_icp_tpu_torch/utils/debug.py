"""Environment preflight and memory monitoring on the card.

`check_environment` reports the host (Python, RAM, CPUs, this process's
RSS), the packages, PyTorch's CUDA runtime and the card (name, compute
capability, memory, power limit), the `nvcc` that builds the kernels, and
the environment variables the port reads; `KNOWN_ISSUES` is a playbook of
failures and their fixes.  `@memory_monitor` logs a call's Python
allocation peak (tracemalloc), its RSS change and, on the card, its peak
device memory.
"""

from __future__ import annotations

import functools
import logging
import os
import platform
import subprocess
import tracemalloc
from typing import Callable, Dict, Optional

import torch

logger = logging.getLogger(__name__)

# Failure -> fix playbook.
KNOWN_ISSUES = {
    "uint32 operator not implemented": (
        "PyTorch supports uint32 tensors in little beyond .to, view, cat/stack "
        "and copies (on the card no where, no advanced indexing, no "
        "comparisons): compute in int64 and cast back, as ops/modmath.py does."),
    "nvcc not found": (
        "The kernels are built from fhe_icp_tpu_torch/csrc/ by nvcc for sm_90a "
        "at the first launch: install the CUDA toolkit or set CUDA_HOME."),
    "ptxas reports a stack frame": (
        "A kernel indexes a by-value argument or a register array with a "
        "runtime index, and copies it per thread; read build/kernels/build.log "
        "(chip_smoke.py fails on any K2 instance with a stack frame)."),
    "hub download errors": (
        "No egress: BERT weights must be on disk.  The pipeline falls back to "
        "the deterministic hashing embedder; set FHE_ALLOW_DOWNLOAD=1 only on "
        "connected machines."),
    "decryption garbage": (
        "Noise budget exhausted: check ops.noise.noise_budget_bits; use a "
        "preset with more limbs (e.g. mult-8192) for ct x ct chains."),
    "master password rejected": (
        "FHE_MASTER_PASSWORD does not match the salt in the key directory; "
        "remove the key directory to start again (its keys are lost)."),
}

RELEVANT_ENV = ("CUDA_HOME", "CUDA_VISIBLE_DEVICES", "FHE_MASTER_PASSWORD",
                "FHE_ALLOW_DOWNLOAD", "HF_HOME", "OMP_NUM_THREADS")


def _run(cmd) -> Optional[str]:
    """A command's output, stripped, or None if it cannot run."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def check_environment(verbose: bool = True) -> Dict:
    """Probe the host, the packages, the card and the toolchain."""
    info: Dict = {"platform": platform.platform(), "python": platform.python_version()}
    try:
        import psutil
        vm = psutil.virtual_memory()
        info["ram_gb"] = round(vm.total / 1e9, 1)
        info["ram_available_gb"] = round(vm.available / 1e9, 1)
        info["cpu_count"] = psutil.cpu_count()
        info["rss_mb"] = round(psutil.Process().memory_info().rss / 2 ** 20, 1)
    except ImportError as e:
        info["psutil_error"] = str(e)

    for pkg in ("torch", "numpy", "transformers", "cryptography", "triton"):
        try:
            info[f"{pkg}_version"] = __import__(pkg).__version__
        except ImportError:
            info[f"{pkg}_version"] = None

    info["cuda_runtime"] = torch.version.cuda
    info["cuda_available"] = torch.cuda.is_available()
    if info["cuda_available"]:
        props = torch.cuda.get_device_properties(0)
        info["device_count"] = torch.cuda.device_count()
        info["device_name"] = props.name
        info["compute_capability"] = f"{props.major}.{props.minor}"
        info["device_memory_gb"] = round(props.total_memory / 1e9, 1)
        info["power_limit"] = _run(["nvidia-smi", "--query-gpu=power.limit",
                                    "--format=csv,noheader", "--id=0"])
    from ..kernels import _nvcc
    try:
        info["nvcc"] = _nvcc()
    except RuntimeError as e:
        info["nvcc"], info["nvcc_error"] = None, str(e)
    else:
        out = _run([info["nvcc"], "--version"]) or ""
        info["nvcc_version"] = next((ln.strip() for ln in out.splitlines()
                                     if "release" in ln), None)

    info["env"] = {k: ("<set>" if k == "FHE_MASTER_PASSWORD" else v)
                   for k in RELEVANT_ENV if (v := os.environ.get(k)) is not None}
    if verbose:
        for k, v in info.items():
            logger.info("%s: %s", k, v)
    return info


def memory_monitor(fn: Callable) -> Callable:
    """Decorator: log the tracemalloc peak, the RSS change and, where there
    is a card, the peak device memory around a call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            import psutil
            rss0 = psutil.Process().memory_info().rss
        except ImportError:
            psutil, rss0 = None, None
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        tracemalloc.start()
        try:
            return fn(*args, **kwargs)
        finally:
            current, peak = tracemalloc.get_traced_memory()
            tracemalloc.stop()
            msg = (f"{fn.__name__}: python alloc current={current / 1e6:.1f}MB "
                   f"peak={peak / 1e6:.1f}MB")
            if rss0 is not None:
                msg += f" rss_delta={(psutil.Process().memory_info().rss - rss0) / 1e6:+.1f}MB"
            if cuda:
                msg += f" device_peak={torch.cuda.max_memory_allocated() / 1e6:.1f}MB"
            logger.info(msg)

    return wrapper


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    check_environment()
