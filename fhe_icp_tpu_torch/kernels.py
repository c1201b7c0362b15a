"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a`, one process per
source, all started together, then linked into one shared library with a
plain C interface (`build/kernels/libfhe_kernels.so` at the repo root,
with nvcc's output beside it in `build.log`).
The library is loaded with `ctypes`; no PyTorch header is compiled, so a
build takes seconds.  It is built once, at the first launch, and again
only when a source is newer than the library.

Each C entry point launches its kernel on the stream it is given (K1's
also transposes the query digits there first) and returns
`cudaGetLastError()`; `check` raises on anything but 0, so a refused
launch never passes silently.  Wrappers launch inside `launch_on(device)`,
which makes the tensor's card current.  Nothing links against `libcuda`:
the TMA descriptors of K1 and of the fastdot product are encoded by a
driver function that `csrc/tma_sm90.cuh`, the TMA plumbing both kernels
include, fetches through the runtime.

`launches` counts, per kernel, the launches made by the wrappers in
`ops/ntt_cuda.py`, `ops/pack_cuda.py`, `ops/keyswitch_cuda.py`,
`ops/fastdot_cuda.py`, `ops/modswitch_cuda.py` and `parallel/ici.py`; it
lets a caller show that a run went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libfhe_kernels.so"
LOG_PATH = BUILD_DIR / "build.log"     # nvcc's output for the library beside it
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types (pointers and the stream as c_void_p).
_SIGNATURES = {
    "fhe_ntt_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fhe_ntt_inv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fhe_ntt_cyclic_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fhe_ntt_cyclic_inv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fhe_pack_score": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fhe_all_to_all": [_P, _P, _I, _P, _I, _L, _P],
    "fhe_enable_peer_access": [_I, _I],
    "fhe_keyswitch_inner": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fhe_fastdot_product": [_P, _P, _P, _I, _I, _I, _P],
    "fhe_modswitch_lift": [_P] * 9 + [_I, _I, _I, _P],
    "fhe_modswitch_tail": [_P] * 6 + [_I, _I, _I, _P],
    "fhe_decrypt_coeff": [_P] * 14 + [_I] * 6 + [_P],
}

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (set CUDA_HOME)")


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH if it is missing or stale.

    Returns the compiler's output (ptxas register, stack and shared-memory
    report) of the build that made the library: this one's, or the one kept
    in LOG_PATH when the library was up to date.
    """
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(f.stat().st_mtime for f in sources + sorted(CSRC.glob("*.cuh")))
    if (LIB_PATH.exists() and LOG_PATH.exists()
            and LIB_PATH.stat().st_mtime >= newest):
        return LOG_PATH.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    log = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    LOG_PATH.write_text("".join(log))
    os.replace(tmp, LIB_PATH)
    return "".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fhe_error_string.argtypes = [ctypes.c_int]
            lib.fhe_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        msg = load().fhe_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


class launch_on:
    """`with launch_on(device) as stream:` makes `device` current for a launch
    and gives its current stream's handle.

    The default stream's handle is 0, which CUDA reads as the default
    stream of whichever device is current: a launch for a tensor on another
    card than the current one must make that card current first.  When it
    already is, nothing is switched (the common case, and the cheap one);
    the handle comes from `_cuda_getCurrentRawStream`, which builds no
    Stream object: at the four-step NTT's sizes a launch costs less on the
    card than its wrapper does on the host.
    """

    def __init__(self, device):
        self.index = device.index
        self.guard = None

    def __enter__(self) -> int:
        import torch
        if torch.cuda.current_device() != self.index:
            self.guard = torch.cuda.device(self.index)
            self.guard.__enter__()
        return torch._C._cuda_getCurrentRawStream(self.index)

    def __exit__(self, *exc) -> None:
        if self.guard is not None:
            self.guard.__exit__(*exc)
