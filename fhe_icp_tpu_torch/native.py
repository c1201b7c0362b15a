"""ctypes bindings for the C++ store codec (`native/fhestore.cpp`).

The arena is the search index's data loader: every ciphertext of a store
packed into one mmap-able file with CRC-32C integrity (header,
per-document and whole payload), written and validated in C++.  Loading
is a zero-copy `np.memmap` view of the host file; the operand build then
copies it to the card.

The library is built with g++ at first use into `build/native/` at the
repo root, and again only when the source is newer than it; nothing under
`native/` is ever written.  Without a toolchain every entry point raises
`NativeUnavailable`.  The file format is the JAX package's: arenas
written by either package read in the other.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parent.parent
SRC = _ROOT / "native" / "fhestore.cpp"
LIB_PATH = _ROOT / "build" / "native" / "libfhestore.so"
_HEADER_BYTES = 64
_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    """Compile SRC into LIB_PATH (through a temporary file, then a rename)."""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-Wall", "-std=c++17", "-fPIC", "-shared",
           "-o", str(tmp), str(SRC)]
    logger.info("building native store codec: %s", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, LIB_PATH)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SRC.stat().st_mtime:
            try:
                _build()
            except (OSError, subprocess.CalledProcessError) as e:
                raise NativeUnavailable(f"cannot build {LIB_PATH}: {e}") from e
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.fhe_crc32c.restype = ctypes.c_uint32
        lib.fhe_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
        lib.fhe_arena_write.restype = ctypes.c_int
        lib.fhe_arena_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_uint64, ctypes.c_uint64]
        lib.fhe_arena_validate.restype = ctypes.c_int64
        lib.fhe_arena_validate.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.fhe_arena_info.restype = ctypes.c_int64
        lib.fhe_arena_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
        _LIB = lib
        return lib


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


def crc32c(data: bytes, seed: int = 0) -> int:
    return int(_lib().fhe_crc32c(data, len(data), seed))


def arena_write(path: str | os.PathLike, docs: np.ndarray) -> None:
    """Write (count, *doc_shape) uint32 ciphertexts as one arena file.

    Atomic: writes to path.tmp then renames.
    """
    docs = np.ascontiguousarray(docs, dtype=np.uint32)
    count = docs.shape[0]
    wpd = int(np.prod(docs.shape[1:], dtype=np.int64))
    tmp = str(path) + ".tmp"
    rc = _lib().fhe_arena_write(tmp.encode(), docs.ctypes.data_as(ctypes.c_void_p), count, wpd)
    if rc != 0:
        raise OSError(-rc, f"arena write failed: {os.strerror(-rc)}")
    os.replace(tmp, path)


def arena_info(path: str | os.PathLike) -> Tuple[int, int]:
    """(count, words_per_doc), validating the header CRC."""
    wpd = ctypes.c_uint64()
    rc = _lib().fhe_arena_info(str(path).encode(), ctypes.byref(wpd))
    if rc < 0:
        raise OSError(-rc, f"bad arena: {os.strerror(-rc)}")
    return int(rc), int(wpd.value)


def arena_validate(path: str | os.PathLike) -> Tuple[int, Optional[int]]:
    """(valid_count, first_bad_index_or_None) via the C++ CRC sweep."""
    bad = ctypes.c_uint64()
    rc = _lib().fhe_arena_validate(str(path).encode(), ctypes.byref(bad))
    if rc < 0:
        raise OSError(-rc, f"bad arena: {os.strerror(-rc)}")
    first_bad = None if bad.value == (1 << 64) - 1 else int(bad.value)
    return int(rc), first_bad


def arena_mmap(path: str | os.PathLike, doc_shape: Tuple[int, ...]) -> np.ndarray:
    """Zero-copy read-only view (count, *doc_shape) of the payload."""
    count, wpd = arena_info(path)
    if wpd != int(np.prod(doc_shape, dtype=np.int64)):
        raise ValueError(f"doc shape {doc_shape} != {wpd} words in arena")
    return np.memmap(path, dtype=np.uint32, mode="r", offset=_HEADER_BYTES,
                     shape=(count,) + tuple(doc_shape))
