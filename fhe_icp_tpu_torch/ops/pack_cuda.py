"""Fused packed scoring: CUDA kernel wrapper and its plain version.

Replaces the JAX package's Pallas kernel `ops/pack_pallas.py::_fold_kernel`
(called through `packed_score_residues`).  Per limb it computes the int8
product of the (G*4, 2N) doc digit planes with the (2N, 4S) query digit
columns, exact in int32, and folds the 16 digit-pair partials of every
(group, slot) into one residue mod p: a signed Barrett reduce, a
Montgomery multiply by mont(2^{8(i+j)}) and modular adds.  The kernel
(`csrc/pack_score.cu`) keeps the partials in registers and writes only
the (L, G, S) uint32 residues.

`packed_score_residues` launches the kernel for CUDA tensors and runs the
plain version `packed_score_residues_ref` (an integer matmul followed by
`pack.fold_separable`) for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .context import CryptoContext
from .fastdot import N_DIGITS, _shift_consts

# Threads per block; a block owns 256 / S groups and all S slots.
THREADS = 256
# The kernel steps through the contraction axis 64 digits at a time.
K_STEP = 64


def _limb_tables(ctx: CryptoContext, l: int) -> torch.Tensor:
    """(l, 8) uint32 per-limb scalars [p, -p^-1 mod 2^32, floor(2^32/p), 0...]."""
    def build():
        tab = np.zeros((l, 8), dtype=np.uint32)
        for i, p in enumerate(ctx.primes[:l]):
            tab[i, 0] = p
            tab[i, 1] = (-pow(p, -1, 1 << 32)) % (1 << 32)
            tab[i, 2] = (1 << 32) // p
        return ctx.tensor(tab)
    return ctx.cached(("pack_score_tab", l), build)


def _weight_tile(ctx: CryptoContext, l: int, slots: int) -> torch.Tensor:
    """(l, 4, 4S) uint32 Montgomery weights W[li, i, j*S + s] = mont(2^{8(i+j)})."""
    def build():
        consts = _shift_consts(ctx, l)                    # (7, l)
        w = np.zeros((l, N_DIGITS, N_DIGITS * slots), dtype=np.uint32)
        for li in range(l):
            for i in range(N_DIGITS):
                for j in range(N_DIGITS):
                    w[li, i, j * slots:(j + 1) * slots] = consts[i + j, li]
        return ctx.tensor(w)
    return ctx.cached(("pack_score_w", l, slots), build)


def _check(a: torch.Tensor, v: torch.Tensor, l: int, slots: int) -> int:
    if a.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"digit planes must be int8, got {a.dtype}, {v.dtype}")
    la, rows, k = a.shape
    if la != l or v.shape != (l, k, N_DIGITS * slots) or rows % N_DIGITS:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(v.shape)} do not "
                         f"match L={l}, S={slots}")
    if a.device != v.device:
        raise ValueError(f"operands on {a.device} and {v.device}")
    return rows // N_DIGITS


def int_matmul_ref(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact (L, R, K) x (L, K, C) int8 batched product as int32.

    On the CPU in int32.  On a GPU in float64, exact while every partial
    and every partial sum stays below 2^53 (the digits bound them by
    128*128*K, under 2^31 for K <= 2^17); cuBLAS has no int32 product.
    """
    if a.device.type == "cpu":
        return torch.bmm(a.to(torch.int32), v.to(torch.int32))
    return torch.bmm(a.to(torch.float64), v.to(torch.float64)).to(torch.int32)


def packed_score_residues_ref(ctx: CryptoContext, a: torch.Tensor, v: torch.Tensor,
                              l: int, slots: int) -> torch.Tensor:
    """Plain version: integer matmul, then the separable digit fold."""
    from .pack import fold_separable      # pack imports this module
    _check(a, v, l, slots)
    return fold_separable(ctx, int_matmul_ref(a, v), l, slots)


def packed_score_residues(ctx: CryptoContext, a: torch.Tensor, v: torch.Tensor,
                          l: int, slots: int) -> torch.Tensor:
    """(L, G*4, 2N) int8 x (L, 2N, 4S) int8 -> (L, G, S) uint32 residues."""
    if a.device.type == "cpu":
        return packed_score_residues_ref(ctx, a, v, l, slots)
    g = _check(a, v, l, slots)
    if a.device.type != "cuda":
        raise ValueError(f"the scoring kernel needs CUDA tensors, got {a.device}")
    k = a.shape[2]
    if THREADS % slots or k % K_STEP:
        raise ValueError(f"kernel needs S dividing {THREADS} and 2N a multiple "
                         f"of {K_STEP}; got S={slots}, 2N={k}")
    a = a.contiguous()
    if a.data_ptr() % 16:
        raise ValueError("doc digit planes must be 16-byte aligned")
    vt = v.transpose(1, 2).contiguous()               # (L, 4S, 2N): k innermost
    w = _weight_tile(ctx, l, slots)
    tab = _limb_tables(ctx, l)
    out = torch.empty((l, g, slots), dtype=torch.uint32, device=a.device)
    if g == 0:
        return out
    lib = kernels.load()
    err = lib.fhe_pack_score(a.data_ptr(), vt.data_ptr(), w.data_ptr(),
                             tab.data_ptr(), out.data_ptr(), l, g, k, slots,
                             kernels.stream_ptr(a.device))
    kernels.check(err, "pack_score")
    kernels.launches["pack_score"] += 1
    return out
