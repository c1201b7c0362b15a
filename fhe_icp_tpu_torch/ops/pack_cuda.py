"""Fused packed scoring: CUDA kernel wrapper and its plain version.

Replaces the JAX package's Pallas kernel `ops/pack_pallas.py::_fold_kernel`
(called through `packed_score_residues`).  Per limb it computes the int8
product of the (G*4, 2N) doc digit planes with the (2N, 4S) query digit
columns, exact in int32, and folds the 16 digit-pair partials of every
(group, slot) into one residue mod p: a signed Barrett reduce, a
Montgomery multiply by mont(2^{8(i+j)}) and modular adds.  The kernel
(`csrc/pack_score.cu`) runs the product on the int8 tensor cores (`wgmma`
fed by TMA), folds in its epilogue and writes only the (L, G, S) uint32
residues.  Where the row tiles are too few to fill the card it splits K
(`k_splits`): the fold is linear mod p, so the slices' residues add up.

`packed_score_residues` launches the kernel for CUDA tensors and runs the
plain version `packed_score_residues_ref` (an integer matmul followed by
`pack.fold_separable`) for CPU tensors.  `int_mm` is the exact int8
product alone, for the paths that have no kernel of their own.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from .context import CryptoContext
from .fastdot import N_DIGITS, _shift_consts

# A block tile: 128 doc digit rows (32 whole groups) by all 4S columns,
# which the kernel pads to a wgmma width of at most 256; a wider 4S (S
# dividing 256) is cut into column tiles of 256.
BLOCK_ROWS = 128
MAX_COLS = 256
# The kernel steps through K (= 2N) 128 digits at a time; a K slice is a
# whole number of these steps.
K_TILE = 128
# Streaming multiprocessors of an H100 SXM; the kernel runs one block on each.
SMS = 132
# A block's fixed cost in K steps: its 4-stage ring fills before the first
# product and its epilogue follows the last.
BLOCK_OVERHEAD = 4


def col_tiles(cols: int) -> int:
    """Column tiles of the kernel for 4S = cols query digit columns."""
    return -(-cols // MAX_COLS)


@functools.lru_cache(maxsize=256)
def k_splits(l: int, g: int, k: int, cols: int) -> int:
    """Slices of K per tile for L limbs of G groups, 2N = k and 4S = cols.

    With one block per SM a launch takes about (waves of blocks) x (K
    steps per block + BLOCK_OVERHEAD):
    ceil(tiles * s / SMS) * (ceil(k_tiles / s) + BLOCK_OVERHEAD), where
    tiles counts row tiles of every limb and column tile.  The count s that
    minimises it wins, the smaller on a tie, so a store that fills the card
    alone (G = 2048 at L = 2: 128 tiles) is not split, and a small one
    (G = 391: 26 tiles) is split until one wave is nearly full.
    """
    tiles = l * -(-N_DIGITS * g // BLOCK_ROWS) * col_tiles(cols)
    k_tiles = k // K_TILE
    return min(range(1, k_tiles + 1),
               key=lambda s: (-(-tiles * s // SMS) * (-(-k_tiles // s) + BLOCK_OVERHEAD), s))


def k_slices(k: int, splits: int) -> list:
    """The [start, stop) digit ranges of K that the kernel's slices cover."""
    k_tiles = k // K_TILE
    return [(z * k_tiles // splits * K_TILE, (z + 1) * k_tiles // splits * K_TILE)
            for z in range(splits)]


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


def int_mm(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact (L, M, K) x (L, K, C) int8 product as int32, one product a limb.

    The int8 products the JAX package leaves to XLA outside any Pallas
    kernel: fastdot's scores, the pipeline's first stage, the four-step
    NTT's DFT products.  On the card each limb is one `torch._int_mm`
    (cuBLASLt's int8 GEMM), which takes M > 16 and K, C multiples of 8, so
    the operands are padded with zero rows and columns (they add nothing to
    any sum) and the result is cut back.  On the CPU `int_matmul_ref`.
    """
    if a.device.type == "cpu":
        return int_matmul_ref(a, v)
    if a.device.type != "cuda" or v.device != a.device:
        raise ValueError(f"int_mm needs CUDA operands on one card, got {a.device}, {v.device}")
    if a.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"int_mm takes int8 operands, got {a.dtype}, {v.dtype}")
    l, m, k = a.shape
    c = v.shape[2]
    if v.shape[:2] != (l, k):
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(v.shape)} do not chain")
    mp, kp, cp = (m if m > 16 else 24), -(-k // 8) * 8, -(-c // 8) * 8
    if (mp, kp) != (m, k):
        a = _padded(a, (l, mp, kp))
    if (kp, cp) != (k, c):
        v = _padded(v, (l, kp, cp))
    out = torch.stack([torch._int_mm(a[i].contiguous(), v[i].contiguous()) for i in range(l)])
    return out[:, :m, :c]


def _padded(x: torch.Tensor, shape) -> torch.Tensor:
    """x in the leading corner of a zero tensor of `shape`."""
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


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
    k, cols = a.shape[2], N_DIGITS * slots
    if (cols > MAX_COLS and (slots > MAX_COLS or MAX_COLS % slots)) or k == 0 or k % K_TILE:
        raise ValueError(f"kernel needs 4S <= {MAX_COLS} or S dividing {MAX_COLS}, and 2N a "
                         f"multiple of {K_TILE}; got S={slots}, 2N={k}")
    a, v = a.contiguous(), v.contiguous()
    if a.data_ptr() % 16:
        raise ValueError("doc digit planes must be 16-byte aligned")
    w = _weight_tile(ctx, l, slots)
    tab = _limb_tables(ctx, l)
    out = torch.empty((l, g, slots), dtype=torch.uint32, device=a.device)
    if g == 0:
        return out
    # Scratch: the query digits transposed (k innermost, as the tensor cores
    # take them), then, where a row tile is cut into several parts (K slices
    # times column tiles), the tile counters and the parts' residues.
    splits = k_splits(l, g, k, cols)
    parts = splits * col_tiles(cols)
    words = l * cols * k // 4
    if parts > 1:
        tiles = l * -(-N_DIGITS * g // BLOCK_ROWS)
        words += tiles * (1 + parts * (BLOCK_ROWS // N_DIGITS) * slots)
    work = torch.empty(words, dtype=torch.int32, device=a.device)
    lib = kernels.load()
    with kernels.launch_on(a.device) as stream:
        err = lib.fhe_pack_score(a.data_ptr(), v.data_ptr(), w.data_ptr(), tab.data_ptr(),
                                 out.data_ptr(), work.data_ptr(), l, g, k, slots, splits, stream)
    kernels.check(err, "pack_score")
    kernels.launches["pack_score"] += 1
    return out
