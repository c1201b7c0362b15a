"""Balanced int8 digits for exact encrypted dot-product scoring.

A stored ciphertext's residues are centered to (-p/2, p/2] and split into
4 balanced base-256 digits in [-128, 127], so an int8 x int8 -> int32
product over the 2N ciphertext axis is exact (every digit-pair partial is
below 128*128*2N < 2^31).  The partials fold back mod p with the
Montgomery constants 2^{8s} of `_shift_consts`.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import CryptoContext
from .modmath import i64

N_DIGITS = 4


def center_residues(x: torch.Tensor, p) -> torch.Tensor:
    """uint32 residues in [0, p) -> centered int32 in (-p/2, p/2]."""
    x, p = i64(x), i64(p)
    return torch.where(x > (p >> 1), x - p, x).to(torch.int32)


def balanced_digits(x: torch.Tensor) -> torch.Tensor:
    """int32 (|x| < 2^30) -> (..., 4) int8 balanced base-256 digits.

    x == sum_i d_i * 256^i with d_i in [-128, 127].
    """
    digits = []
    c = x.to(torch.int32)
    for _ in range(N_DIGITS):
        d = ((c + 128) & 255) - 128
        digits.append(d.to(torch.int8))
        c = (c - d) >> 8
    return torch.stack(digits, dim=-1)


def _shift_consts(ctx: CryptoContext, l: int) -> np.ndarray:
    """Per-shift Montgomery constants 2^{8s} * 2^32 mod p, shape (7, l)."""
    return ctx.cached(("fastdot_shift", l), lambda: np.asarray(
        [[(1 << (8 * s)) * (1 << 32) % p for p in ctx.primes[:l]]
         for s in range(2 * N_DIGITS - 1)], dtype=np.uint32))
