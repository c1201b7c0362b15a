"""Modular arithmetic on torch tensors: the plain versions of the kernels.

Residues are `torch.uint32` at every interface, as in the JAX package.
PyTorch has few uint32 operators (`+`, `>>` and `<` are missing on the
CPU), so every function here computes in int64 and casts the canonical
result back to uint32.  Each JAX modmath function returns the canonical
residue in [0, p), so a direct `torch.remainder` in int64 gives the same
integers as the JAX package's 16-bit `umulhi` emulation; the device-side
library `csrc/modmath.cuh` uses the 32-bit `__umulhi` route instead.

Bounds that keep every int64 product exact: p < 2^31 and any uint32
operand a < 2^32 give a*w < 2^63 for w < p.  Functions that take two data
operands reduce both below p first.

`p`, `p_neg_inv`, ... may be Python ints or tensors that broadcast
against the data (the context keeps them as (L, 1) uint32 columns).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_R = 1 << 32


def i64(x):
    """int64 view of a uint32/int tensor; Python ints pass through."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return int(x)


def u32(x: torch.Tensor) -> torch.Tensor:
    """Cast int64 values in [0, 2^32) back to uint32."""
    return x.to(torch.uint32)


def _r_inv(p, p_neg_inv):
    """R^{-1} mod p from Montgomery's -p^{-1} mod R: p*p' + 1 = R*R^{-1}."""
    return (i64(p) * i64(p_neg_inv) + 1) >> 32


def umulhi32(a, b):
    """High 32 bits of the 64-bit product of two uint32 values (int64 out).

    Split b in 16-bit halves so that no int64 product overflows.
    """
    a, b = i64(a), i64(b)
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def umul32_wide(a, b):
    """(hi, lo) words of the full 64-bit product, as int64 tensors."""
    a64, b64 = i64(a), i64(b)
    lo = (a64 * (b64 & 0xFFFF) + (((a64 * (b64 >> 16)) & 0xFFFF) << 16)) & _M32
    return umulhi32(a, b), lo


def add64(acc_hi, acc_lo, hi, lo):
    """(acc_hi:acc_lo) += (hi:lo) on 32-bit word pairs, mod 2^64 (int64)."""
    s = i64(acc_lo) + i64(lo)
    return (i64(acc_hi) + i64(hi) + (s >> 32)) & _M32, s & _M32


def _rem(x, p):
    """Python-style (non-negative for p > 0) remainder of int64 values."""
    if isinstance(x, torch.Tensor) or isinstance(p, torch.Tensor):
        return torch.remainder(torch.as_tensor(x), p)
    return x % p


def add_mod(a, b, p):
    """(a + b) mod p for a, b in [0, p)."""
    return u32(torch.remainder(i64(a) + i64(b), i64(p)))


def sub_mod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    return u32(torch.remainder(i64(a) - i64(b), i64(p)))


def neg_mod(a, p):
    """(-a) mod p for a in [0, p)."""
    return u32(torch.remainder(-i64(a), i64(p)))


def mont_mul(a, b, p, p_neg_inv):
    """Montgomery product a*b*R^{-1} mod p (R = 2^32), canonical."""
    p64 = i64(p)
    ab = _rem(_rem(i64(a), p64) * _rem(i64(b), p64), p64)
    return u32(_rem(ab * _r_inv(p, p_neg_inv), p64))


def shoup_mul(a, w, w_sh, p):
    """a*w mod p for a constant w < p and any uint32 a (w_sh unused here)."""
    del w_sh
    return u32(torch.remainder(i64(a) * i64(w), i64(p)))


def barrett_reduce(x, p, mu):
    """x mod p for any uint32 x (mu unused here)."""
    del mu
    return u32(torch.remainder(i64(x), i64(p)))


def to_mont(a, p, p_neg_inv, r2_mod_p):
    """a*R mod p (normal -> Montgomery domain)."""
    return mont_mul(a, r2_mod_p, p, p_neg_inv)


def from_mont(a, p, p_neg_inv):
    """a*R^{-1} mod p (Montgomery -> normal domain)."""
    return mont_mul(a, 1, p, p_neg_inv)


def mul_mod(a, b, p, p_neg_inv, r2_mod_p):
    """Generic a*b mod p for two data arrays."""
    return mont_mul(a, to_mont(b, p, p_neg_inv, r2_mod_p), p, p_neg_inv)
