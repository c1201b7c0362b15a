"""Noise-budget accounting (exact, host-side diagnostic).

Budget = log2(q/2) - log2(max |c0 + c1*s|_centered): bits of headroom
before decryption fails.  The phase is computed on the ciphertext's device
(one inverse NTT), then reconstructed with exact Python big-int CRT over a
coefficient subsample.  The counterparts of the JAX package's
`ops/noise.py`, with the same numbers.
"""

from __future__ import annotations

import numpy as np

from .cipher import Ciphertext, SecretKey, _phase
from .context import CryptoContext
from .ntt import ntt_inv


def _phase_coeffs(ctx: CryptoContext, sk: SecretKey, ct: Ciphertext):
    """(B, l, N) coefficient-domain phase residues on the host, and the CRT
    reconstruction constants (q, [q/p_j * ((q/p_j)^{-1} mod p_j)])."""
    x = ntt_inv(ctx.plan, _phase(ctx, sk, ct)).cpu().numpy()
    l = ct.level
    q = ctx.q_at(l)
    recon = [(q // p) * pow((q // p) % p, -1, p) % q for p in ctx.primes[:l]]
    return x.reshape(-1, l, ctx.n), q, recon


def _centered(x, e: int, i: int, q: int, recon) -> int:
    v = 0
    for j, c in enumerate(recon):
        v = (v + int(x[e, j, i]) * c) % q
    return v - q if v > q // 2 else v


def phase_centered(ctx: CryptoContext, sk: SecretKey, ct: Ciphertext,
                   max_coeffs: int = 256) -> np.ndarray:
    """Exact centered phase values (object array of Python ints).

    A batched ciphertext is inspected across every batch element (the
    coefficient subsample is divided among them).
    """
    x, q, recon = _phase_coeffs(ctx, sk, ct)
    b = x.shape[0]
    per = max(1, min(max_coeffs // b, ctx.n))
    idx = np.linspace(0, ctx.n - 1, per).astype(int)
    return np.asarray([_centered(x, e, i, q, recon) for e in range(b) for i in idx],
                      dtype=object)


def noise_budget_bits_batch(ctx: CryptoContext, sk: SecretKey, ct: Ciphertext,
                            coeffs_per_ct: int = 32) -> np.ndarray:
    """Per-element noise budgets of a batched ciphertext: (B,) int64."""
    x, q, recon = _phase_coeffs(ctx, sk, ct)
    b = x.shape[0]
    per = max(1, min(coeffs_per_ct, ctx.n))
    idx = np.linspace(0, ctx.n - 1, per).astype(int)
    q_half_bits = (q // 2).bit_length()
    out = np.empty(b, dtype=np.int64)
    for e in range(b):
        worst = max(abs(_centered(x, e, i, q, recon)) for i in idx)
        out[e] = q.bit_length() - 1 if worst == 0 else q_half_bits - worst.bit_length()
    return out


def noise_budget_bits(ctx: CryptoContext, sk: SecretKey, ct: Ciphertext,
                      max_coeffs: int = 256) -> int:
    """Bits of headroom: floor(log2(q/2 / max|phase|)).

    The centered phase saturates at q/2, so 0 is the floor and means the
    noise has wrapped.
    """
    worst = max((abs(int(v)) for v in phase_centered(ctx, sk, ct, max_coeffs)), default=0)
    q = ctx.q_at(ct.level)
    if worst == 0:
        return q.bit_length() - 1
    return (q // 2).bit_length() - worst.bit_length()
