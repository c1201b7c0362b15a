"""BGV keys, encryption, decryption (RNS, NTT-domain ciphertexts).

Scheme: BGV with the plaintext in the least-significant position,
    c0 + c1*s  =  m + t*e   (mod q).
Ciphertexts are stored in the NTT domain (bit-reversed order), so add and
products are pointwise; decryption goes back to coefficients.

Randomness comes from an explicit `torch.Generator`.  Keygen and
encryption are split into sampling and a deterministic core
(`keygen_with`, `encrypt_sym_with`) so that tests can feed the core the
JAX package's samples and compare bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import primes as pr
from .context import CryptoContext
from .modmath import (add_mod, barrett_reduce, i64, mont_mul, shoup_mul, sub_mod,
                      to_mont, u32)
from .ntt import ntt_fwd, ntt_inv


@dataclass(frozen=True)
class Ciphertext:
    """data: (..., k, L, N) uint32 — k polys (2, or 3 before relin), L limbs.

    `level` = number of active RNS limbs; `is_ntt` = evaluation domain.
    `pt_corr` is the cumulative message factor (mod t) that modulus
    switching introduced; decryption multiplies by it.  1 when fresh.
    """

    data: torch.Tensor
    level: int
    is_ntt: bool = True
    pt_corr: int = 1

    @property
    def k(self) -> int:
        return self.data.shape[-3]

    @property
    def batch_shape(self):
        return self.data.shape[:-3]


@dataclass(frozen=True)
class SecretKey:
    s: torch.Tensor             # (N,) int32 ternary coefficients
    s_ntt_mont: torch.Tensor    # (L, N) uint32, NTT domain, Montgomery form
    s2_ntt_mont: torch.Tensor   # (L, N) uint32, s^2, NTT domain, Montgomery form


@dataclass(frozen=True)
class PublicKey:
    b_ntt: torch.Tensor         # (L, N) uint32, NTT domain (normal form)
    a_ntt: torch.Tensor         # (L, N)


@dataclass(frozen=True)
class KeySet:
    sk: SecretKey
    pk: PublicKey
    # Relinearization keys {level: (n_digits, 2, level+1, N)} in the JAX
    # key layout.  Carried through interop; no function of this package
    # uses them yet.
    rlk: Dict[int, torch.Tensor] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def centered_residues(ctx: CryptoContext, v: torch.Tensor, l: int) -> torch.Tensor:
    """Signed poly (..., N), |v| < p_min, to residues (..., l, N) uint32."""
    return u32(torch.remainder(i64(v)[..., None, :], i64(ctx.lp(l))))


def sample_uniform(ctx: CryptoContext, gen: torch.Generator, shape, l: int):
    """Uniform residues in [0, p_j) per limb: a uniform ring element by CRT."""
    limbs = [torch.randint(0, p, tuple(shape) + (ctx.n,), generator=gen,
                           device=ctx.device, dtype=torch.int64)
             for p in ctx.primes[:l]]
    return u32(torch.stack(limbs, dim=-2))


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int64 values below 2^32 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def sample_cbd(ctx: CryptoContext, gen: torch.Generator, shape) -> torch.Tensor:
    """Centered binomial error, variance k/2 (sigma ~ 3.16 for k=20). int32."""
    k = ctx.params.cbd_k
    bits = torch.randint(0, 1 << k, tuple(shape) + (2, ctx.n), generator=gen,
                         device=ctx.device, dtype=torch.int64)
    pc = _popcount(bits)
    return (pc[..., 0, :] - pc[..., 1, :]).to(torch.int32)


def sample_ternary(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(-1, 2, tuple(shape), generator=gen, device=device,
                         dtype=torch.int32)


# ---------------------------------------------------------------------------
# Key generation
# ---------------------------------------------------------------------------


def _payload_residues(ctx, e, m_res, l: int):
    """Residues of t*e + m given error e (int32) and message residues m_res."""
    te = mont_mul(centered_residues(ctx, e, l), ctx.t_mont_p[:l], ctx.lp(l),
                  ctx.lpinv(l))
    return add_mod(te, m_res, ctx.lp(l)) if m_res is not None else te


def keygen_with(ctx: CryptoContext, s: torch.Tensor, a_ntt: torch.Tensor,
                e: torch.Tensor) -> KeySet:
    """Keys from given samples: ternary s (N,), uniform a_ntt (L, N), CBD e (N,)."""
    l = ctx.n_limbs
    p, pinv = ctx.lp(l), ctx.lpinv(l)
    s = s.to(torch.int32)
    s_ntt = ntt_fwd(ctx.plan, centered_residues(ctx, s, l))
    s_ntt_mont = to_mont(s_ntt, p, pinv, ctx.lr2(l))
    # mont_mul of two Montgomery-form operands stays in Montgomery form.
    s2_ntt_mont = mont_mul(s_ntt_mont, s_ntt_mont, p, pinv)
    sk = SecretKey(s=s, s_ntt_mont=s_ntt_mont, s2_ntt_mont=s2_ntt_mont)
    # Public key: b = -(a*s) + t*e.
    te_ntt = ntt_fwd(ctx.plan, _payload_residues(ctx, e, None, l))
    as_ntt = mont_mul(a_ntt, s_ntt_mont, p, pinv)
    return KeySet(sk=sk, pk=PublicKey(b_ntt=sub_mod(te_ntt, as_ntt, p), a_ntt=a_ntt))


def keygen(ctx: CryptoContext, gen: torch.Generator,
           rlk_levels: Sequence[int] = ()) -> KeySet:
    """Secret and public keys from `gen` (drawn in the order s, a, e).

    Relinearization keys need the hybrid keyswitch tables, which this
    package does not have yet: any `rlk_levels` raises.
    """
    if list(rlk_levels):
        raise NotImplementedError(
            "relinearization keys are not ported yet; pass rlk_levels=[]")
    s = sample_ternary(gen, (ctx.n,), ctx.device)
    a = sample_uniform(ctx, gen, (), ctx.n_limbs)
    e = sample_cbd(ctx, gen, ())
    return keygen_with(ctx, s, a, e)


# ---------------------------------------------------------------------------
# Encryption / decryption
# ---------------------------------------------------------------------------


def encrypt_sym_with(ctx: CryptoContext, sk: SecretKey, a_ntt: torch.Tensor,
                     e: torch.Tensor, m: torch.Tensor) -> Ciphertext:
    """Symmetric encryption of m (..., N), |m| < t/2, with given a and e."""
    l = ctx.n_limbs
    p = ctx.lp(l)
    pay_ntt = ntt_fwd(ctx.plan, _payload_residues(ctx, e, centered_residues(ctx, m, l), l))
    c0 = sub_mod(pay_ntt, mont_mul(a_ntt, sk.s_ntt_mont, p, ctx.lpinv(l)), p)
    return Ciphertext(torch.stack([c0, a_ntt], dim=-3), level=l, is_ntt=True)


def encrypt_sym(ctx: CryptoContext, sk: SecretKey, gen: torch.Generator,
                m: torch.Tensor) -> Ciphertext:
    """Symmetric encryption with (a, e) drawn from `gen` (in that order)."""
    shape = m.shape[:-1]
    a = sample_uniform(ctx, gen, shape, ctx.n_limbs)
    e = sample_cbd(ctx, gen, shape)
    return encrypt_sym_with(ctx, sk, a, e, m)


def _phase(ctx: CryptoContext, sk: SecretKey, ct: Ciphertext) -> torch.Tensor:
    """c0 + c1*s (+ c2*s^2), NTT domain, at ct.level."""
    l = ct.level
    p, pinv = ctx.lp(l), ctx.lpinv(l)
    d = ct.data
    x = add_mod(d[..., 0, :, :], mont_mul(d[..., 1, :, :], sk.s_ntt_mont[:l], p, pinv), p)
    if ct.k == 3:
        x = add_mod(x, mont_mul(d[..., 2, :, :], sk.s2_ntt_mont[:l], p, pinv), p)
    return x


def rns_decode_centered(ctx: CryptoContext, x: torch.Tensor, l: int,
                        pt_corr: int = 1) -> torch.Tensor:
    """Exact [x]_q mod t (centered) from residues x: (..., l, N) -> int32.

    v_hat follows the JAX package's Q56 arithmetic exactly: only the high
    word of sum_j y_j*floor(2^56/p_j) enters the rounding,
    v_hat = ((sum >> 32) + 2^23) >> 24.  The sum stays below 2^61 in int64.
    """
    lt = ctx.levels[l]
    p = ctx.lp(l)
    y = i64(shoup_mul(x, lt.inv_qhat, lt.inv_qhat_sh, p))     # (..., l, N)
    acc = (y * i64(ctx.v_c[:l])).sum(dim=-2)
    v_hat = ((acc >> 32) + (1 << 23)) >> 24

    t = ctx.t
    terms = i64(mont_mul(barrett_reduce(y, t, ctx.mu_t[0, 0]), lt.r_t_mont, t,
                         ctx.t_neg_inv[0, 0]))
    m = torch.remainder(terms.sum(dim=-2), t)
    vq = i64(mont_mul(v_hat, lt.q_mod_t_mont[0, 0], t, ctx.t_neg_inv[0, 0]))
    m = torch.remainder(m - vq, t)
    if pt_corr % t != 1:
        m = torch.remainder(m * (pt_corr % t), t)
    return torch.where(m > t // 2, m - t, m).to(torch.int32)


def decrypt(ctx: CryptoContext, sk: SecretKey, ct: Ciphertext) -> torch.Tensor:
    """Decrypt to the centered int32 message poly (..., N)."""
    x = ntt_inv(ctx.plan, _phase(ctx, sk, ct))
    return rns_decode_centered(ctx, x, ct.level, ct.pt_corr)


# ---------------------------------------------------------------------------
# Single-coefficient decryption
# ---------------------------------------------------------------------------


def bitrev(n: int) -> np.ndarray:
    """The bit-reversal permutation of 0..N-1 (int64)."""
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        out |= ((idx >> b) & 1) << (log_n - 1 - b)
    return out


def coeff_weights(ctx: CryptoContext, j: int, l: int) -> torch.Tensor:
    """(l, N) Montgomery row of the INTT matrix for output coefficient j.

    NTT-domain slot m holds frequency bitrev(m), so
        out[j] = psi^{-j} N^{-1} sum_m X[m] w^{-j*bitrev(m)}  (mod p).
    """
    def build():
        n = ctx.n
        brv = bitrev(n)
        rows = []
        for p in ctx.primes[:l]:
            psi = pr.root_of_unity(p, 2 * n)
            w_inv = pow(psi * psi % p, p - 2, p)
            lead = pow(psi, -(j % (2 * n)), p) * pow(n, p - 2, p) % p
            tbl = _pow_table(w_inv, n, p)
            row = tbl[(j * brv) % n] * lead % p * ((1 << 32) % p) % p
            rows.append(row.astype(np.uint32))
        return ctx.tensor(np.stack(rows))
    return ctx.cached(("coeff_w", j, l), build)


def _pow_table(w: int, n: int, p: int) -> np.ndarray:
    """w^k mod p for k in [0, n), uint64 (exact: every product < 2^62)."""
    tbl = np.empty(n, dtype=np.uint64)
    acc = 1
    for k in range(n):
        tbl[k] = acc
        acc = acc * w % p
    return tbl


def tree_sum_mod(x: torch.Tensor, p) -> torch.Tensor:
    """Sum over the last axis mod p -> (..., 1) uint32."""
    return u32(torch.remainder(i64(x).sum(dim=-1, keepdim=True), i64(p)))


def decrypt_coeff(ctx: CryptoContext, sk: SecretKey, ct: Ciphertext,
                  j: int) -> torch.Tensor:
    """Decrypt only coefficient j -> (...,) int32, skipping the full INTT."""
    l = ct.level
    p, pinv = ctx.lp(l), ctx.lpinv(l)
    terms = mont_mul(_phase(ctx, sk, ct), coeff_weights(ctx, j, l), p, pinv)
    res = tree_sum_mod(terms, p)                    # (..., l, 1)
    return rns_decode_centered(ctx, res, l, ct.pt_corr)[..., 0]
