"""Homomorphic operations: add/sub/neg, ct*pt, ct*ct, keyswitching, modswitch.

Every operation is pointwise in the NTT domain except the keyswitch digit
extraction and modulus switching, which go through coefficients; all
broadcast over leading batch dimensions.  The counterparts of the JAX
package's `ops/arith.py`, with the same integers.

Keyswitching is hybrid (GHS): the digits of the switched polynomial
multiply a key over the extended chain Q_l * P, and the sum is divided by
the special prime P with the rounding of modulus switching.  One mechanism
serves relinearization (`relinearize`), re-keying (`rekey`) and Galois
rotations (`galois.apply_galois`).  `hybrid_keyswitch_apply` has three
regimes that give identical integers: full-limb digits at a batch of
`_REUSE_MIN_BATCH` or more (per-digit plans that skip the limb whose
transform is the input), full-limb digits below it (one combined
transform over all digits), and 16-bit sub-digits.

In `_div_special` and `mod_switch` only the dropped limb leaves the NTT
domain: its coefficient form gives the rounding correction, which is
transformed forward over the remaining limbs.
"""

from __future__ import annotations

import torch

from .cipher import Ciphertext, centered_residues
from .context import CryptoContext, HybridTables
from .modmath import (add_mod, barrett_reduce, i64, mont_mul, neg_mod, sub_mod, to_mont,
                      u32)
from .ntt import NttPlan, build_plan, ntt_fwd, ntt_inv


def _check(a: Ciphertext, b: Ciphertext) -> None:
    if a.level != b.level or not (a.is_ntt and b.is_ntt) or a.pt_corr != b.pt_corr:
        raise ValueError("operands need one level, the NTT domain and one pt_corr "
                         f"(levels {a.level}/{b.level}, pt_corr {a.pt_corr}/{b.pt_corr})")


def add(ctx: CryptoContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check(a, b)
    return Ciphertext(add_mod(a.data, b.data, ctx.lp(a.level)), a.level, True, a.pt_corr)


def sub(ctx: CryptoContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check(a, b)
    return Ciphertext(sub_mod(a.data, b.data, ctx.lp(a.level)), a.level, True, a.pt_corr)


def neg(ctx: CryptoContext, a: Ciphertext) -> Ciphertext:
    return Ciphertext(neg_mod(a.data, ctx.lp(a.level)), a.level, True, a.pt_corr)


# ---------------------------------------------------------------------------
# Plaintext operands
# ---------------------------------------------------------------------------


def plain_to_eval(ctx: CryptoContext, pt: torch.Tensor, l: int) -> torch.Tensor:
    """int32 poly (..., N), |pt| < t/2 -> NTT-domain Montgomery operand (..., l, N)."""
    res = centered_residues(ctx, pt, l)
    return to_mont(ntt_fwd(ctx.plan, res), ctx.lp(l), ctx.lpinv(l), ctx.lr2(l))


def mul_plain(ctx: CryptoContext, a: Ciphertext, pt_eval: torch.Tensor) -> Ciphertext:
    """ct * pt with pt already in eval (NTT + Montgomery) form."""
    l = a.level
    out = mont_mul(a.data, pt_eval[..., None, :, :], ctx.lp(l), ctx.lpinv(l))
    return Ciphertext(out, l, True, a.pt_corr)


def add_plain(ctx: CryptoContext, a: Ciphertext, pt: torch.Tensor) -> Ciphertext:
    """ct + pt for an int32 plaintext poly (added to c0 only)."""
    if a.pt_corr != 1:
        raise ValueError("add_plain on a scaled ciphertext (pt_corr != 1) would misalign")
    l = a.level
    pt_ntt = ntt_fwd(ctx.plan, centered_residues(ctx, pt, l))
    c0 = add_mod(a.data[..., 0, :, :], pt_ntt, ctx.lp(l))
    return Ciphertext(torch.cat([c0[..., None, :, :], a.data[..., 1:, :, :]], dim=-3), l, True)


# ---------------------------------------------------------------------------
# Ciphertext multiplication + keyswitching
# ---------------------------------------------------------------------------


def mul_ct(ctx: CryptoContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Tensor product: (a0,a1)*(b0,b1) -> degree-2 ciphertext (3 polys)."""
    _check(a, b)
    if a.k != 2 or b.k != 2:
        raise ValueError(f"mul_ct needs degree-1 ciphertexts, got k={a.k}, {b.k}")
    l = a.level
    p, pinv = ctx.lp(l), ctx.lpinv(l)
    bm = to_mont(b.data, p, pinv, ctx.lr2(l))
    a0, a1 = a.data[..., 0, :, :], a.data[..., 1, :, :]
    b0, b1 = bm[..., 0, :, :], bm[..., 1, :, :]
    c0 = mont_mul(a0, b0, p, pinv)
    c1 = add_mod(mont_mul(a0, b1, p, pinv), mont_mul(a1, b0, p, pinv), p)
    c2 = mont_mul(a1, b1, p, pinv)
    return Ciphertext(torch.stack([c0, c1, c2], dim=-3), l, True,
                      a.pt_corr * b.pt_corr % ctx.t)


def _flatten_batch(x: torch.Tensor):
    """(..., l, N) -> ((B, l, N), lead): every keyswitch entry point folds its
    leading batch dimensions into one, as the JAX package does (there for
    the TPU's rank-3 fusions; here it fixes the batch that picks a regime)."""
    lead = tuple(x.shape[:-2])
    if len(lead) <= 1:
        return x, None
    return x.reshape((-1,) + tuple(x.shape[-2:])), lead


# At and above this many switched polynomials per call the keyswitch takes
# the variants with the fewest limb transforms; below it, the ones with the
# fewest separate NTT calls.  The JAX package's threshold, set on a TPU;
# both sides give the same integers.
_REUSE_MIN_BATCH = 32


def _digit_plan(ctx: CryptoContext, l: int, j: int) -> NttPlan:
    """NTT plan over the extended chain minus limb j (cached per (l, j)):
    the primes that full-limb digit j needs forward transforms at, in chain
    order, special prime last."""
    def build():
        ext = ctx.hybrid(l).plan.primes
        return build_plan(ctx.n, tuple(p for i, p in enumerate(ext) if i != j), ctx.device)
    return ctx.cached(("hybrid_digit_plan", l, j), build)


def _single_prime_plan(ctx: CryptoContext, prime: int) -> NttPlan:
    """Cached one-limb NTT plan, for one limb's coefficient form."""
    return ctx.cached(("single_prime_plan", prime),
                      lambda: build_plan(ctx.n, (prime,), ctx.device))


def gadget_keyswitch_apply(ctx: CryptoContext, ksk: torch.Tensor, c_ntt: torch.Tensor, l: int):
    """Accumulate sum_j digit_j(c) * ksk[j] -> (d0, d1) NTT-domain polys.

    c_ntt: (..., l, N) NTT-domain poly whose key component is switched;
    ksk: (l, 2, l, N) Montgomery key (`cipher.gadget_keyswitch_key`).  The
    CRT-idempotent digits are the coefficient-domain limbs of c, each
    reduced into every limb and transformed forward again.
    """
    c_ntt, lead = _flatten_batch(c_ntt)
    p, pinv = ctx.lp(l), ctx.lpinv(l)
    c_coeff = ntt_inv(ctx.plan, c_ntt)
    acc0 = acc1 = None
    for j in range(l):
        d_ntt = ntt_fwd(ctx.plan, barrett_reduce(c_coeff[..., j:j + 1, :], p, ctx.mu_p[:l]))
        t0 = mont_mul(d_ntt, ksk[j, 0], p, pinv)
        t1 = mont_mul(d_ntt, ksk[j, 1], p, pinv)
        acc0 = t0 if acc0 is None else add_mod(acc0, t0, p)
        acc1 = t1 if acc1 is None else add_mod(acc1, t1, p)
    if lead is not None:
        acc0 = acc0.reshape(lead + tuple(acc0.shape[-2:]))
        acc1 = acc1.reshape(lead + tuple(acc1.shape[-2:]))
    return acc0, acc1


def _lift_centered(u: torch.Tensor, p, mu, half, mod_pi) -> torch.Tensor:
    """[u]_q centered (q = the dropped prime, half = q // 2), reduced into each
    limb p_i: (u mod p_i) - (q mod p_i if u > q/2).  (..., 1, N) -> (..., l, N)."""
    w = barrett_reduce(u, p, mu)
    return u32(torch.where(i64(u) > i64(half), i64(sub_mod(w, mod_pi, p)), i64(w)))


def _div_special(ctx: CryptoContext, ht: HybridTables, x_ntt: torch.Tensor, l: int):
    """Exact divide-by-P: NTT-domain polys over Q_l*P -> over Q_l.

    Subtract delta with delta = x (mod P), delta = 0 (mod t), delta
    centered-small, then multiply by P^{-1}.  Below `_REUSE_MIN_BATCH`
    rows: one combined inverse and one forward transform.  At or above:
    only the special limb leaves the NTT domain, its correction goes
    forward over the l limbs, and x*P^{-1} - w*(t*P^{-1}) stays pointwise
    (1 + l limb transforms a polynomial instead of (l+1) + l).
    """
    x_ntt, lead = _flatten_batch(x_ntt)                   # (B', l+1, N)
    sp, sp_pinv = ht.p[l, 0], ht.pinv[l, 0]
    p, pinv = ctx.lp(l), ctx.lpinv(l)
    if x_ntt.shape[0] < _REUSE_MIN_BATCH:
        x = ntt_inv(ht.plan, x_ntt)
        u = mont_mul(x[..., l:, :], ht.t_inv_mont_sp[0, 0], sp, sp_pinv)
        w = _lift_centered(u, p, ctx.mu_p[:l], ht.sp_half[0, 0], ht.sp_mod_pi)
        delta = mont_mul(w, ctx.t_mont_p[:l], p, pinv)
        out = ntt_fwd(ctx.plan, mont_mul(sub_mod(x[..., :l, :], delta, p), ht.inv_sp_mont,
                                         p, pinv))
    else:
        sp_plan = _single_prime_plan(ctx, ctx.params.special_prime)
        x_sp = ntt_inv(sp_plan, x_ntt[..., l:, :])         # (B', 1, N) coeff
        u = mont_mul(x_sp, ht.t_inv_mont_sp[0, 0], sp, sp_pinv)
        w_ntt = ntt_fwd(ctx.plan, _lift_centered(u, p, ctx.mu_p[:l], ht.sp_half[0, 0],
                                                 ht.sp_mod_pi))
        out = sub_mod(mont_mul(x_ntt[..., :l, :], ht.inv_sp_mont, p, pinv),
                      mont_mul(w_ntt, ht.t_inv_sp_mont, p, pinv), p)
    return out if lead is None else out.reshape(lead + tuple(out.shape[-2:]))


def hybrid_keyswitch_apply(ctx: CryptoContext, ksk: torch.Tensor, c_ntt: torch.Tensor, l: int):
    """Hybrid (GHS) keyswitch: digits over Q_l*P, then divide by P.

    ksk: (n_dig, 2, l+1, N) Montgomery hybrid key
    (`cipher.hybrid_keyswitch_key`); c_ntt: (..., l, N) NTT-domain poly
    whose key component is switched.  n_dig = l (full-limb CRT digits) or
    2l (16-bit sub-digits).  Returns (d0, d1) NTT-domain polys over Q_l,
    shaped like c_ntt.
    """
    squeeze = c_ntt.dim() == 2                            # single (l, N) poly
    if squeeze:
        c_ntt = c_ntt[None]
    c_ntt, lead = _flatten_batch(c_ntt)                   # (B, l, N)
    ht = ctx.hybrid(l)
    pe, pinve = ht.p, ht.pinv
    n_dig, n = ksk.shape[0], ctx.n
    d_per = n_dig // l
    c_coeff = ntt_inv(ctx.plan, c_ntt)                    # (B, l, N)
    if d_per == 1 and c_ntt.shape[0] >= _REUSE_MIN_BATCH:
        # Digit j is limb j of c, so its transform at extended limb j is the
        # input slice itself: only the other l extended limbs are transformed.
        pe64, mu64 = i64(pe), i64(ht.mu)
        d_list = []
        for j in range(l):
            others = [i for i in range(l + 1) if i != j]
            d_res = barrett_reduce(c_coeff[:, j:j + 1, :], pe64[others], mu64[others])
            d_o = ntt_fwd(_digit_plan(ctx, l, j), d_res)  # (B, l, N)
            d_list.append(torch.cat([d_o[:, :j], c_ntt[:, j:j + 1], d_o[:, j:]], dim=-2))
        d_ntt = torch.stack(d_list, dim=1)                # (B, l, l+1, N)
    elif d_per == 1:
        # Small batches: one combined transform over every digit.
        d_res = barrett_reduce(c_coeff.reshape(-1, 1, n), pe, ht.mu)   # (B*l, l+1, N)
        d_ntt = ntt_fwd(ht.plan, d_res).reshape(-1, n_dig, l + 1, n)
    else:
        if d_per != 2:
            raise ValueError(f"only 16-bit sub-digits are supported ({n_dig} digits, l={l})")
        c64 = i64(c_coeff)
        d = u32(torch.stack([c64 & 0xFFFF, c64 >> 16], dim=-2)).reshape(-1, 1, n)
        # Digits < 2^16 < every prime: the residues are the values themselves.
        d_ntt = ntt_fwd(ht.plan, d.expand(-1, l + 1, n)).reshape(-1, n_dig, l + 1, n)
    acc0 = acc1 = None
    for j in range(n_dig):
        t0 = mont_mul(d_ntt[:, j], ksk[j, 0], pe, pinve)
        t1 = mont_mul(d_ntt[:, j], ksk[j, 1], pe, pinve)
        acc0 = t0 if acc0 is None else add_mod(acc0, t0, pe)
        acc1 = t1 if acc1 is None else add_mod(acc1, t1, pe)
    out = _div_special(ctx, ht, torch.stack([acc0, acc1], dim=-3), l)
    d0, d1 = out[..., 0, :, :], out[..., 1, :, :]
    if squeeze:
        d0, d1 = d0[0], d1[0]
    elif lead is not None:
        d0 = d0.reshape(lead + tuple(d0.shape[-2:]))
        d1 = d1.reshape(lead + tuple(d1.shape[-2:]))
    return d0, d1


def keyswitch_apply(ctx: CryptoContext, ksk: torch.Tensor, c_ntt: torch.Tensor, l: int):
    """Dispatch on the key's shape: hybrid (n, 2, l+1, N) or gadget (l, 2, l, N)."""
    if ksk.shape[-2] == l + 1:
        return hybrid_keyswitch_apply(ctx, ksk, c_ntt, l)
    return gadget_keyswitch_apply(ctx, ksk, c_ntt, l)


def relinearize(ctx: CryptoContext, rlk_keys, ct: Ciphertext) -> Ciphertext:
    """Degree 2 -> degree 1: keyswitch c2 from s^2 to s with rlk_keys[level]."""
    if ct.k != 3 or not ct.is_ntt:
        raise ValueError(f"relinearize needs a degree-2 NTT-domain ciphertext (k={ct.k})")
    l = ct.level
    p = ctx.lp(l)
    lead = tuple(ct.data.shape[:-3])
    data = ct.data.reshape((-1,) + tuple(ct.data.shape[-3:]))    # (B, 3, l, N)
    d0, d1 = keyswitch_apply(ctx, rlk_keys[l], data[:, 2], l)
    out = torch.stack([add_mod(data[:, 0], d0, p), add_mod(data[:, 1], d1, p)], dim=-3)
    return Ciphertext(out.reshape(lead + (2, l, ctx.n)), l, True, ct.pt_corr)


def rekey(ctx: CryptoContext, ksk: torch.Tensor, ct: Ciphertext) -> Ciphertext:
    """Switch ct from the old secret to the new one without decrypting.

    ksk = cipher.rekey_keygen(...)[ct.level].  Decomposing c1 against the
    key gives (d0, d1) with d0 + d1*new_s = c1*old_s + t*e_ks, so (c0 + d0,
    d1) decrypts to the same message under new_s.
    """
    if ct.k != 2 or not ct.is_ntt:
        raise ValueError(f"rekey needs a degree-1 NTT-domain ciphertext (k={ct.k})")
    l = ct.level
    lead = tuple(ct.data.shape[:-3])
    data = ct.data.reshape((-1,) + tuple(ct.data.shape[-3:]))    # (B, 2, l, N)
    d0, d1 = keyswitch_apply(ctx, ksk, data[:, 1], l)
    out = torch.stack([add_mod(data[:, 0], d0, ctx.lp(l)), d1], dim=-3)
    return Ciphertext(out.reshape(lead + (2, l, ctx.n)), l, True, ct.pt_corr)


# ---------------------------------------------------------------------------
# Modulus switching (noise management / ciphertext compression)
# ---------------------------------------------------------------------------


def mod_switch(ctx: CryptoContext, ct: Ciphertext) -> Ciphertext:
    """Drop the last active limb: ct mod q -> ct mod q/p_d.

    c' = (c - delta) / p_d with delta = c (mod p_d), delta = 0 (mod t),
    delta centered-small.  Noise shrinks by ~p_d; the message picks up a
    factor [p_d^{-1}]_t, recorded in `pt_corr` for the decoder.
    """
    l = ct.level
    if l < 2 or ct.k != 2 or not ct.is_ntt:
        raise ValueError("mod_switch needs a degree-1 NTT-domain ciphertext "
                         f"above level 1 (level={l}, k={ct.k}, is_ntt={ct.is_ntt})")
    # The rounding term delta/p_d has coefficients up to ~t*N/2 (ternary
    # secret): the remaining modulus must dominate it.
    if ctx.q_at(l - 1) < 4 * ctx.t * ctx.n:
        raise ValueError(
            f"mod_switch to level {l - 1} leaves insufficient noise headroom "
            f"(q'={ctx.q_at(l - 1).bit_length()} bits vs t={ctx.t.bit_length()} "
            f"bits, N={ctx.n})")
    lt = ctx.levels[l]
    lead = ct.data.shape[:-2]                            # (..., k)
    flat = ct.data.reshape((-1,) + tuple(ct.data.shape[-2:]))   # (B*k, l, N)
    pd_plan = _single_prime_plan(ctx, ctx.primes[l - 1])
    c_last = ntt_inv(pd_plan, flat[:, l - 1:, :])        # (B*k, 1, N) coeff
    u = mont_mul(c_last, lt.t_inv_mont_pd[0, 0], ctx.p[l - 1, 0],
                 ctx.p_neg_inv[l - 1, 0])                # [c*t^{-1}]_{p_d}
    p, pinv = ctx.lp(l - 1), ctx.lpinv(l - 1)
    w = _lift_centered(u, p, ctx.mu_p[: l - 1], lt.pd_half[0, 0], lt.pd_mod_pi)
    delta = ntt_fwd(ctx.plan, mont_mul(w, ctx.t_mont_p[: l - 1], p, pinv))
    out = mont_mul(sub_mod(flat[:, : l - 1, :], delta, p), lt.inv_pd_mont, p, pinv)
    return Ciphertext(out.reshape(lead + (l - 1, ctx.n)), l - 1, True,
                      ct.pt_corr * ctx.primes[l - 1] % ctx.t)


def mod_switch_to(ctx: CryptoContext, ct: Ciphertext, level: int) -> Ciphertext:
    while ct.level > level:
        ct = mod_switch(ctx, ct)
    return ct
