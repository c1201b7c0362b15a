"""Plaintext products and modulus switching of NTT-domain ciphertexts.

`plain_to_eval` turns a clear polynomial into the NTT-domain Montgomery
operand that `mul_plain` multiplies pointwise into a ciphertext.

In `mod_switch` only the dropped limb leaves the NTT domain: its
coefficient form gives the rounding correction delta, which is
transformed forward over the remaining limbs, so a switch costs l
transforms per polynomial.
"""

from __future__ import annotations

import torch

from .cipher import Ciphertext, centered_residues
from .context import CryptoContext
from .modmath import barrett_reduce, i64, mont_mul, sub_mod, to_mont, u32
from .ntt import NttPlan, build_plan, ntt_fwd, ntt_inv


def plain_to_eval(ctx: CryptoContext, pt: torch.Tensor, l: int) -> torch.Tensor:
    """int32 poly (..., N), |pt| < t/2 -> NTT-domain Montgomery operand (..., l, N)."""
    res = centered_residues(ctx, pt, l)
    return to_mont(ntt_fwd(ctx.plan, res), ctx.lp(l), ctx.lpinv(l), ctx.lr2(l))


def mul_plain(ctx: CryptoContext, a: Ciphertext, pt_eval: torch.Tensor) -> Ciphertext:
    """ct * pt with pt already in eval (NTT + Montgomery) form."""
    l = a.level
    out = mont_mul(a.data, pt_eval[..., None, :, :], ctx.lp(l), ctx.lpinv(l))
    return Ciphertext(out, l, True, a.pt_corr)


def _single_prime_plan(ctx: CryptoContext, prime: int) -> NttPlan:
    """Cached one-limb NTT plan, for one limb's coefficient form."""
    return ctx.cached(("single_prime_plan", prime),
                      lambda: build_plan(ctx.n, (prime,), ctx.device))


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
    w = barrett_reduce(u, p, ctx.mu_p[: l - 1])                       # (B*k, l-1, N)
    w = u32(torch.where(i64(u) > i64(lt.pd_half[0, 0]),
                        i64(sub_mod(w, lt.pd_mod_pi, p)), i64(w)))
    delta = ntt_fwd(ctx.plan, mont_mul(w, ctx.t_mont_p[: l - 1], p, pinv))
    out = mont_mul(sub_mod(flat[:, : l - 1, :], delta, p), lt.inv_pd_mont, p, pinv)
    return Ciphertext(out.reshape(lead + (l - 1, ctx.n)), l - 1, True,
                      ct.pt_corr * ctx.primes[l - 1] % ctx.t)


def mod_switch_to(ctx: CryptoContext, ct: Ciphertext, level: int) -> Ciphertext:
    while ct.level > level:
        ct = mod_switch(ctx, ct)
    return ct
