"""The modulus switch's pointwise arithmetic and the one-coefficient decrypt:
CUDA kernel wrappers and their plain versions.

* `lift`: the dropped limb's coefficients c (R, 1, N) mod p_d, d = l - 1,
  to the correction delta = t * centered([c * t^-1]_{p_d}) over the l - 1
  limbs left, (R, l - 1, N) (`arith.mod_switch` transforms it forward);
* `tail`: (c_i - delta_i) * p_d^-1 mod p_i over the limbs left, from the
  (R, l, N) ciphertext rows and the NTT-domain delta;
* `decrypt_coeff`: the phase c0 + c1*s (+ c2*s^2) of each row, times the
  INTT row of one output coefficient, summed over N mod each p_i, then the
  exact RNS decode (`cipher.rns_decode_centered`'s arithmetic), (...,) int32.

Replace no Pallas kernel: the JAX package's `ops/arith.py::mod_switch` and
`ops/cipher.py::decrypt_coeff` leave this arithmetic to XLA.  The kernels
(`csrc/modswitch.cu`, the decode in `csrc/rns_decode.cuh`) are bound by
bytes and, at a compare's sizes, by their launch; the source's note gives
the design.  Each wrapper launches its kernel for CUDA tensors and runs its
plain version (`*_ref`, the int64 torch ops of `modmath.py`) for CPU
tensors; both give the same integers.  The kernels read the context's and
the secret key's device tables through pointers: nothing is copied from
the host on a call.
"""

from __future__ import annotations

import torch

from .. import kernels
from .modmath import barrett_reduce, i64, mont_mul, sub_mod, u32


def _need(cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(msg)


def _common(what: str, ctx, named) -> None:
    """dtype, device and contiguity of every data operand."""
    for name, x in named:
        _need(x.dtype == torch.uint32, f"{what}: {name} must be uint32, got {x.dtype}", TypeError)
    devices = {x.device for _, x in named} | {ctx.p.device}
    _need(len(devices) == 1, f"{what}: operands and tables on several devices: "
          f"{sorted(map(str, devices))}")
    for name, x in named:
        _need(x.is_contiguous(), f"{what}: {name} must be contiguous")


def _check_level(ctx, l: int) -> None:
    _need(2 <= l <= ctx.n_limbs, f"mod_switch needs a level in 2..{ctx.n_limbs}, got {l}")


def _check_lift(ctx, c: torch.Tensor, l: int) -> int:
    """R of a valid (R, 1, N) operand; raises on what the kernel does not take."""
    _check_level(ctx, l)
    _need(c.dim() == 3 and c.shape[1] == 1 and c.shape[2] == ctx.n,
          f"modswitch lift: the dropped limb must be (R, 1, {ctx.n}), got {tuple(c.shape)}")
    _common("modswitch lift", ctx, (("dropped limb", c),))
    return c.shape[0]


def _check_tail(ctx, x: torch.Tensor, delta: torch.Tensor, l: int) -> int:
    _check_level(ctx, l)
    _need(x.dim() == 3 and tuple(x.shape[1:]) == (l, ctx.n),
          f"modswitch tail: rows must be (R, {l}, {ctx.n}), got {tuple(x.shape)}")
    _need(tuple(delta.shape) == (x.shape[0], l - 1, ctx.n),
          f"modswitch tail: delta must be {(x.shape[0], l - 1, ctx.n)}, got {tuple(delta.shape)}")
    _common("modswitch tail", ctx, (("rows", x), ("delta", delta)))
    return x.shape[0]


def _check_decrypt(ctx, sk, ct, w: torch.Tensor) -> tuple:
    """(B, k, l) of a valid ciphertext and weight row."""
    d, l = ct.data, ct.level
    _need(d.dim() >= 3 and d.shape[-3] in (2, 3),
          f"decrypt_coeff: data must be (..., k, l, N) with k = 2 or 3, got {tuple(d.shape)}")
    _need(ct.is_ntt, "decrypt_coeff needs an NTT-domain ciphertext")
    _need(1 <= l <= ctx.n_limbs and tuple(d.shape[-2:]) == (l, ctx.n),
          f"decrypt_coeff: data {tuple(d.shape)} at level {l} (N = {ctx.n})")
    _need(tuple(w.shape) == (l, ctx.n),
          f"decrypt_coeff: the weight row must be {(l, ctx.n)}, got {tuple(w.shape)}")
    _common("decrypt_coeff", ctx, (("data", d), ("weights", w), ("s", sk.s_ntt_mont),
                                   ("s^2", sk.s2_ntt_mont)))
    return d.numel() // (d.shape[-3] * l * ctx.n), d.shape[-3], l


# ---------------------------------------------------------------------------
# Plain versions (int64)
# ---------------------------------------------------------------------------


def lift_ref(ctx, c: torch.Tensor, l: int) -> torch.Tensor:
    """Plain version of `lift`: u = [c t^-1]_{p_d}, its centered lift into each
    limb p_i (u mod p_i, less p_d mod p_i when u > p_d / 2), times t."""
    _check_lift(ctx, c, l)
    lt = ctx.levels[l]
    u = mont_mul(c, lt.t_inv_mont_pd[0, 0], ctx.p[l - 1, 0], ctx.p_neg_inv[l - 1, 0])
    p, pinv = ctx.lp(l - 1), ctx.lpinv(l - 1)
    w = barrett_reduce(u, p, ctx.mu_p[: l - 1])
    w = u32(torch.where(i64(u) > i64(lt.pd_half[0, 0]), i64(sub_mod(w, lt.pd_mod_pi, p)), i64(w)))
    return mont_mul(w, ctx.t_mont_p[: l - 1], p, pinv)


def tail_ref(ctx, x: torch.Tensor, delta: torch.Tensor, l: int) -> torch.Tensor:
    """Plain version of `tail`: (x_i - delta_i) * p_d^-1 mod p_i, i < l - 1."""
    _check_tail(ctx, x, delta, l)
    p, pinv = ctx.lp(l - 1), ctx.lpinv(l - 1)
    return mont_mul(sub_mod(x[:, : l - 1, :], delta, p), ctx.levels[l].inv_pd_mont, p, pinv)


def tree_sum_mod(x: torch.Tensor, p) -> torch.Tensor:
    """Sum over the last axis mod p -> (..., 1) uint32."""
    return u32(torch.remainder(i64(x).sum(dim=-1, keepdim=True), i64(p)))


def decrypt_coeff_ref(ctx, sk, ct, w: torch.Tensor) -> torch.Tensor:
    """Plain version of `decrypt_coeff`: the phase, its product with the weight
    row, the limb sums and `cipher.rns_decode_centered`."""
    from .cipher import _phase, rns_decode_centered      # cipher imports this module
    _check_decrypt(ctx, sk, ct, w)
    l = ct.level
    p, pinv = ctx.lp(l), ctx.lpinv(l)
    terms = mont_mul(_phase(ctx, sk, ct), w, p, pinv)
    res = tree_sum_mod(terms, p)                    # (..., l, 1)
    return rns_decode_centered(ctx, res, l, ct.pt_corr)[..., 0]


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _on_card(what: str, *xs: torch.Tensor) -> None:
    _need(xs[0].device.type == "cuda", f"the {what} kernel needs CUDA tensors, got {xs[0].device}")
    _need(all(x.data_ptr() % 16 == 0 for x in xs), f"{what}: operands must start on 16 bytes")


def _launch_lift(ctx, c: torch.Tensor, l: int) -> torch.Tensor:
    rows = _check_lift(ctx, c, l)
    _on_card("modswitch lift", c)
    out = torch.empty((rows, l - 1, ctx.n), dtype=torch.uint32, device=c.device)
    if rows == 0:
        return out
    lt = ctx.levels[l]
    with kernels.launch_on(c.device) as stream:
        err = kernels.load().fhe_modswitch_lift(
            c.data_ptr(), out.data_ptr(), ctx.p.data_ptr(), ctx.p_neg_inv.data_ptr(),
            ctx.mu_p.data_ptr(), ctx.t_mont_p.data_ptr(), lt.pd_mod_pi.data_ptr(),
            lt.t_inv_mont_pd.data_ptr(), lt.pd_half.data_ptr(), rows, l, ctx.n, stream)
    kernels.check(err, "modswitch_lift")
    kernels.launches["modswitch_lift"] += 1
    return out


def _launch_tail(ctx, x: torch.Tensor, delta: torch.Tensor, l: int) -> torch.Tensor:
    rows = _check_tail(ctx, x, delta, l)
    _on_card("modswitch tail", x, delta)
    out = torch.empty((rows, l - 1, ctx.n), dtype=torch.uint32, device=x.device)
    if rows == 0:
        return out
    with kernels.launch_on(x.device) as stream:
        err = kernels.load().fhe_modswitch_tail(
            x.data_ptr(), delta.data_ptr(), out.data_ptr(), ctx.p.data_ptr(),
            ctx.p_neg_inv.data_ptr(), ctx.levels[l].inv_pd_mont.data_ptr(), rows, l, ctx.n,
            stream)
    kernels.check(err, "modswitch_tail")
    kernels.launches["modswitch_tail"] += 1
    return out


def _launch_decrypt(ctx, sk, ct, w: torch.Tensor) -> torch.Tensor:
    b, k, l = _check_decrypt(ctx, sk, ct, w)
    d = ct.data
    _on_card("decrypt_coeff", d, w, sk.s_ntt_mont, sk.s2_ntt_mont)
    out = torch.empty(tuple(d.shape[:-3]), dtype=torch.int32, device=d.device)
    if b == 0:
        return out
    lt = ctx.levels[l]
    with kernels.launch_on(d.device) as stream:
        err = kernels.load().fhe_decrypt_coeff(
            d.data_ptr(), sk.s_ntt_mont.data_ptr(), sk.s2_ntt_mont.data_ptr(), w.data_ptr(),
            ctx.p.data_ptr(), ctx.p_neg_inv.data_ptr(), lt.inv_qhat.data_ptr(),
            lt.inv_qhat_sh.data_ptr(), ctx.v_c.data_ptr(), lt.r_t_mont.data_ptr(),
            lt.q_mod_t_mont.data_ptr(), ctx.t_neg_inv.data_ptr(), ctx.mu_t.data_ptr(),
            out.data_ptr(), b, k, l, ctx.n, ctx.t, ct.pt_corr % ctx.t, stream)
    kernels.check(err, "decrypt_coeff")
    kernels.launches["decrypt_coeff"] += 1
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def lift(ctx, c: torch.Tensor, l: int) -> torch.Tensor:
    """(R, 1, N) coefficients of limb l - 1 (canonical mod p_{l-1}) -> the
    (R, l - 1, N) coefficients of delta over the limbs left, canonical.  On
    the card, c starts on 16 bytes."""
    if c.device.type == "cpu":
        return lift_ref(ctx, c, l)
    return _launch_lift(ctx, c, l)


def tail(ctx, x: torch.Tensor, delta: torch.Tensor, l: int) -> torch.Tensor:
    """(R, l, N) NTT-domain rows at level l and their (R, l - 1, N) NTT-domain
    delta -> the switched (R, l - 1, N) rows, canonical."""
    if x.device.type == "cpu":
        return tail_ref(ctx, x, delta, l)
    return _launch_tail(ctx, x, delta, l)


def decrypt_coeff(ctx, sk, ct, w: torch.Tensor) -> torch.Tensor:
    """Coefficient j of each of ct's rows -> (...,) int32, where w =
    `cipher.coeff_weights(ctx, j, ct.level)`.  ct.data (..., k, l, N), k = 2
    or 3, canonical residues; data, w and the secret's rows contiguous, on
    the context's device and, on the card, starting on 16 bytes.  The card
    takes N up to 32768 and l up to 32."""
    if ct.data.device.type == "cpu":
        return decrypt_coeff_ref(ctx, sk, ct, w)
    return _launch_decrypt(ctx, sk, ct, w)
