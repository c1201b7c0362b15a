"""Galois automorphisms, rotation keys, and CRT slot (SIMD) packing.

The ring automorphism tau_g: X -> X^g (g odd mod 2N) maps a BGV ciphertext
(c0, c1) to an encryption of tau(m) under tau(s); a hybrid keyswitch with
a Galois key (tau_g(s) -> s) brings it back to s.  In the NTT-domain layout
the automorphism is a slot permutation: slot m holds the evaluation at
psi^{e(m)}, e(m) = 2*bitrev(m) + 1, and tau_g moves the evaluation at
exponent g*e to exponent e, one gather.

Every preset's t is 1 mod 2N, so Z_t[X]/(X^N+1) splits into N linear
factors: `encode_slots`/`decode_slots` pack N values of Z_t into one
plaintext (a transform over the one-prime plan of t), ct*ct multiplies
slotwise, and `rotate_slots` rotates the two rows of N/2 slots (the orbits
of g = 5 and g = -5).  `dot_ct_ct_slots` is the fully encrypted inner
product as slotwise multiply + rotate-and-sum.

The counterparts of the JAX package's `ops/galois.py`, with the same
integers.  Gathers run on int32 views or int64 values with int64 indices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import arith
from .cipher import (Ciphertext, SecretKey, bitrev, hybrid_keyswitch_key_with,
                     hybrid_keyswitch_samples)
from .context import CryptoContext
from .modmath import add_mod, from_mont, i64, u32
from .ntt import NttPlan, build_plan, ntt_fwd, ntt_inv

# ---------------------------------------------------------------------------
# Slot structure (host-side, cached on the context)
# ---------------------------------------------------------------------------


def _exponents(ctx: CryptoContext) -> np.ndarray:
    """e(m) = 2*bitrev(m) + 1: the psi-exponent evaluated in NTT slot m."""
    return ctx.cached("galois_exponents", lambda: 2 * bitrev(ctx.n) + 1)


def _slot_of_exponent(ctx: CryptoContext) -> Dict[int, int]:
    return ctx.cached("galois_slot_of_exp",
                      lambda: {int(e): m for m, e in enumerate(_exponents(ctx))})


def auto_perm(ctx: CryptoContext, g: int) -> np.ndarray:
    """(N,) gather indices: NTT-domain tau_g is out[m] = in[perm[m]]."""
    g = g % (2 * ctx.n)
    if g % 2 != 1:
        raise ValueError(f"Galois element must be odd mod 2N, got {g}")

    def build():
        slot_of = _slot_of_exponent(ctx)
        return np.asarray([slot_of[int(g * e % (2 * ctx.n))] for e in _exponents(ctx)],
                          dtype=np.int32)
    return ctx.cached(("galois_perm", g), build)


def _index(ctx: CryptoContext, key, build) -> torch.Tensor:
    """A cached int64 index tensor on the context's device."""
    return ctx.cached(key, lambda: ctx.tensor(np.asarray(build(), dtype=np.int64)))


def rotation_group_gen(ctx: CryptoContext) -> int:
    """Generator of the rotation subgroup: 5 (order N/2 mod 2N)."""
    return 5


def rot_element(ctx: CryptoContext, k: int) -> int:
    """Galois element for a rotation by k slots within each row."""
    return pow(rotation_group_gen(ctx), k % (ctx.n // 2), 2 * ctx.n)


def flip_element(ctx: CryptoContext) -> int:
    """Galois element exchanging the two slot rows (g = -1 mod 2N)."""
    return 2 * ctx.n - 1


# ---------------------------------------------------------------------------
# Automorphism application + Galois keys
# ---------------------------------------------------------------------------


def apply_auto_ntt(ctx: CryptoContext, x: torch.Tensor, g: int) -> torch.Tensor:
    """tau_g of NTT-domain uint32 polys x: (..., L, N), a slot gather."""
    g = g % (2 * ctx.n)
    perm = _index(ctx, ("galois_perm_index", g), lambda: auto_perm(ctx, g))
    return x.view(torch.int32).index_select(-1, perm).view(torch.uint32)


@dataclass
class GaloisKeys:
    """Keyswitch keys tau_g(s) -> s, per (g, level)."""

    keys: Dict[Tuple[int, int], torch.Tensor]


def galois_target(ctx: CryptoContext, sk: SecretKey, g: int, lv: int) -> torch.Tensor:
    """tau_g(s) over the first lv limbs, NTT domain, normal form."""
    s_tau = apply_auto_ntt(ctx, sk.s_ntt_mont[:lv], g)
    return from_mont(s_tau, ctx.lp(lv), ctx.lpinv(lv))


def galois_keygen_with(ctx: CryptoContext, sk: SecretKey, samples: Dict[Tuple[int, int], tuple],
                       digit_bits: int = 16) -> GaloisKeys:
    """Galois keys from samples {(g, lv): (a, e)} (`cipher.hybrid_keyswitch_key_with`)."""
    out = {}
    for (g, lv), (a, e) in samples.items():
        g = g % (2 * ctx.n)
        out[(g, lv)] = hybrid_keyswitch_key_with(ctx, sk, galois_target(ctx, sk, g, lv), lv,
                                                 a, e, digit_bits=digit_bits)
    return GaloisKeys(out)


def galois_keygen(ctx: CryptoContext, sk: SecretKey, gen: torch.Generator, gs,
                  levels=None, digit_bits: int = 16) -> GaloisKeys:
    """Galois keys for the elements `gs` at the given levels (default: the top).

    digit_bits=16 (default) gives fine hybrid digits: a rotation adds ~2^-15
    error units instead of ~1, which keeps a rotate-and-sum chain
    decryptable at the 2-limb presets; 0 gives the coarse keys.
    """
    levels = list(levels) if levels is not None else [ctx.n_limbs]
    samples = {(g % (2 * ctx.n), lv): hybrid_keyswitch_samples(ctx, gen, lv, digit_bits)
               for g in gs for lv in levels}
    return galois_keygen_with(ctx, sk, samples, digit_bits)


def rotation_elements(ctx: CryptoContext) -> list:
    """All power-of-two rotations and the row flip: log2(N/2) + 1 elements."""
    gs = [rot_element(ctx, 1 << i) for i in range((ctx.n // 2).bit_length() - 1)]
    return gs + [flip_element(ctx)]


def rotation_keygen(ctx: CryptoContext, sk: SecretKey, gen: torch.Generator,
                    levels=None, digit_bits: int = 16) -> GaloisKeys:
    """Keys for every power-of-two rotation and the row flip."""
    return galois_keygen(ctx, sk, gen, rotation_elements(ctx), levels, digit_bits)


def apply_galois(ctx: CryptoContext, gkeys: GaloisKeys, ct: Ciphertext, g: int) -> Ciphertext:
    """tau_g(ct): permute slots, then keyswitch tau_g(s) -> s."""
    if ct.k != 2 or not ct.is_ntt:
        raise ValueError(f"apply_galois needs a degree-1 NTT-domain ciphertext (k={ct.k})")
    g = g % (2 * ctx.n)
    l = ct.level
    c0 = apply_auto_ntt(ctx, ct.data[..., 0, :, :], g)
    c1 = apply_auto_ntt(ctx, ct.data[..., 1, :, :], g)
    d0, d1 = arith.keyswitch_apply(ctx, gkeys.keys[(g, l)], c1, l)
    return Ciphertext(torch.stack([add_mod(c0, d0, ctx.lp(l)), d1], dim=-3), l, True,
                      ct.pt_corr)


def rotate_slots(ctx: CryptoContext, gkeys: GaloisKeys, ct: Ciphertext, k: int) -> Ciphertext:
    """Rotate both slot rows left by k (decode_slots[..., j] gets j+k).

    Uses the direct key for 5^k when present, otherwise the power-of-two
    hops of `rotation_keygen`'s key set (popcount(k) keyswitches).
    """
    k = k % (ctx.n // 2)
    if k == 0:
        return ct
    if (rot_element(ctx, k), ct.level) in gkeys.keys:
        return apply_galois(ctx, gkeys, ct, rot_element(ctx, k))
    bit = 1
    while k:
        if k & 1:
            ct = apply_galois(ctx, gkeys, ct, rot_element(ctx, bit))
        k >>= 1
        bit <<= 1
    return ct


def flip_rows(ctx: CryptoContext, gkeys: GaloisKeys, ct: Ciphertext) -> Ciphertext:
    """Exchange the two slot rows."""
    return apply_galois(ctx, gkeys, ct, flip_element(ctx))


# ---------------------------------------------------------------------------
# CRT slot packing over Z_t (t = 1 mod 2N: the ring splits completely)
# ---------------------------------------------------------------------------


def _t_plan(ctx: CryptoContext) -> NttPlan:
    """The one-prime NTT plan over the plaintext modulus t."""
    return ctx.cached("galois_t_plan", lambda: build_plan(ctx.n, (ctx.t,), ctx.device))


def _slot_order(ctx: CryptoContext) -> np.ndarray:
    """(2, N/2) NTT-slot indices: row r, column j holds the slot whose
    exponent is (-1)^r * 5^j mod 2N."""
    def build():
        two_n, half = 2 * ctx.n, ctx.n // 2
        slot_of = _slot_of_exponent(ctx)
        order = np.zeros((2, half), dtype=np.int32)
        e = 1
        for j in range(half):
            order[0, j] = slot_of[e]
            order[1, j] = slot_of[two_n - e]
            e = e * 5 % two_n
        return order
    return ctx.cached("galois_slot_order", build)


def _centered_t(ctx: CryptoContext, x: torch.Tensor) -> torch.Tensor:
    """Residues mod t (int64) -> centered int32 in (-t/2, t/2]."""
    return torch.where(x > ctx.t // 2, x - ctx.t, x).to(torch.int32)


def decode_slots(ctx: CryptoContext, m: torch.Tensor) -> torch.Tensor:
    """int32 message poly (..., N) -> (..., 2, N/2) int32 slot values (centered mod t)."""
    res = u32(torch.remainder(i64(m), ctx.t))[..., None, :]          # (..., 1, N)
    vals = i64(ntt_fwd(_t_plan(ctx), res)[..., 0, :])
    order = _index(ctx, "galois_slot_order_index", lambda: _slot_order(ctx).reshape(-1))
    vals = vals.index_select(-1, order)
    return _centered_t(ctx, vals.reshape(tuple(vals.shape[:-1]) + (2, ctx.n // 2)))


def encode_slots(ctx: CryptoContext, vals: torch.Tensor) -> torch.Tensor:
    """(..., 2, N/2) int32 slot values -> (..., N) int32 message poly."""
    flat = torch.remainder(i64(vals).reshape(tuple(vals.shape[:-2]) + (ctx.n,)), ctx.t)

    def inverse():
        order = _slot_order(ctx).reshape(-1)
        inv = np.empty_like(order)
        inv[order] = np.arange(ctx.n, dtype=np.int32)
        return inv
    res = u32(flat.index_select(-1, _index(ctx, "galois_slot_scatter_index", inverse)))
    m = ntt_inv(_t_plan(ctx), res[..., None, :])[..., 0, :]
    return _centered_t(ctx, i64(m))


# ---------------------------------------------------------------------------
# Rotation-based encrypted inner product (slotwise mul + rotate-and-sum)
# ---------------------------------------------------------------------------


def sum_all_slots(ctx: CryptoContext, gkeys: GaloisKeys, ct: Ciphertext) -> Ciphertext:
    """Every slot becomes the sum of all slots: log2(N/2) rotations + flip."""
    k = 1
    while k < ctx.n // 2:
        ct = arith.add(ctx, ct, rotate_slots(ctx, gkeys, ct, k))
        k <<= 1
    return arith.add(ctx, ct, flip_rows(ctx, gkeys, ct))


def sum_slots_prefix(ctx: CryptoContext, gkeys: GaloisKeys, ct: Ciphertext,
                     m: int) -> Ciphertext:
    """Slot j of each row becomes the sum of slots j..j+m-1 (cyclic in-row):
    log2(m) rotate-and-adds; slot 0 holds the sum of the first m slots."""
    if m & (m - 1) or not 1 <= m <= ctx.n // 2:
        raise ValueError(f"prefix length must be a power of two in 1..N/2, got {m}")
    k = 1
    while k < m:
        ct = arith.add(ctx, ct, rotate_slots(ctx, gkeys, ct, k))
        k <<= 1
    return ct


def dot_ct_ct_slots(ctx: CryptoContext, rlk_keys, gkeys: GaloisKeys, ct_a: Ciphertext,
                    ct_b: Ciphertext, d: Optional[int] = None) -> Ciphertext:
    """Fully encrypted inner product of two slot-packed ciphertexts.

    Slotwise multiply (tensor product + relinearization), then
    rotate-and-sum: with d=None the result (mod t) is in every slot; with a
    power-of-two d (operands in slots 0..d-1 of row 0) only log2(d) prefix
    rotations run and slot [0, 0] holds it.
    """
    prod = arith.relinearize(ctx, rlk_keys, arith.mul_ct(ctx, ct_a, ct_b))
    if d is None:
        return sum_all_slots(ctx, gkeys, prod)
    return sum_slots_prefix(ctx, gkeys, prod, d)
