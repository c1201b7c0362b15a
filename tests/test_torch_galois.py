"""Port Galois automorphisms, rotation keys and slot packing bit-exact vs JAX.

The JAX package makes the keys (relinearization at level 3, rotation keys
with 16-bit digits) and the slot-packed ciphertexts at test-512-mult; they
reach the port through `interop` (`gal_<g>_<level>` arrays for Galois
keys).  `galois_keygen`'s core is fed JAX's samples (split per (g, level),
then per digit).  Rotations go by a direct key and by power-of-two hops.
Tolerance: none on uint32 data, exact on decoded slots.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import cipher as jc
from fhe_icp_tpu.ops import galois as jg
from fhe_icp_tpu.ops.context import CryptoContext as JaxContext
from fhe_icp_tpu.ops.modmath import mont_mul as jmont_mul
from fhe_icp_tpu.ops.params import get_params as jax_params
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import galois as tg
from fhe_icp_tpu_torch.ops.cipher import decrypt
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import get_params
from fhe_icp_tpu_torch.ops.runtime import FheRuntime

PRESET, L = "test-512-mult", 3


@functools.lru_cache(maxsize=None)
def _setup():
    jctx = JaxContext(jax_params(PRESET))
    tctx = CryptoContext(get_params(PRESET), device="cpu")
    jg._t_plan(jctx)            # built outside any trace, so the JAX cache holds no tracer
    jks = jax.jit(lambda k: jc.keygen(jctx, k, rlk_levels=[L]))(jax.random.PRNGKey(0))
    jgk = _jax_rotation_keys(jctx, jks.sk, jax.random.PRNGKey(1))
    arrays = {"s": jks.sk.s, "s_ntt_mont": jks.sk.s_ntt_mont, "s2_ntt_mont": jks.sk.s2_ntt_mont,
              "pk_b": jks.pk.b_ntt, "pk_a": jks.pk.a_ntt, f"rlk_{L}": jks.rlk.keys[L]}
    tks = interop.keys_from_arrays(tctx, {k: np.asarray(v) for k, v in arrays.items()})
    tgk = interop.galois_keys_from_arrays(
        interop.galois_keys_to_arrays(_port_keys(jgk)), device="cpu")
    return jctx, tctx, jks, jgk, tks, tgk


def _jax_rotation_keys(jctx, sk, key):
    """jg.rotation_keygen(jctx, sk, key) at level L, key by key: the same
    split sequence, one compiled hybrid key for all elements."""
    fine = jax.jit(lambda k, s, t: jc.hybrid_keyswitch_key(jctx, k, s, t, L, 16))
    keys = {}
    for g in [jg.rot_element(jctx, 1 << i) for i in range(8)] + [jg.flip_element(jctx)]:
        key, k_g = jax.random.split(key)
        s_tau = jmont_mul(jg.apply_auto_ntt(jctx, sk.s_ntt_mont[:L], g), jnp.uint32(1),
                          jctx.lp(L), jctx.lpinv(L))
        keys[(g, L)] = fine(k_g, sk, s_tau)
    return jg.GaloisKeys(keys)


def _port_keys(jgk):
    return tg.GaloisKeys({k: torch.from_numpy(np.array(v)) for k, v in jgk.keys.items()})


@functools.lru_cache(maxsize=None)
def _slot_cts(seed, bound=1000, prefix=None):
    """JAX encryptions of two (2, N/2) slot vectors (zero past `prefix` in row 0)."""
    jctx, _, jks, _, _, _ = _setup()
    rng = np.random.default_rng(seed)
    vals = rng.integers(-bound, bound + 1, size=(2, 2, jctx.n // 2)).astype(np.int32)
    if prefix is not None:
        keep = np.zeros_like(vals)
        keep[:, 0, :prefix] = vals[:, 0, :prefix]
        vals = keep
    enc = jax.jit(lambda sk, k, v: jc.encrypt_sym(jctx, sk, k, jg.encode_slots(jctx, v)).data)
    data = np.asarray(enc(jks.sk, jax.random.PRNGKey(seed), jnp.asarray(vals)))
    return vals, data


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _jct(data):
    return jc.Ciphertext(jnp.asarray(data), L, True)


def _tct(data):
    return interop.ciphertext_from_array(np.asarray(data), L, device="cpu")


def _decrypt(tctx, tks, ct):
    return decrypt(tctx, tks.sk, ct)


def _center_t(x, t):
    r = np.mod(x, t)
    return np.where(r > t // 2, r - t, r)


def test_slot_structure_matches_jax():
    jctx, tctx, _, _, _, _ = _setup()
    for g in (5, 25, 1023, 2 * jctx.n - 1, jg.rot_element(jctx, 7)):
        _eq(tg.auto_perm(tctx, g), jg.auto_perm(jctx, g))
    _eq(tg._slot_order(tctx), jg._slot_order(jctx))
    assert tg.rotation_elements(tctx) == [jg.rot_element(jctx, 1 << i) for i in range(8)] + [
        jg.flip_element(jctx)]
    with pytest.raises(ValueError):
        tg.auto_perm(tctx, 4)


@pytest.mark.parametrize("g", [5, 1023])
def test_apply_auto_ntt_matches_jax(g):
    jctx, tctx, _, _, _, _ = _setup()
    rng = np.random.default_rng(g)
    x = rng.integers(0, 2 ** 31, size=(2, L, jctx.n)).astype(np.uint32)
    _eq(tg.apply_auto_ntt(tctx, torch.from_numpy(x), g), jg.apply_auto_ntt(jctx, jnp.asarray(x), g))


@pytest.mark.parametrize("digit_bits", [0, 16])
def test_galois_keygen_core_matches_jax(digit_bits):
    """JAX galois_keygen: split(key) per (g, level), then split(key, 3) per digit."""
    jctx, tctx, jks, _, tks, _ = _setup()
    gs, levels = ([5], [3, 2]) if digit_bits == 0 else ([5, 2 * jctx.n - 1], [3])
    key = jax.random.PRNGKey(7 + digit_bits)
    want = jax.jit(lambda sk, k: jg.galois_keygen(jctx, sk, k, gs, levels, digit_bits))(
        jks.sk, key)
    d_per = 1 if digit_bits == 0 else 2
    samples = {}
    for g in gs:
        for lv in levels:
            key, k_g = jax.random.split(key)
            a, e = [], []
            for _ in range(lv * d_per):
                k_g, ka, ke = jax.random.split(k_g, 3)
                a.append(np.asarray(jc.sample_uniform_primes(ka, (), jctx.hybrid(lv).plan.primes,
                                                             jctx.n)))
                e.append(np.asarray(jc.sample_cbd(jctx, ke, ())))
            samples[(g, lv)] = (torch.from_numpy(np.stack(a)), torch.from_numpy(np.stack(e)))
    got = tg.galois_keygen_with(tctx, tks.sk, samples, digit_bits)
    assert sorted(got.keys) == sorted(want.keys)
    for k in want.keys:
        _eq(got.keys[k], want.keys[k])


def test_galois_keys_interop_roundtrip():
    _, _, _, jgk, _, tgk = _setup()
    assert sorted(tgk.keys) == sorted(jgk.keys)
    for k, v in jgk.keys.items():
        _eq(tgk.keys[k], v)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("which", ["rotate by 1", "flip"])
def test_apply_galois_matches_jax(which, batched):
    jctx, tctx, _, jgk, _, tgk = _setup()
    vals, data = _slot_cts(3)
    data = data if batched else data[0]
    g = jg.rot_element(jctx, 1) if which == "rotate by 1" else jg.flip_element(jctx)
    want = jax.jit(lambda gk, d: jg.apply_galois(jctx, gk, _jct(d), g).data)(jgk, data)
    got = tg.apply_galois(tctx, tgk, _tct(data), g)
    assert got.data.shape == data.shape
    _eq(got.data, want)


@pytest.mark.parametrize("k", [3, 6, 4])
def test_rotate_slots_hops_match_jax(k):
    """3 and 6: power-of-two hops (popcount keyswitches); 4: one direct key."""
    jctx, tctx, jks, jgk, tks, tgk = _setup()
    vals, data = _slot_cts(4)
    want = jax.jit(lambda gk, d: jg.rotate_slots(jctx, gk, _jct(d), k).data)(jgk, data)
    got = tg.rotate_slots(tctx, tgk, _tct(data), k)
    _eq(got.data, want)
    _eq(tg.decode_slots(tctx, _decrypt(tctx, tks, got)), np.roll(vals, -k, axis=-1))


def test_rotate_slots_direct_key_matches_jax():
    """A key set holding only 5^3: rotate_slots takes the direct key."""
    jctx, tctx, jks, _, tks, _ = _setup()
    g = jg.rot_element(jctx, 3)
    jgk = jax.jit(lambda sk, k: jg.galois_keygen(jctx, sk, k, [g], [L]))(
        jks.sk, jax.random.PRNGKey(9))
    vals, data = _slot_cts(5)
    want = jax.jit(lambda gk, d: jg.rotate_slots(jctx, gk, _jct(d), 3).data)(jgk, data)
    got = tg.rotate_slots(tctx, _port_keys(jgk), _tct(data), 3)
    _eq(got.data, want)
    _eq(tg.decode_slots(tctx, _decrypt(tctx, tks, got)), np.roll(vals, -3, axis=-1))
    ct = _tct(data)
    assert tg.rotate_slots(tctx, _port_keys(jgk), ct, jctx.n // 2) is ct


def test_encode_decode_slots_match_jax():
    jctx, tctx, _, _, _, _ = _setup()
    rng = np.random.default_rng(6)
    vals = rng.integers(-(jctx.t // 2) + 1, jctx.t // 2, size=(3, 2, jctx.n // 2)).astype(np.int32)
    m = tg.encode_slots(tctx, torch.from_numpy(vals))
    _eq(m, jax.jit(lambda v: jg.encode_slots(jctx, v))(jnp.asarray(vals)))
    _eq(tg.decode_slots(tctx, m), vals)
    poly = rng.integers(-(jctx.t // 2), jctx.t // 2, size=(2, jctx.n)).astype(np.int32)
    _eq(tg.decode_slots(tctx, torch.from_numpy(poly)),
        jax.jit(lambda p: jg.decode_slots(jctx, p))(jnp.asarray(poly)))


@pytest.mark.parametrize("d", [None, 32])
def test_dot_ct_ct_slots_matches_jax(d):
    jctx, tctx, jks, jgk, tks, tgk = _setup()
    vals, data = _slot_cts(10 + (d or 0), bound=30, prefix=d)
    want = jax.jit(lambda rk, gk, a, b: jg.dot_ct_ct_slots(jctx, rk, gk, _jct(a), _jct(b),
                                                           d=d).data)(
        jks.rlk.keys, jgk, data[0], data[1])
    got = tg.dot_ct_ct_slots(tctx, tks.rlk, tgk, _tct(data[0]), _tct(data[1]), d=d)
    _eq(got.data, want)
    dot = _center_t(int(np.sum(vals[0].astype(np.int64) * vals[1])), jctx.t)
    slots = tg.decode_slots(tctx, _decrypt(tctx, tks, got)).numpy()
    if d is None:
        assert (slots == dot).all()
    else:
        assert slots[0, 0] == dot


def test_runtime_slots_end_to_end():
    """FheRuntime(device="cpu"): slot encryption, rotations (keys for a
    switched level made on first use) and the prefix dot, exact."""
    rt = FheRuntime(PRESET, rlk_levels=[L], device="cpu")
    rt.generate_keys(seed=12)
    rng = np.random.default_rng(13)
    vals = rng.integers(-30, 31, size=(2, 2, rt.ctx.n // 2)).astype(np.int32)
    vals[:, 0, 32:] = 0
    vals[:, 1] = 0
    ca, cb = rt.encrypt_slots(vals[0], seed=1), rt.encrypt_slots(vals[1], seed=2)
    _eq(rt.decrypt_slots(ca), vals[0])
    _eq(rt.decrypt_slots(rt.rotate_slots(ca, 5)), np.roll(vals[0], -5, axis=-1))
    out = rt.dot_ct_ct_slots(ca, cb, d=32)
    assert int(rt.decrypt_slots(out)[0, 0]) == int(np.sum(vals[0].astype(np.int64) * vals[1]))
    low = rt.mod_switch(ca)
    _eq(rt.decrypt_slots(rt.rotate_slots(low, 2)), np.roll(vals[0], -2, axis=-1))
    assert any(lv == 2 for (_, lv) in rt.rotation_keys().keys)
