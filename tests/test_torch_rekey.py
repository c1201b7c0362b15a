"""Port re-keying (old secret -> new secret) bit-exact against the JAX package.

`rekey_keygen`'s deterministic core is fed the JAX package's samples
(split per level, then per digit); `arith.rekey` applies JAX's keys to
JAX's ciphertexts, carried through `interop` (`ksk_<level>` arrays), in
both regimes of `_div_special`.  Re-keyed ciphertexts decrypt exactly
under the new key in both packages, not under the old one, and lose at
most 3 bits of noise budget.  test-512-mult, 3 limbs.  Tolerance: none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import arith as ja
from fhe_icp_tpu.ops import cipher as jc
from fhe_icp_tpu.ops.context import CryptoContext as JaxContext
from fhe_icp_tpu.ops.params import get_params as jax_params
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import arith as ta
from fhe_icp_tpu_torch.ops import cipher as tc
from fhe_icp_tpu_torch.ops import noise
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import get_params
from fhe_icp_tpu_torch.ops.runtime import FheRuntime

PRESET = "test-512-mult"


def _arrays(ks):
    return {"s": np.asarray(ks.sk.s), "s_ntt_mont": np.asarray(ks.sk.s_ntt_mont),
            "s2_ntt_mont": np.asarray(ks.sk.s2_ntt_mont),
            "pk_b": np.asarray(ks.pk.b_ntt), "pk_a": np.asarray(ks.pk.a_ntt)}


@functools.lru_cache(maxsize=None)
def _setup():
    jctx = JaxContext(jax_params(PRESET))
    tctx = CryptoContext(get_params(PRESET), device="cpu")
    gen = jax.jit(lambda k: jc.keygen(jctx, k, rlk_levels=[]))
    old, new = gen(jax.random.PRNGKey(0)), gen(jax.random.PRNGKey(1))
    ksks = jax.jit(lambda k, a, b: jc.rekey_keygen(jctx, k, a, b))(
        jax.random.PRNGKey(2), old.sk, new.sk)
    return (jctx, tctx, old, new, ksks, interop.keys_from_arrays(tctx, _arrays(old)),
            interop.keys_from_arrays(tctx, _arrays(new)))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_rekey_keygen_core_matches_jax():
    """Samples: split(key) per level, then split(key, 3) per 16-bit digit."""
    jctx, tctx, old, new, ksks, told, tnew = _setup()
    key, samples = jax.random.PRNGKey(2), {}
    for lv in (2, 3):
        key, k_lv = jax.random.split(key)
        primes = jctx.hybrid(lv).plan.primes
        a, e = [], []
        for _ in range(2 * lv):
            k_lv, ka, ke = jax.random.split(k_lv, 3)
            a.append(np.asarray(jc.sample_uniform_primes(ka, (), primes, jctx.n)))
            e.append(np.asarray(jc.sample_cbd(jctx, ke, ())))
        samples[lv] = (torch.from_numpy(np.stack(a)), torch.from_numpy(np.stack(e)))
    got = tc.rekey_keygen_with(tctx, told.sk, tnew.sk, samples)
    assert sorted(got) == sorted(ksks) == [2, 3]
    for lv in (2, 3):
        assert got[lv].shape == (2 * lv, 2, lv + 1, tctx.n)
        _eq(got[lv], ksks[lv])


def test_rekey_keys_interop_roundtrip():
    _, _, _, _, ksks, _, _ = _setup()
    arrays = {f"ksk_{lv}": np.asarray(v) for lv, v in ksks.items()}
    back = interop.rekey_keys_to_arrays(interop.rekey_keys_from_arrays(arrays, device="cpu"))
    assert sorted(back) == sorted(arrays)
    for name in arrays:
        _eq(back[name], arrays[name])


@pytest.mark.parametrize("batch", [2, ta._REUSE_MIN_BATCH // 2 + 4])
def test_rekey_matches_jax(batch):
    """2 ciphertexts (4 rows into _div_special: the small regime) and 20 (40
    rows: the regime that transforms only the special limb)."""
    jctx, tctx, old, new, ksks, told, tnew = _setup()
    rng = np.random.default_rng(batch)
    m = rng.integers(-(jctx.t // 2), jctx.t // 2, size=(batch, jctx.n)).astype(np.int32)
    jct = jax.jit(lambda sk, k, mm: jc.encrypt_sym(jctx, sk, k, mm))(
        old.sk, jax.random.PRNGKey(batch), jnp.asarray(m))
    want = jax.jit(lambda k, c: ja.rekey(jctx, k, c).data)(ksks[3], jct)
    tk = interop.rekey_keys_from_arrays({"ksk_3": np.asarray(ksks[3])}, device="cpu")[3]
    got = ta.rekey(tctx, tk, interop.ciphertext_from_array(np.asarray(jct.data), 3,
                                                           device="cpu"))
    _eq(got.data, want)
    _eq(tc.decrypt(tctx, tnew.sk, got), m)
    assert not (tc.decrypt(tctx, told.sk, got).numpy() == m).all()


def test_rekey_cross_decryption_and_budget():
    """The port's own keys and re-key keys: JAX decrypts the port's re-keyed
    ciphertext under the new secret; the budget drops by at most 3 bits."""
    jctx, tctx, _, _, _, _, _ = _setup()
    rt_old, rt_new = (FheRuntime(PRESET, rlk_levels=[], device="cpu") for _ in range(2))
    rt_old.generate_keys(seed=3)
    rt_new.generate_keys(seed=4)
    ksks = tc.rekey_keygen(tctx, torch.Generator().manual_seed(5), rt_old.keys.sk,
                           rt_new.keys.sk, levels=[2, 3])
    rng = np.random.default_rng(6)
    m = rng.integers(-1000, 1001, size=(3, tctx.n)).astype(np.int32)
    ct = rt_old.encrypt(m, seed=7)
    before = noise.noise_budget_bits(tctx, rt_old.keys.sk, ct)
    ct2 = ta.rekey(tctx, ksks[3], ct)
    after = noise.noise_budget_bits(tctx, rt_new.keys.sk, ct2)
    assert after >= before - 3, (before, after)
    _eq(rt_new.decrypt(ct2), m)
    arr = interop.keys_to_arrays(rt_new.keys)
    jsk = jc.SecretKey(*(jnp.asarray(arr[k]) for k in ("s", "s_ntt_mont", "s2_ntt_mont")))
    back = jax.jit(lambda sk, d: jc.decrypt(jctx, sk, jc.Ciphertext(d, 3, True, 1)))(
        jsk, jnp.asarray(ct2.data.numpy()))
    _eq(back, m)
    # After a switch to level 2 the level-2 key applies; the message stays exact.
    low = ta.mod_switch(tctx, ct)
    _eq(rt_new.decrypt(ta.rekey(tctx, ksks[2], low)), m)
    with pytest.raises(ValueError):
        tc.rekey_keygen(tctx, torch.Generator(), rt_old.keys.sk, rt_new.keys.sk, levels=[1])


def test_rekeyed_ciphertext_stays_multiplication_grade():
    """A re-keyed pair still gives an exact relinearized compare under the new key."""
    _, tctx, _, _, _, _, _ = _setup()
    rt_old = FheRuntime(PRESET, rlk_levels=[], device="cpu")
    rt_new = FheRuntime(PRESET, rlk_levels=[3], device="cpu")
    rt_old.generate_keys(seed=8)
    rt_new.generate_keys(seed=9)
    ksk = tc.rekey_keygen(tctx, torch.Generator().manual_seed(10), rt_old.keys.sk,
                          rt_new.keys.sk, levels=[3])[3]
    rng = np.random.default_rng(11)
    a, b = rng.integers(-1000, 1001, size=(2, 128)).astype(np.int32)
    ca = ta.rekey(tctx, ksk, rt_old.encrypt_vector(a, seed=1))
    cb = ta.rekey(tctx, ksk, rt_old.encrypt_vector(b, seed=2, rev=True))
    assert int(rt_new.decrypt_dot(rt_new.dot_ct_ct(ca, cb), 128)) == int(a.astype(np.int64) @ b)
