"""Port modulus switching bit-exact against the JAX package (3 limbs)."""

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
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import get_params

PRESET = "test-512-mult"


@functools.lru_cache(maxsize=None)
def _setup():
    jctx = JaxContext(jax_params(PRESET))
    tctx = CryptoContext(get_params(PRESET), device="cpu")
    jks = jax.jit(lambda k: jc.keygen(jctx, k, rlk_levels=[]))(jax.random.PRNGKey(0))
    tks = interop.keys_from_arrays(tctx, {
        "s": np.asarray(jks.sk.s), "s_ntt_mont": np.asarray(jks.sk.s_ntt_mont),
        "s2_ntt_mont": np.asarray(jks.sk.s2_ntt_mont),
        "pk_b": np.asarray(jks.pk.b_ntt), "pk_a": np.asarray(jks.pk.a_ntt)})
    rng = np.random.default_rng(1)
    m = rng.integers(-(jctx.t // 2), jctx.t // 2, size=(2, 3, jctx.n)).astype(np.int32)
    ct = jax.jit(lambda sk, k, mm: jc.encrypt_sym(jctx, sk, k, mm))(
        jks.sk, jax.random.PRNGKey(2), jnp.asarray(m))
    return jctx, tctx, jks, tks, m, ct


@pytest.mark.parametrize("target", [2, 1])
def test_mod_switch_to_matches_jax(target):
    jctx, tctx, jks, tks, m, jct = _setup()
    if jctx.q_at(target) < 4 * jctx.t * jctx.n:
        with pytest.raises(ValueError, match="headroom"):
            ta.mod_switch_to(tctx, interop.ciphertext_from_array(
                np.asarray(jct.data), jct.level, device="cpu"), target)
        return
    want = jax.jit(lambda c: ja.mod_switch_to(jctx, c, target))(jct)
    ct = interop.ciphertext_from_array(np.asarray(jct.data), jct.level, device="cpu")
    got = ta.mod_switch_to(tctx, ct, target)
    assert (got.level, got.pt_corr) == (want.level, want.pt_corr)
    assert got.pt_corr != 1
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(tc.decrypt(tctx, tks.sk, got).numpy(), m)


def test_mod_switch_one_step_and_noop():
    jctx, tctx, _, tks, m, jct = _setup()
    ct = interop.ciphertext_from_array(np.asarray(jct.data), jct.level, device="cpu")
    want = jax.jit(lambda c: ja.mod_switch(jctx, c))(jct)
    got = ta.mod_switch(tctx, ct)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert ta.mod_switch_to(tctx, got, 2) is got
    with pytest.raises(ValueError):
        ta.mod_switch(tctx, tc.Ciphertext(got.data[..., :1, :, :], 2))


def _port(jct):
    return interop.ciphertext_from_array(np.asarray(jct.data), jct.level, jct.pt_corr,
                                         device="cpu")


@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_add_sub_neg_match_jax(op):
    jctx, tctx, _, tks, m, jct = _setup()
    other = jc.Ciphertext(jct.data[::-1], jct.level, True)
    args = (jct,) if op == "neg" else (jct, other)
    want = jax.jit(lambda *c: getattr(ja, op)(jctx, *c).data)(*args)
    got = getattr(ta, op)(tctx, *(_port(c) for c in args))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want))
    oracle = {"add": m + m[::-1], "sub": m - m[::-1], "neg": -m}[op].astype(np.int64)
    t = jctx.t
    oracle = (oracle + t // 2) % t - t // 2
    np.testing.assert_array_equal(tc.decrypt(tctx, tks.sk, got).numpy(), oracle)
    with pytest.raises(ValueError):
        ta.add(tctx, _port(jct), ta.mod_switch(tctx, _port(jct)))


def test_add_plain_matches_jax():
    jctx, tctx, _, tks, m, jct = _setup()
    rng = np.random.default_rng(3)
    pt = rng.integers(-1000, 1001, size=(3, jctx.n)).astype(np.int32)
    want = jax.jit(lambda c, p: ja.add_plain(jctx, c, p).data)(jct, jnp.asarray(pt))
    got = ta.add_plain(tctx, _port(jct), torch.from_numpy(pt))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want))
    t = jctx.t
    oracle = (m.astype(np.int64) + pt + t // 2) % t - t // 2
    np.testing.assert_array_equal(tc.decrypt(tctx, tks.sk, got).numpy(), oracle)


@pytest.mark.parametrize("pairs", ["elementwise", "all-pairs"])
def test_mul_ct_matches_jax(pairs):
    jctx, tctx, jks, tks, m, jct = _setup()
    a, b = jct.data[0], jct.data[1]                               # (3, 2, L, N) each
    if pairs == "all-pairs":
        a, b = a[:, None], b[None, :]
    want = jax.jit(lambda x, y: ja.mul_ct(jctx, jc.Ciphertext(x, 3, True),
                                          jc.Ciphertext(y, 3, True)))(a, b)
    got = ta.mul_ct(tctx, tc.Ciphertext(torch.from_numpy(np.array(a)), 3),
                    tc.Ciphertext(torch.from_numpy(np.array(b)), 3))
    assert got.k == 3 and got.pt_corr == want.pt_corr
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    ma, mb = (m[0], m[1]) if pairs == "elementwise" else (m[0][:, None], m[1][None, :])
    dec = tc.decrypt(tctx, tks.sk, got).numpy()
    want_dec = jax.jit(lambda sk, d: jc.decrypt(jctx, sk, jc.Ciphertext(d, 3, True)))(
        jks.sk, want.data)
    np.testing.assert_array_equal(dec, np.asarray(want_dec))
    assert dec.shape == np.broadcast_shapes(ma.shape, mb.shape)
