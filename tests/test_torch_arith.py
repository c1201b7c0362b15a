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
