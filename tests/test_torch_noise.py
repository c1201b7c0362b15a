"""Port noise accounting equal to the JAX package's on the same ciphertexts.

Fresh, degree-2, relinearized and modulus-switched ciphertexts made by the
JAX package at test-512-mult are carried to the port through `interop`;
`phase_centered`, `noise_budget_bits` and `noise_budget_bits_batch` must
return exactly the JAX numbers.  Tolerance: none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fhe_icp_tpu.ops import arith as ja
from fhe_icp_tpu.ops import cipher as jc
from fhe_icp_tpu.ops import noise as jn
from fhe_icp_tpu.ops.context import CryptoContext as JaxContext
from fhe_icp_tpu.ops.params import get_params as jax_params
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import noise as tn
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import get_params

PRESET = "test-512-mult"


@functools.lru_cache(maxsize=None)
def _setup():
    jctx = JaxContext(jax_params(PRESET))
    tctx = CryptoContext(get_params(PRESET), device="cpu")
    jks = jax.jit(lambda k: jc.keygen(jctx, k, rlk_levels=[3]))(jax.random.PRNGKey(0))
    arrays = {"s": jks.sk.s, "s_ntt_mont": jks.sk.s_ntt_mont, "s2_ntt_mont": jks.sk.s2_ntt_mont,
              "pk_b": jks.pk.b_ntt, "pk_a": jks.pk.a_ntt}
    tks = interop.keys_from_arrays(tctx, {k: np.asarray(v) for k, v in arrays.items()})
    rng = np.random.default_rng(1)
    m = rng.integers(-1000, 1001, size=(4, jctx.n)).astype(np.int32)
    fresh = jax.jit(lambda sk, k, mm: jc.encrypt_sym(jctx, sk, k, mm))(
        jks.sk, jax.random.PRNGKey(2), jnp.asarray(m))

    @jax.jit
    def derived(rk, c):
        prod = ja.mul_ct(jctx, jc.Ciphertext(c.data[:2], 3, True), jc.Ciphertext(c.data[2:], 3, True))
        return prod, ja.relinearize(jctx, rk, prod), ja.mod_switch(jctx, c)
    deg2, relin, switched = derived(jks.rlk.keys, fresh)
    cts = {"fresh": fresh, "degree 2": deg2, "relinearized": relin, "switched": switched}
    return jctx, tctx, jks, tks, cts


def _port(ct):
    return interop.ciphertext_from_array(np.asarray(ct.data), ct.level, ct.pt_corr, device="cpu")


KINDS = ["fresh", "degree 2", "relinearized", "switched"]


@pytest.mark.parametrize("kind", KINDS)
def test_noise_budget_bits_matches_jax(kind):
    jctx, tctx, jks, tks, cts = _setup()
    ct = cts[kind]
    want = jn.noise_budget_bits(jctx, jks.sk, ct, max_coeffs=64)
    got = tn.noise_budget_bits(tctx, tks.sk, _port(ct), max_coeffs=64)
    assert isinstance(got, int) and got == want and got > 0


@pytest.mark.parametrize("kind", ["fresh", "relinearized"])
def test_noise_budget_bits_batch_matches_jax(kind):
    jctx, tctx, jks, tks, cts = _setup()
    ct = cts[kind]
    want = jn.noise_budget_bits_batch(jctx, jks.sk, ct, coeffs_per_ct=16)
    got = tn.noise_budget_bits_batch(tctx, tks.sk, _port(ct), coeffs_per_ct=16)
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_phase_centered_matches_jax():
    jctx, tctx, jks, tks, cts = _setup()
    want = jn.phase_centered(jctx, jks.sk, cts["degree 2"], max_coeffs=40)
    got = tn.phase_centered(tctx, tks.sk, _port(cts["degree 2"]), max_coeffs=40)
    assert got.dtype == object and list(got) == list(want)


def test_budget_of_a_zero_phase_and_a_wrapped_one():
    """A zero phase reports log2(q) - 1 bits; a ciphertext under another key
    reports the floor, as in JAX."""
    jctx, tctx, jks, tks, cts = _setup()
    zero = interop.ciphertext_from_array(np.zeros((2, 3, jctx.n), np.uint32), 3, device="cpu")
    assert tn.noise_budget_bits(tctx, tks.sk, zero) == jctx.q_at(3).bit_length() - 1
    other = jax.jit(lambda k: jc.keygen(jctx, k, rlk_levels=[]))(jax.random.PRNGKey(5))
    osk = interop.keys_from_arrays(tctx, {
        "s": np.asarray(other.sk.s), "s_ntt_mont": np.asarray(other.sk.s_ntt_mont),
        "s2_ntt_mont": np.asarray(other.sk.s2_ntt_mont), "pk_b": np.asarray(other.pk.b_ntt),
        "pk_a": np.asarray(other.pk.a_ntt)}).sk
    want = jn.noise_budget_bits(jctx, other.sk, cts["fresh"])
    assert tn.noise_budget_bits(tctx, osk, _port(cts["fresh"])) == want <= 1
