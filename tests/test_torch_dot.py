"""Port plaintext operands and encrypted dot products bit-exact vs JAX.

Keys and ciphertexts come from the JAX package's runtime and are carried
to the port through `interop`; `plain_to_eval`, `mul_plain`,
`dot_ct_pt`, `matvec_ct_pt` and `decrypt_dot` must return the same
integers as the JAX functions, and the scores must equal `docs @ query`.
Tolerance: none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import arith as ja
from fhe_icp_tpu.ops import dot as jdot
from fhe_icp_tpu.ops.cipher import Ciphertext as JaxCiphertext
from fhe_icp_tpu.ops.encoding import encode_rev as jencode_rev
from fhe_icp_tpu.ops.runtime import FheRuntime as JaxRuntime
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import arith, dot
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.encoding import encode_rev
from fhe_icp_tpu_torch.ops.params import get_params

D = 128


@functools.lru_cache(maxsize=None)
def _setup(preset):
    jrt = JaxRuntime(preset, rlk_levels=[])
    jrt.generate_keys(seed=0)
    ks = jrt.keys
    tctx = CryptoContext(get_params(preset), device="cpu")
    tks = interop.keys_from_arrays(tctx, {
        "s": np.asarray(ks.sk.s), "s_ntt_mont": np.asarray(ks.sk.s_ntt_mont),
        "s2_ntt_mont": np.asarray(ks.sk.s2_ntt_mont),
        "pk_b": np.asarray(ks.pk.b_ntt), "pk_a": np.asarray(ks.pk.a_ntt)})
    rng = np.random.default_rng(5)
    docs = rng.integers(-1000, 1001, size=(6, D)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(D,)).astype(np.int32)
    cts = jrt.encrypt_vector(docs, seed=1)
    return jrt, tctx, tks, docs, query, cts


@pytest.mark.parametrize("preset", ["test-512", "test-512-mult"])
def test_plain_to_eval_matches_jax(preset):
    jrt, tctx, _, _, query, _ = _setup(preset)
    for l in range(1, tctx.n_limbs + 1):
        want = jax.jit(lambda q, l=l: ja.plain_to_eval(jrt.ctx, jencode_rev(q, jrt.ctx.n), l))(
            jnp.asarray(query))
        got = arith.plain_to_eval(tctx, encode_rev(torch.from_numpy(query), tctx.n), l)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("preset", ["test-512", "test-512-mult"])
def test_matvec_and_decrypt_dot_match_jax(preset):
    jrt, tctx, tks, docs, query, cts = _setup(preset)
    jctx = jrt.ctx
    want_ct = jax.jit(lambda c, q: jdot.matvec_ct_pt(
        jctx, JaxCiphertext(c, cts.level, True), q).data)(cts.data, jnp.asarray(query))
    tct = interop.ciphertext_from_array(np.asarray(cts.data), cts.level, device="cpu")
    got = dot.matvec_ct_pt(tctx, tct, torch.from_numpy(query))
    assert (got.level, got.pt_corr) == (cts.level, 1)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want_ct))
    want = jax.jit(lambda sk, c: jdot.decrypt_dot(
        jctx, sk, JaxCiphertext(c, cts.level, True), D))(jrt.keys.sk, want_ct)
    scores = dot.decrypt_dot(tctx, tks.sk, got, D)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want))
    np.testing.assert_array_equal(scores.numpy().astype(np.int64),
                                  docs.astype(np.int64) @ query.astype(np.int64))


def test_dot_ct_pt_and_mul_plain_match_jax():
    jrt, tctx, tks, docs, query, cts = _setup("test-512")
    jctx = jrt.ctx
    one = JaxCiphertext(cts.data[2], cts.level, True)
    want = jax.jit(lambda c, q: jdot.dot_ct_pt(
        jctx, JaxCiphertext(c, cts.level, True), q).data)(one.data, jnp.asarray(query))
    tct = interop.ciphertext_from_array(np.asarray(one.data), cts.level, device="cpu")
    got = dot.dot_ct_pt(tctx, tct, torch.from_numpy(query))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want))
    pt = arith.plain_to_eval(tctx, encode_rev(torch.from_numpy(query), tctx.n), cts.level)
    np.testing.assert_array_equal(arith.mul_plain(tctx, tct, pt).data.numpy(), np.asarray(want))
    assert int(dot.decrypt_dot(tctx, tks.sk, got, D)) == int(docs[2].astype(np.int64)
                                                            @ query.astype(np.int64))
