"""The port's encrypted packed search end to end, on the CPU, against JAX.

Keys come from a JAX FheRuntime through `interop` (or from the port's own
keygen); the port encrypts per-document vectors, packs them, switches to
2 limbs, builds both operands, scores and ranks.  The scores must equal
the JAX package's `packed_scores` on the same ciphertexts and the int64
oracle `docs @ query`, and the top-k must hold the oracle's top-k scores.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import arith as ja
from fhe_icp_tpu.ops import pack as jpack
from fhe_icp_tpu.ops.cipher import Ciphertext as JaxCiphertext
from fhe_icp_tpu.ops.cipher import SecretKey as JaxSecretKey
from fhe_icp_tpu.ops.runtime import FheRuntime as JaxRuntime
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import arith, pack
from fhe_icp_tpu_torch.ops.cipher import Ciphertext
from fhe_icp_tpu_torch.ops.runtime import FheRuntime

PRESET, D, TOP_K = "test-512", 128, 5


@functools.lru_cache(maxsize=None)
def _jax_runtime():
    rt = JaxRuntime(PRESET, rlk_levels=[])
    rt.generate_keys(seed=0)
    return rt


def _port_runtime(keys_from):
    if keys_from == "port":
        rt = FheRuntime(PRESET, device="cpu")
        rt.generate_keys(seed=3)
        return rt
    ks = _jax_runtime().keys
    arrays = {"s": ks.sk.s, "s_ntt_mont": ks.sk.s_ntt_mont, "s2_ntt_mont": ks.sk.s2_ntt_mont,
              "pk_b": ks.pk.b_ntt, "pk_a": ks.pk.a_ntt}
    rt = FheRuntime(PRESET, device="cpu")
    rt.keys = interop.keys_from_arrays(rt.ctx, {k: np.asarray(v) for k, v in arrays.items()})
    return rt


def _quantized_unit(rng, shape):
    v = rng.standard_normal(shape)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return np.round(v * 1000.0).astype(np.int32)


@pytest.mark.parametrize("keys_from", ["jax", "port"])
def test_search_slice(keys_from):
    rt = _port_runtime(keys_from)
    ctx, sk = rt.ctx, rt.keys.sk
    slots = pack.slots_per_ct(ctx.n, D)
    rng = np.random.default_rng(7)
    docs = _quantized_unit(rng, (6 * slots - 2, D))
    queries = _quantized_unit(rng, (2, D))

    ct = rt.encrypt_vector(docs, seed=11)
    assert ct.data.shape == (len(docs), 2, ctx.n_limbs, ctx.n)
    np.testing.assert_array_equal(rt.decrypt(ct)[:, :D].numpy(), docs)
    packed = Ciphertext(pack.pack_ciphertexts(ctx, ct.data, D, ct.level), ct.level)
    packed = arith.mod_switch_to(ctx, packed, 2)
    dop = pack.make_packed_doc_operand(ctx, packed.data, packed.level)

    jrt = _jax_runtime()
    jctx = jrt.ctx
    data, level, corr = interop.ciphertext_to_array(packed)
    jdop = jpack.make_packed_doc_operand(jctx, jnp.asarray(data), level)
    arr = interop.keys_to_arrays(rt.keys)
    jsecret = JaxSecretKey(*(jnp.asarray(arr[k]) for k in ("s", "s_ntt_mont", "s2_ntt_mont")))
    for q in queries:
        qop = pack.make_packed_query_operand(ctx, sk, torch.from_numpy(q), D, packed.level)
        scores = pack.packed_scores(ctx, dop, qop, packed.pt_corr)
        flat = scores.reshape(-1)[: len(docs)]
        want = docs.astype(np.int64) @ q.astype(np.int64)
        np.testing.assert_array_equal(flat.numpy().astype(np.int64), want)
        top = torch.topk(flat, TOP_K).values.numpy()
        np.testing.assert_array_equal(np.sort(top), np.sort(want)[-TOP_K:])
        jq = jpack.make_packed_query_operand(jctx, jsecret, jnp.asarray(q), D, level)
        jscores = jpack.packed_scores(jctx, jdop, jq, corr, impl="xla")
        np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))


def test_fresh_randomness_by_default():
    rt = _port_runtime("port")
    v = np.ones((2, D), dtype=np.int32)
    a, b = rt.encrypt_vector(v), rt.encrypt_vector(v)
    assert not torch.equal(a.data, b.data)
    assert torch.equal(rt.encrypt_vector(v, seed=1).data, rt.encrypt_vector(v, seed=1).data)
    np.testing.assert_array_equal(rt.decrypt(a).numpy(), rt.decrypt(b).numpy())
    with pytest.raises(RuntimeError, match="generate_keys"):
        FheRuntime(PRESET, device="cpu").encrypt(np.zeros(512, np.int32))


def test_jax_mod_switch_agrees_on_port_ciphertexts():
    """The pt_corr bookkeeping of both packages agrees after a switch."""
    rt = FheRuntime("test-512-mult", device="cpu")
    rt.generate_keys(seed=4)
    m = np.arange(512, dtype=np.int32) - 256
    ct = rt.encrypt(m, seed=5)
    sw = rt.mod_switch(ct)
    jrt = JaxRuntime("test-512-mult", rlk_levels=[])
    data, level, corr = interop.ciphertext_to_array(ct)
    jsw = jax.jit(lambda d: ja.mod_switch(jrt.ctx, JaxCiphertext(d, level, True, corr)))(
        jnp.asarray(data))
    assert sw.pt_corr == jsw.pt_corr
    np.testing.assert_array_equal(sw.data.numpy(), np.asarray(jsw.data))
    np.testing.assert_array_equal(rt.decrypt(sw).numpy(), m)
