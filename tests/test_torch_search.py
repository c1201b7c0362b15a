"""Port sharded searches, padded operands and hierarchical top-k bit-exact vs JAX.

The JAX package runs its sharded programs on the conftest's 8 virtual CPU
devices; the port runs the same programs on 8 logical CPU shards, with
the scoring kernel's plain version.  Keys and ciphertexts come from the
JAX runtime through `interop`.  Scores must equal the JAX package's and
`docs @ query`; top-k values must equal, and each returned index must
point at a score equal to its value (the two top-k routines may order
ties differently).  Tolerance: none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import pack as jpack
from fhe_icp_tpu.ops.runtime import FheRuntime as JaxRuntime
from fhe_icp_tpu.parallel import mesh as jmesh
from fhe_icp_tpu.parallel import search as jsearch
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import pack
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import get_params
from fhe_icp_tpu_torch.parallel import search
from fhe_icp_tpu_torch.parallel.mesh import BATCH_SPEC, PACKED_OPERAND_SPEC, make_mesh, shard

PRESET, D = "test-512", 64


@functools.lru_cache(maxsize=None)
def _setup():
    jrt = JaxRuntime(PRESET, rlk_levels=[])
    jrt.generate_keys(seed=0)
    ks = jrt.keys
    tctx = CryptoContext(get_params(PRESET), device="cpu")
    tks = interop.keys_from_arrays(tctx, {
        "s": np.asarray(ks.sk.s), "s_ntt_mont": np.asarray(ks.sk.s_ntt_mont),
        "s2_ntt_mont": np.asarray(ks.sk.s2_ntt_mont),
        "pk_b": np.asarray(ks.pk.b_ntt), "pk_a": np.asarray(ks.pk.a_ntt)})
    return jrt, tctx, tks


@functools.lru_cache(maxsize=None)
def _packed_case(groups, negative):
    """Docs, query, JAX packed ciphertexts and query operand digits."""
    jrt, _, _ = _setup()
    slots = jpack.slots_per_ct(jrt.ctx.n, D)
    rng = np.random.default_rng(groups)
    docs = rng.integers(1 if negative else -500, 500, size=(groups * slots, D))
    docs = (-docs if negative else docs).astype(np.int32)
    query = rng.integers(1, 500, size=(D,)).astype(np.int32)
    cts = jrt.encrypt_vector(docs, seed=groups)
    packed = np.array(jpack.pack_ciphertexts(jrt.ctx, cts.data, D, cts.level))
    qop = np.array(jpack.make_packed_query_operand(jrt.ctx, jrt.keys.sk, jnp.asarray(query),
                                                   D, cts.level).digits)
    return docs, query, packed, qop, cts.level


def _check_topk(vals, idx, scores, want_vals):
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(want_vals))
    np.testing.assert_array_equal(np.asarray(scores)[np.asarray(idx)], np.asarray(vals))


@pytest.mark.parametrize("n,ties", [(4096, False), (8192, True), (9000, False),
                                    (16384, True), (100_003, False)])
def test_topk_hierarchical_matches_jax(n, ties):
    rng = np.random.default_rng(n)
    hi = 50 if ties else 2 ** 31 - 1
    flat = rng.integers(-hi, hi, size=(n,), dtype=np.int64).astype(np.int32)
    jv, ji = jsearch.topk_hierarchical(jnp.asarray(flat), 7)
    tv, ti = search.topk_hierarchical(torch.from_numpy(flat), 7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _check_topk(tv.numpy(), ti.numpy(), flat, np.asarray(jv))
    assert (ti.numpy() < n).all()


@pytest.mark.parametrize("groups,pad_to", [(3, 8), (8, 8), (5, 1), (8, 16)])
def test_padded_doc_operand_matches_jax(groups, pad_to):
    jrt, tctx, _ = _setup()
    _, _, packed, _, level = _packed_case(groups, False)
    want = jpack.make_packed_doc_operand(jrt.ctx, jnp.asarray(packed), level,
                                         pad_groups_to=pad_to)
    got = pack.make_packed_doc_operand(tctx, torch.from_numpy(packed), level,
                                       pad_groups_to=pad_to)
    np.testing.assert_array_equal(got.digits.numpy(), np.asarray(want.digits))
    assert (got.groups, got.n_groups) == (want.groups, want.n_groups)
    slots = pack.slots_per_ct(tctx.n, D)
    assert got.real_docs(slots) == want.real_docs(slots) == groups * slots


@pytest.mark.parametrize("groups,pad_to,negative", [(8, 1, False), (5, 8, True),
                                                    (16, 1, False)])
@pytest.mark.parametrize("masked", [False, True])
def test_sharded_packed_search_matches_jax(groups, pad_to, negative, masked):
    jrt, tctx, _ = _setup()
    docs, query, packed, qop, level = _packed_case(groups, negative)
    n_docs = len(docs) if masked else None
    k = 5
    jdop = jpack.make_packed_doc_operand(jrt.ctx, jnp.asarray(packed), level,
                                         pad_groups_to=pad_to)
    jm = jmesh.make_mesh(8, shape=(8, 1))
    jstep = jsearch.make_sharded_packed_search(jrt.ctx, jm, d=D, top_k=k, n_docs=n_docs)
    jflat, jvals, _ = jstep(jax.device_put(jdop.digits, jsearch.packed_operand_sharding(jm)),
                            jnp.asarray(qop))

    dop = pack.make_packed_doc_operand(tctx, torch.from_numpy(packed), level,
                                       pad_groups_to=pad_to)
    mesh = make_mesh(8, (8, 1), device="cpu")
    step = search.make_sharded_packed_search(tctx, mesh, d=D, top_k=k, n_docs=n_docs)
    flat, vals, idx = step(shard(mesh, dop.digits, PACKED_OPERAND_SPEC), torch.from_numpy(qop))

    want = docs.astype(np.int64) @ query.astype(np.int64)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(flat.numpy()[: len(want)].astype(np.int64), want)
    np.testing.assert_array_equal(flat.numpy()[len(want):], 0)
    _check_topk(vals.numpy(), idx.numpy(), flat.numpy(), np.asarray(jvals))
    if masked:
        assert (idx.numpy() < len(docs)).all()
        np.testing.assert_array_equal(vals.numpy().astype(np.int64), np.sort(want)[::-1][:k])


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_sharded_search_matches_jax(shape):
    jrt, tctx, tks = _setup()
    rng = np.random.default_rng(23)
    d, batch, k = 128, 16, 3
    docs = rng.integers(-1000, 1001, size=(batch, d)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(d,)).astype(np.int32)
    cts = jrt.encrypt_vector(docs, seed=31)
    jm = jmesh.make_mesh(8, shape=shape)
    jstep = jsearch.make_sharded_search(jrt.ctx, jrt.keys.sk, jm, d=d, level=cts.level,
                                        top_k=k)
    jscores, jvals, _ = jstep(jax.device_put(cts.data, jmesh.batch_sharding(jm)),
                              jnp.asarray(query))

    mesh = make_mesh(8, shape, device="cpu")
    step = search.make_sharded_search(tctx, tks.sk, mesh, d=d, level=cts.level, top_k=k)
    data = torch.from_numpy(np.array(cts.data))
    scores, vals, idx = step(shard(mesh, data, BATCH_SPEC), torch.from_numpy(query))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    np.testing.assert_array_equal(scores.numpy().astype(np.int64),
                                  docs.astype(np.int64) @ query.astype(np.int64))
    _check_topk(vals.numpy(), idx.numpy(), scores.numpy(), np.asarray(jvals))
