"""The port's sharded fastdot search against the JAX package's, on 8 shards.

The JAX package runs `make_sharded_fastdot_search` on the conftest's 8
virtual CPU devices; the port runs its counterpart on 8 logical CPU
shards.  Keys and ciphertexts come from the JAX runtime through
`interop`.  Scores must equal JAX's and `docs @ query`; top-k values must
equal, and each returned index must point at a score equal to its value
(the two top-k routines may order ties differently).  Tolerance: none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import fastdot as jfd
from fhe_icp_tpu.ops.runtime import FheRuntime as JaxRuntime
from fhe_icp_tpu.parallel import mesh as jmesh
from fhe_icp_tpu.parallel import search as jsearch
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import fastdot
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import get_params
from fhe_icp_tpu_torch.parallel import search
from fhe_icp_tpu_torch.parallel.mesh import (DOC_OPERAND_SPEC, PACKED_OPERAND_SPEC, gather,
                                             make_mesh, shard)

PRESET, D = "test-512", 128


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


@pytest.mark.parametrize("batch,k", [(32, 5), (16, 20), (64, 3)])
def test_sharded_fastdot_search_matches_jax(batch, k):
    jrt, tctx, tks = _setup()
    rng = np.random.default_rng(batch)
    docs = rng.integers(-1000, 1001, size=(batch, D)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(D,)).astype(np.int32)
    cts = jrt.encrypt_vector(docs, seed=batch)
    k = min(k, batch)

    jd = jfd.make_doc_operand(jrt.ctx, cts.data, cts.level)
    jq = jfd.make_query_operand(jrt.ctx, jrt.keys.sk, jnp.asarray(query), D, cts.level)
    jm = jmesh.make_mesh(8, shape=(8, 1))
    jstep = jsearch.make_sharded_fastdot_search(jrt.ctx, jm, top_k=k)
    jscores, jvals, _ = jstep(jax.device_put(jd.digits, jsearch.doc_operand_sharding(jm)),
                              jq.digits)

    dop = fastdot.make_doc_operand(tctx, torch.from_numpy(np.array(cts.data)), cts.level)
    qop = fastdot.make_query_operand(tctx, tks.sk, torch.from_numpy(query), D, cts.level)
    mesh = make_mesh(8, (8, 1), device="cpu")
    shards = shard(mesh, dop.digits, search.doc_operand_sharding(mesh))
    assert all(s.shape == (2, 4, batch // 8, 2 * tctx.n) for s in shards)
    np.testing.assert_array_equal(gather(mesh, shards, DOC_OPERAND_SPEC).numpy(),
                                  np.asarray(jd.digits))
    step = search.make_sharded_fastdot_search(tctx, mesh, top_k=k)
    scores, vals, idx = step(shards, qop.digits)

    want = docs.astype(np.int64) @ query.astype(np.int64)
    np.testing.assert_array_equal(scores.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(scores.numpy()[idx.numpy()], vals.numpy())


def test_sharding_placements_name_the_specs():
    mesh = make_mesh(2, device="cpu")
    assert search.doc_operand_sharding(mesh) == DOC_OPERAND_SPEC == (None, None, "dp", None)
    assert search.packed_operand_sharding(mesh) == PACKED_OPERAND_SPEC
