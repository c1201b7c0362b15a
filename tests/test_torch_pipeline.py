"""The port's two-stage pipelined packed scoring, bit-exact.

The JAX package's `make_pipelined_scores` runs on a 2-device `pp` mesh of
the conftest's virtual CPU devices; the port's on a 2-shard `pp` mesh of
CPU shards.  Both must equal the int64 oracle `docs @ query`, each other,
and the port's single-shard `packed_scores`.  The JAX package's own cases
(groups, n_micro) are kept.  Tolerance: none.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import pack as jpack
from fhe_icp_tpu.ops.params import CryptoParams as JaxParams
from fhe_icp_tpu.ops.runtime import FheRuntime as JaxRuntime
from fhe_icp_tpu.parallel import pipeline as jpipe
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import pack
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import CryptoParams
from fhe_icp_tpu_torch.parallel import pipeline

D = 128


@functools.lru_cache(maxsize=None)
def _setup():
    """The JAX package's pipeline preset (N = 512, 2 limbs), its keys in the port."""
    jrt = JaxRuntime(JaxParams("pp2-512", n=512, n_limbs=2, allow_insecure=True))
    jrt.generate_keys(seed=0)
    ks = jrt.keys
    tctx = CryptoContext(CryptoParams("pp2-512", n=512, n_limbs=2, allow_insecure=True),
                         device="cpu")
    tks = interop.keys_from_arrays(tctx, {
        "s": np.asarray(ks.sk.s), "s_ntt_mont": np.asarray(ks.sk.s_ntt_mont),
        "s2_ntt_mont": np.asarray(ks.sk.s2_ntt_mont),
        "pk_b": np.asarray(ks.pk.b_ntt), "pk_a": np.asarray(ks.pk.a_ntt)})
    return jrt, tctx, tks


@functools.lru_cache(maxsize=None)
def _operands(groups, seed=0):
    """As the JAX package's test: packed encryptions of docs and both operands."""
    jrt, tctx, tks = _setup()
    slots = pack.slots_per_ct(tctx.n, D)
    rng = np.random.default_rng(seed)
    docs = rng.integers(-1000, 1001, size=(groups * slots, D)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(D,)).astype(np.int32)
    polys = jpack.encode_packed(jnp.asarray(docs.reshape(groups, slots, D)), jrt.ctx.n)
    ct = jrt.encrypt(np.asarray(polys), seed=1)
    dop = pack.make_packed_doc_operand(tctx, torch.from_numpy(np.array(ct.data)), ct.level)
    qop = pack.make_packed_query_operand(tctx, tks.sk, torch.from_numpy(query), D, ct.level)
    return dop, qop, docs, query, slots


@pytest.mark.parametrize("groups,n_micro", [(4, 4), (8, 2), (6, 3)])
def test_pipelined_scores_exact(groups, n_micro):
    _, tctx, _ = _setup()
    dop, qop, docs, query, slots = _operands(groups)
    mesh = pipeline.make_pp_mesh(2, device="cpu")
    fn = pipeline.make_pipelined_scores(tctx, mesh, dop.level, slots, n_micro)
    got = fn(dop.digits, qop.digits)
    assert got.shape == (groups, slots) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(-1).astype(np.int64),
                                  docs.astype(np.int64) @ query.astype(np.int64))


def test_pipeline_matches_packed_scores_and_jax():
    jrt, tctx, _ = _setup()
    dop, qop, _, _, slots = _operands(8, seed=3)
    fn = pipeline.make_pipelined_scores(tctx, pipeline.make_pp_mesh(device="cpu"), dop.level,
                                        slots, n_micro=4)
    got = fn(dop.digits, qop.digits)
    np.testing.assert_array_equal(got.numpy(), pack.packed_scores(tctx, dop, qop).numpy())
    jfn = jpipe.make_pipelined_scores(jrt.ctx, jpipe.make_pp_mesh(2), dop.level, slots, 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfn(jnp.asarray(dop.digits.numpy()),
                                    jnp.asarray(qop.digits.numpy()))))


def test_pipeline_mesh_and_microbatch_checks():
    _, tctx, _ = _setup()
    mesh = pipeline.make_pp_mesh(device="cpu")
    assert mesh.axes == (pipeline.PP_AXIS,) and mesh.shape == {"pp": pipeline.N_STAGES}
    dop, qop, _, _, slots = _operands(4)
    with pytest.raises(ValueError):          # 16 rows are not 3 microbatches of groups
        pipeline.make_pipelined_scores(tctx, mesh, dop.level, slots, 3)(dop.digits, qop.digits)
    with pytest.raises(ValueError):          # exactly two stages
        pipeline.make_pipelined_scores(tctx, pipeline.make_pp_mesh(4, device="cpu"),
                                       dop.level, slots, 2)
