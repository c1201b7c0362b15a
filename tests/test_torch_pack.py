"""Port packing, operands and scoring bit-exact against the JAX package.

Per-document ciphertexts come from the JAX package; the port packs them,
builds both int8 digit operands, folds the digit partials and scores, and
each step must equal its JAX counterpart (the scoring kernel's plain
version against the Pallas kernel in interpret mode) and the int64
oracle `docs @ query`.  Tolerance: none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import cipher as jc
from fhe_icp_tpu.ops import pack as jpack
from fhe_icp_tpu.ops import pack_pallas
from fhe_icp_tpu.ops.context import CryptoContext as JaxContext
from fhe_icp_tpu.ops.encoding import encode_fwd as jencode_fwd
from fhe_icp_tpu.ops.params import get_params as jax_params
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import pack, pack_cuda
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.modmath import add_mod
from fhe_icp_tpu_torch.ops.params import get_params

D = 128
PRESET = "test-512"


@functools.lru_cache(maxsize=None)
def _setup():
    jctx = JaxContext(jax_params(PRESET))
    tctx = CryptoContext(get_params(PRESET), device="cpu")
    jks = jax.jit(lambda k: jc.keygen(jctx, k, rlk_levels=[]))(jax.random.PRNGKey(0))
    arrays = {"s": np.asarray(jks.sk.s), "s_ntt_mont": np.asarray(jks.sk.s_ntt_mont),
              "s2_ntt_mont": np.asarray(jks.sk.s2_ntt_mont),
              "pk_b": np.asarray(jks.pk.b_ntt), "pk_a": np.asarray(jks.pk.a_ntt)}
    return jctx, tctx, jks, interop.keys_from_arrays(tctx, arrays)


@functools.lru_cache(maxsize=None)
def _case(groups):
    """Docs, query, per-doc JAX ciphertexts (ascending) and JAX operands."""
    jctx, tctx, jks, _ = _setup()
    slots = jpack.slots_per_ct(jctx.n, D)
    b = groups * slots - (1 if groups > 1 else 0)     # a ragged tail group
    rng = np.random.default_rng(groups)
    docs = rng.integers(-1000, 1001, size=(b, D)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(D,)).astype(np.int32)
    cts = jax.jit(lambda sk, k, v: jc.encrypt_sym(jctx, sk, k, jencode_fwd(v, jctx.n)).data)(
        jks.sk, jax.random.PRNGKey(groups), jnp.asarray(docs))
    level = jctx.n_limbs
    packed = jax.jit(lambda c: jpack.pack_ciphertexts(jctx, c, D, level))(cts)
    dop = jax.jit(lambda c: jpack.make_packed_doc_operand(jctx, c, level).digits)(packed)
    qop = jax.jit(lambda sk, q: jpack.make_packed_query_operand(
        jctx, sk, q, D, level).digits)(jks.sk, jnp.asarray(query))
    return dict(docs=docs, query=query, cts=np.array(cts), packed=np.array(packed),
                dop=np.array(dop), qop=np.array(qop), slots=slots, level=level)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_tables_match():
    jctx, tctx, _, _ = _setup()
    slots = jpack.slots_per_ct(jctx.n, D)
    _eq(pack._monomial_table(tctx, D, slots, 2), jpack._monomial_table(jctx, D, slots, 2))
    _eq(pack.packed_coeff_weights(tctx, D, slots, 2),
        jpack.packed_coeff_weights(jctx, D, slots, 2))
    _eq(pack_cuda._limb_tables(tctx, 2), pack_pallas._limb_tables(jctx, 2))
    _eq(pack_cuda._weight_tile(tctx, 2, slots), pack_pallas._weight_tile(jctx, 2, slots))


@pytest.mark.parametrize("groups", [1, 3, 8])
def test_pack_and_doc_operand_match(groups):
    _, tctx, _, _ = _setup()
    c = _case(groups)
    packed = pack.pack_ciphertexts(tctx, torch.from_numpy(c["cts"]), D, c["level"])
    _eq(packed, c["packed"])
    dop = pack.make_packed_doc_operand(tctx, packed, c["level"])
    assert dop.groups == groups
    _eq(dop.digits, c["dop"])


@pytest.mark.parametrize("groups", [1, 3, 8])
def test_query_operand_and_fold_match(groups):
    _, tctx, _, tks = _setup()
    c = _case(groups)
    qop = pack.make_packed_query_operand(tctx, tks.sk, torch.from_numpy(c["query"]), D,
                                         c["level"])
    _eq(qop.digits, c["qop"])
    assert (qop.d, qop.slots, qop.level) == (D, c["slots"], c["level"])
    part = jax.lax.dot_general(jnp.asarray(c["dop"]), jnp.asarray(c["qop"]),
                               (((2,), (1,)), ((0,), (0,))),
                               preferred_element_type=jnp.int32)
    jctx = _setup()[0]
    want = jpack.fold_separable(jctx, part, c["level"], c["slots"])
    _eq(pack.fold_separable(tctx, torch.from_numpy(np.array(part)), c["level"], c["slots"]),
        want)
    _eq(pack_cuda.int_matmul_ref(torch.from_numpy(c["dop"]), torch.from_numpy(c["qop"])),
        part)


@pytest.mark.parametrize("groups", [1, 3, 8])
def test_score_residues_match_pallas_kernel(groups):
    jctx, tctx, _, _ = _setup()
    c = _case(groups)
    want = pack_pallas.packed_score_residues(
        jctx, jnp.asarray(c["dop"]), jnp.asarray(c["qop"]), c["level"], c["slots"],
        interpret=True)
    got = pack_cuda.packed_score_residues(
        tctx, torch.from_numpy(c["dop"]), torch.from_numpy(c["qop"]), c["level"], c["slots"])
    _eq(got, want)


@pytest.mark.parametrize("groups", [1, 3, 8])
def test_packed_scores_match_oracle(groups):
    jctx, tctx, jks, tks = _setup()
    c = _case(groups)
    dop = pack.PackedDocOperand(torch.from_numpy(c["dop"]), c["level"])
    qop = pack.make_packed_query_operand(tctx, tks.sk, torch.from_numpy(c["query"]), D,
                                         c["level"])
    got = pack.packed_scores(tctx, dop, qop)
    assert got.shape == (groups, c["slots"]) and got.dtype == torch.int32
    want = c["docs"].astype(np.int64) @ c["query"].astype(np.int64)
    flat = got.reshape(-1).numpy().astype(np.int64)
    _eq(flat[: len(want)], want)
    _eq(flat[len(want):], 0)
    jdop = jpack.PackedDocOperand(jnp.asarray(c["dop"]), c["level"])
    jqop = jpack.PackedQueryOperand(jnp.asarray(c["qop"]), c["level"], D, c["slots"])
    _eq(got, jpack.packed_scores(jctx, jdop, jqop, impl="xla"))


@pytest.mark.parametrize("groups", [1, 3, 8])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_k_slices_add_up_to_pallas_kernel(splits, groups):
    """The fold is linear mod p: add_mod of the K slices' residues is the whole's.

    This is what the kernel's split K relies on; the slices are the ones
    the kernel takes (`k_slices`).
    """
    jctx, tctx, _, _ = _setup()
    c = _case(groups)
    want = pack_pallas.packed_score_residues(
        jctx, jnp.asarray(c["dop"]), jnp.asarray(c["qop"]), c["level"], c["slots"],
        interpret=True)
    a, v = torch.from_numpy(c["dop"]), torch.from_numpy(c["qop"])
    p = tctx.p[:c["level"]].reshape(-1, 1, 1)
    got = None
    for start, stop in pack_cuda.k_slices(a.shape[2], splits):
        part = pack_cuda.packed_score_residues_ref(
            tctx, a[:, :, start:stop].contiguous(), v[:, start:stop].contiguous(), c["level"],
            c["slots"])
        got = part if got is None else add_mod(got, part, p)
    _eq(got, want)


def test_k_split_rule():
    sms, tile = pack_cuda.SMS, pack_cuda.BLOCK_ROWS // 4
    # The single-shard store fills the card alone: no split.
    assert pack_cuda.k_splits(2, 2048, 8192, 128) == 1
    # One of 8 shards (391 groups, 26 tiles): split until one wave is nearly full.
    tiles = 2 * -(-391 // tile)
    s = pack_cuda.k_splits(2, 391, 8192, 128)
    assert tiles * s <= sms < tiles * (s + 1)
    # 4S = 512 (ring-16384 at d = 128) runs in two column tiles, which count
    # as tiles: 2048 groups then fill two waves and take no split either.
    assert pack_cuda.col_tiles(512) == 2 and pack_cuda.col_tiles(256) == 1
    assert pack_cuda.k_splits(2, 2048, 32768, 512) == 1
    for l, g, k, cols in ((2, 2048, 8192, 128), (2, 391, 8192, 128), (2, 3125, 8192, 128),
                          (2, 1, 8192, 128), (2, 33, 1024, 16), (3, 7, 1024, 16),
                          (1, 100, 2048, 64), (2, 64, 32768, 512)):
        s = pack_cuda.k_splits(l, g, k, cols)
        slices = pack_cuda.k_slices(k, s)
        assert 1 <= s <= k // pack_cuda.K_TILE and len(slices) == s
        assert slices[0][0] == 0 and slices[-1][1] == k
        assert all(stop > start and start % pack_cuda.K_TILE == 0 == stop % pack_cuda.K_TILE
                   for start, stop in slices)
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


def test_scoring_wrapper_refuses_other_devices():
    """Only CPU operands take the plain version; others launch the kernel or raise."""
    _, tctx, _, _ = _setup()
    a = torch.zeros((2, 8, 1024), dtype=torch.int8, device="meta")
    v = torch.zeros((2, 1024, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        pack_cuda.packed_score_residues(tctx, a, v, 2, 4)


def test_encode_packed_and_balanced_digits():
    from fhe_icp_tpu.ops import fastdot as jfd
    from fhe_icp_tpu_torch.ops import fastdot as tfd
    rng = np.random.default_rng(0)
    v = rng.integers(-1000, 1001, size=(2, 4, D)).astype(np.int32)
    _eq(pack.encode_packed(torch.from_numpy(v), 512), jpack.encode_packed(jnp.asarray(v), 512))
    x = rng.integers(-(2 ** 30) + 1, 2 ** 30, size=(1000,)).astype(np.int32)
    x[:4] = [0, 2 ** 30 - 1, -(2 ** 30) + 1, -128]
    _eq(tfd.balanced_digits(torch.from_numpy(x)), jfd.balanced_digits(jnp.asarray(x)))
