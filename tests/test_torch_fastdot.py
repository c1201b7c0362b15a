"""Per-document fastdot scoring in the port, bit-exact against the JAX package.

Keys and ciphertexts come from the JAX runtime through `interop` (one
keygen a preset); the port builds both digit operands and scores, and each
must equal its JAX counterpart and the int64 oracle `docs @ query`.  The
fold is also held, on adversarial partials at ring-16384's contraction
length, against exact integer arithmetic.  Tolerance: none.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import fastdot as jfd
from fhe_icp_tpu.ops.runtime import FheRuntime as JaxRuntime
from fhe_icp_tpu_torch import interop
from fhe_icp_tpu_torch.ops import fastdot, pack_cuda
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.params import get_params


@functools.lru_cache(maxsize=None)
def _setup(preset):
    """The JAX runtime with keys from seed 0, and the port's context and keys."""
    jrt = JaxRuntime(preset, rlk_levels=[])
    jrt.generate_keys(seed=0)
    ks = jrt.keys
    tctx = CryptoContext(get_params(preset), device="cpu")
    tks = interop.keys_from_arrays(tctx, {
        "s": np.asarray(ks.sk.s), "s_ntt_mont": np.asarray(ks.sk.s_ntt_mont),
        "s2_ntt_mont": np.asarray(ks.sk.s2_ntt_mont),
        "pk_b": np.asarray(ks.pk.b_ntt), "pk_a": np.asarray(ks.pk.a_ntt)})
    return jrt, tctx, tks


def _case(preset, d, batch, seed, extreme=False):
    """Docs, query and the JAX package's per-document ciphertexts (ascending)."""
    jrt, _, _ = _setup(preset)
    rng = np.random.default_rng(seed)
    if extreme:
        docs = rng.choice([-1000, 1000], size=(batch, d)).astype(np.int32)
        query = rng.choice([-1000, 1000], size=(d,)).astype(np.int32)
    else:
        docs = rng.integers(-1000, 1001, size=(batch, d)).astype(np.int32)
        query = rng.integers(-1000, 1001, size=(d,)).astype(np.int32)
    cts = jrt.encrypt_vector(docs, seed=seed)
    return docs, query, cts


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("extreme", [False, True])
def test_operands_match_jax(extreme):
    jrt, tctx, tks = _setup("test-512")
    d = 128
    docs, query, cts = _case("test-512", d, 16, seed=5 + extreme, extreme=extreme)
    dop = fastdot.make_doc_operand(tctx, torch.from_numpy(np.array(cts.data)), cts.level)
    want = jfd.make_doc_operand(jrt.ctx, cts.data, cts.level)
    assert dop.digits.dtype == torch.int8 and dop.batch == 16 and dop.level == cts.level
    _eq(dop.digits, want.digits)
    qop = fastdot.make_query_operand(tctx, tks.sk, torch.from_numpy(query), d, cts.level)
    jq = jfd.make_query_operand(jrt.ctx, jrt.keys.sk, jnp.asarray(query), d, cts.level)
    assert (qop.level, qop.d) == (jq.level, jq.d)
    _eq(qop.digits, jq.digits)


@pytest.mark.parametrize("extreme", [False, True])
def test_scores_match_jax_and_oracle(extreme):
    """Random and near-maximal (+-1000) quantized values."""
    jrt, tctx, tks = _setup("test-512")
    d = 128
    docs, query, cts = _case("test-512", d, 16, seed=7 + extreme, extreme=extreme)
    dop = fastdot.make_doc_operand(tctx, torch.from_numpy(np.array(cts.data)), cts.level)
    qop = fastdot.make_query_operand(tctx, tks.sk, torch.from_numpy(query), d, cts.level)
    got = fastdot.scores(tctx, dop, qop)
    assert got.shape == (16,) and got.dtype == torch.int32
    _eq(got.numpy().astype(np.int64), docs.astype(np.int64) @ query.astype(np.int64))
    jd = jfd.make_doc_operand(jrt.ctx, cts.data, cts.level)
    jq = jfd.make_query_operand(jrt.ctx, jrt.keys.sk, jnp.asarray(query), d, cts.level)
    _eq(got, jfd.scores(jrt.ctx, jd, jq))


def _exact_fold(part: np.ndarray, primes) -> np.ndarray:
    """sum_{i,j} part[:, i, :, j] * 2^{8(i+j)} mod p, in Python integers."""
    out = np.zeros((part.shape[0], part.shape[2]), dtype=np.int64)
    for li, p in enumerate(primes):
        for m in range(part.shape[2]):
            out[li, m] = sum(int(part[li, i, m, j]) << (8 * (i + j))
                             for i in range(4) for j in range(4)) % p
    return out


def test_fold_digit_products_adversarial_partials():
    """Every digit at -128 or +-128 over K = 32,768 (ring-16384's 2N): each
    pair partial reaches 2^29 in magnitude, so the four pairs of shift 3
    would overflow int32 in one group; the grouping keeps three."""
    jrt, tctx, _ = _setup("test-512")
    k_len = 2 * get_params("ring-16384").n
    bound = 128 * 128 * k_len
    assert bound == 1 << 29 and max(1, ((1 << 31) - 1) // bound) == 3
    rng = np.random.default_rng(3)
    l = tctx.n_limbs
    signs = rng.choice([-1, 1], size=(l, 4, 6, 4))
    signs[:, :, 0, :] = 1                   # all +2^29: shift 3 sums to 2^31
    signs[:, :, 1, :] = -1
    part = (signs * bound).astype(np.int32)
    got = fastdot.fold_digit_products(tctx, torch.from_numpy(part), l, k_len)
    _eq(got.numpy().astype(np.int64), _exact_fold(part, tctx.primes[:l]))
    _eq(got, jfd.fold_digit_products(jrt.ctx, jnp.asarray(part), l, k_len))


def test_int_mm_plain_version_on_the_cpu():
    """The CPU path is the int32 batched product; other devices raise."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-128, 128, size=(2, 5, 24)).astype(np.int8))
    v = torch.from_numpy(rng.integers(-128, 128, size=(2, 24, 3)).astype(np.int8))
    want = a.numpy().astype(np.int64) @ v.numpy().astype(np.int64)
    _eq(pack_cuda.int_mm(a, v).numpy(), want)
    with pytest.raises(ValueError):
        pack_cuda.int_mm(a.to("meta"), v.to("meta"))


def test_ring_16384_scores_reuse_jax_keys():
    """12 limbs, 2N = 32768: the JAX package's keys and ciphertexts, the
    port's operands and scores; exact and equal to JAX's."""
    jrt, tctx, tks = _setup("ring-16384")
    d = 1024
    docs, query, cts = _case("ring-16384", d, 4, seed=3)
    dop = fastdot.make_doc_operand(tctx, torch.from_numpy(np.array(cts.data)), cts.level)
    qop = fastdot.make_query_operand(tctx, tks.sk, torch.from_numpy(query), d, cts.level)
    got = fastdot.scores(tctx, dop, qop)
    _eq(got.numpy().astype(np.int64), docs.astype(np.int64) @ query.astype(np.int64))
    jq = jfd.make_query_operand(jrt.ctx, jrt.keys.sk, jnp.asarray(query), d, cts.level)
    _eq(qop.digits, jq.digits)
    _eq(got, jfd.scores(jrt.ctx, jfd.make_doc_operand(jrt.ctx, cts.data, cts.level), jq))


def test_scores_beyond_half_t_wrap_mod_t():
    """At pairwise-4096 (t = 8519681) integers in [-1000, 1000] at d = 128
    give scores beyond t/2: fastdot returns each score mod t, centred, as
    BGV decryption does; it is no fault of the scoring."""
    from fhe_icp_tpu_torch.ops.runtime import FheRuntime
    rt = FheRuntime("pairwise-4096", rlk_levels=[], device="cpu")
    rt.generate_keys(seed=0)
    rng = np.random.default_rng(0)
    docs = rng.integers(-1000, 1001, size=(64, 128)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(128,)).astype(np.int32)
    dop = fastdot.make_doc_operand(rt.ctx, rt.encrypt_vector(docs, seed=1).data, 2)
    qop = fastdot.make_query_operand(rt.ctx, rt.keys.sk, torch.from_numpy(query), 128, 2)
    got = fastdot.scores(rt.ctx, dop, qop).numpy().astype(np.int64)
    truth = docs.astype(np.int64) @ query.astype(np.int64)
    t = get_params("pairwise-4096").t
    assert (np.abs(truth) > t // 2).any() and (np.abs(truth) <= t // 2).any()
    _eq(got, (truth + t // 2) % t - t // 2)


def test_query_level_must_match():
    _, tctx, tks = _setup("test-512")
    dop = fastdot.DocOperand(torch.zeros((2, 4, 3, 1024), dtype=torch.int8), 2)
    qop = fastdot.QueryOperand(torch.zeros((1, 4, 1024), dtype=torch.int8), 1, 128)
    with pytest.raises(ValueError):
        fastdot.scores(tctx, dop, qop)
