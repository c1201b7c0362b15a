"""The port's four-step int8-product NTT, bit-exact against the JAX package.

At pairwise-4096 (N = 4096, 2 limbs) and N1 = 64, 128: the port's
`ntt_fwd_mxu` must equal JAX's on the same numpy inputs, and the port's
butterfly forward NTT (`ntt_fwd`, bit-reversed out) permuted to natural
order: natural[k] = butterfly[bitrev(k)].  Tolerance: none.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import ntt_mxu as jmxu
from fhe_icp_tpu.ops.context import CryptoContext as JaxContext
from fhe_icp_tpu.ops.params import get_params as jax_params
from fhe_icp_tpu_torch.ops import ntt_mxu
from fhe_icp_tpu_torch.ops.cipher import bitrev
from fhe_icp_tpu_torch.ops.context import CryptoContext
from fhe_icp_tpu_torch.ops.ntt import ntt_fwd
from fhe_icp_tpu_torch.ops.params import get_params

PRESET = "pairwise-4096"


@functools.lru_cache(maxsize=None)
def _contexts():
    return JaxContext(jax_params(PRESET)), CryptoContext(get_params(PRESET), device="cpu")


def _residues(ctx, batch, seed):
    l = ctx.n_limbs
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.asarray(ctx.primes[:l])[:, None],
                        size=(batch, l, ctx.n)).astype(np.uint32)


@pytest.mark.parametrize("n1", [64, 128])
def test_four_step_matches_jax_and_butterfly(n1):
    jctx, tctx = _contexts()
    x = _residues(tctx, 3, n1)
    got = ntt_mxu.ntt_fwd_mxu(tctx, torch.from_numpy(x), n1=n1)
    assert got.shape == x.shape and got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmxu.ntt_fwd_mxu(jctx, jnp.asarray(x),
                                                                           n1=n1)))
    want = ntt_fwd(tctx.plan, torch.from_numpy(x)).numpy()[..., bitrev(tctx.n)]
    np.testing.assert_array_equal(got.numpy(), want)


def test_tables_match_jax():
    jctx, tctx = _contexts()
    l, n1 = tctx.n_limbs, 128
    got = ntt_mxu._tables(tctx, l, n1)
    want = jmxu._tables(jctx.plan, l, n1)
    assert (got["n1"], got["n2"]) == (want["n1"], want["n2"]) == (128, 32)
    for key in ("w1_dig", "w2t_dig", "tw", "tw_sh", "psi", "psi_sh", "fold_c"):
        np.testing.assert_array_equal(got[key].numpy(), want[key].astype(got[key].numpy().dtype))
    assert ntt_mxu._FOLD_GROUPS == jmxu._FOLD_GROUPS
    assert ntt_mxu._tables(tctx, l, n1) is got          # cached on the context


def test_fold_buckets_extreme_partials_match_jax():
    """Partials at the groups' bound (128^2 * Nmat, both signs), Nmat = 128."""
    jctx, tctx = _contexts()
    l, nmat, cols = tctx.n_limbs, 128, 6
    rng = np.random.default_rng(0)
    part = (rng.choice([-1, 1], size=(l, 4 * nmat, 4, cols)) * (128 * 128 * nmat)
            ).astype(np.int32)
    tabs = ntt_mxu._tables(tctx, l, nmat)
    p = tctx.lp(l).reshape(l, 1, 1)
    pinv = tctx.lpinv(l).reshape(l, 1, 1)
    got = ntt_mxu._fold_buckets(torch.from_numpy(part), nmat, p, pinv, tabs["fold_c"])
    jp = jctx.lp(l).reshape(l, 1, 1)
    want = jmxu._fold_buckets(jnp.asarray(part), nmat, jp, jctx.lpinv(l).reshape(l, 1, 1),
                              jctx.mu_p[:l].reshape(l, 1, 1),
                              jnp.asarray(jmxu._tables(jctx.plan, l, nmat)["fold_c"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
