"""Port modmath (int64 plain versions) bit-exact against the JAX modmath."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import modmath as jm
from fhe_icp_tpu_torch.ops import modmath as tm
from fhe_icp_tpu_torch.ops import primes as pr

P = pr.ntt_primes(2, bits=31)[1]
MC = pr.mont_constants(P)
PINV, R2, MU = MC["p_neg_inv"], MC["r2_mod_p"], pr.barrett_mu(P)
RNG = np.random.default_rng(5)
EDGE_P = np.array([0, 1, 2, P // 2, P - 2, P - 1], dtype=np.uint32)
EDGE_32 = np.array([0, 1, P - 1, P, 2 * P - 1, 2 ** 31, 2 ** 32 - 1], dtype=np.uint32)


def _vals(edge, hi, size=4000):
    rand = RNG.integers(0, hi, size=size, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([edge, rand])


def _pair(edge_a, hi_a, edge_b, hi_b):
    a, b = _vals(edge_a, hi_a), _vals(edge_b, hi_b)
    ga, gb = np.meshgrid(a[:40], b[:40])
    k = min(len(a), len(b))
    return np.concatenate([ga.ravel(), a[:k]]), np.concatenate([gb.ravel(), b[:k]])


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.asarray(want).astype(np.int64))


U = jnp.uint32
T = torch.from_numpy
W = 12345678 % P
W_SH = pr.shoup(W, P)

CASES = {
    "add_mod": (lambda a, b: jm.add_mod(U(a), U(b), U(P)),
                lambda a, b: tm.add_mod(T(a), T(b), P), (EDGE_P, P), (EDGE_P, P)),
    "sub_mod": (lambda a, b: jm.sub_mod(U(a), U(b), U(P)),
                lambda a, b: tm.sub_mod(T(a), T(b), P), (EDGE_P, P), (EDGE_P, P)),
    "neg_mod": (lambda a, b: jm.neg_mod(U(a), U(P)),
                lambda a, b: tm.neg_mod(T(a), P), (EDGE_P, P), (EDGE_P, P)),
    # One operand below p, the other any uint32: the Montgomery input range.
    "mont_mul": (lambda a, b: jm.mont_mul(U(a), U(b), U(P), U(PINV)),
                 lambda a, b: tm.mont_mul(T(a), T(b), P, PINV),
                 (EDGE_P, P), (EDGE_32, 2 ** 32)),
    "shoup_mul": (lambda a, b: jm.shoup_mul(U(a), U(W), U(W_SH), U(P)),
                  lambda a, b: tm.shoup_mul(T(a), W, W_SH, P),
                  (EDGE_32, 2 ** 32), (EDGE_P, P)),
    "barrett_reduce": (lambda a, b: jm.barrett_reduce(U(a), U(P), U(MU)),
                       lambda a, b: tm.barrett_reduce(T(a), P, MU),
                       (EDGE_32, 2 ** 32), (EDGE_P, P)),
    "to_mont": (lambda a, b: jm.to_mont(U(a), U(P), U(PINV), U(R2)),
                lambda a, b: tm.to_mont(T(a), P, PINV, R2), (EDGE_P, P), (EDGE_P, P)),
    "from_mont": (lambda a, b: jm.from_mont(U(a), U(P), U(PINV)),
                  lambda a, b: tm.from_mont(T(a), P, PINV),
                  (EDGE_32, 2 ** 32), (EDGE_P, P)),
    "mul_mod": (lambda a, b: jm.mul_mod(U(a), U(b), U(P), U(PINV), U(R2)),
                lambda a, b: tm.mul_mod(T(a), T(b), P, PINV, R2),
                (EDGE_P, P), (EDGE_P, P)),
    "umulhi32": (lambda a, b: jm.umulhi32(U(a), U(b)),
                 lambda a, b: tm.umulhi32(T(a), T(b)),
                 (EDGE_32, 2 ** 32), (EDGE_32, 2 ** 32)),
    "umul32_wide_lo": (lambda a, b: jm.umul32_wide(U(a), U(b))[1],
                       lambda a, b: tm.umul32_wide(T(a), T(b))[1],
                       (EDGE_32, 2 ** 32), (EDGE_32, 2 ** 32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    jfn, tfn, (ea, ha), (eb, hb) = CASES[name]
    a, b = _pair(ea, ha, eb, hb)
    _same(tfn(a, b), jfn(a, b))


def test_add64_matches_jax():
    words = [_vals(EDGE_32, 2 ** 32) for _ in range(4)]
    jhi, jlo = jm.add64(*(U(w) for w in words))
    thi, tlo = tm.add64(*(T(w) for w in words))
    _same(thi, jhi)
    _same(tlo, jlo)


def test_column_broadcast():
    """Per-limb (L, 1) uint32 prime columns broadcast like the JAX ones."""
    ps = np.asarray(pr.ntt_primes(3, bits=31), dtype=np.uint32)[:, None]
    a = (RNG.integers(0, 2 ** 31, size=(3, 64)) % ps).astype(np.uint32)
    b = (RNG.integers(0, 2 ** 31, size=(3, 64)) % ps).astype(np.uint32)
    pinv = np.asarray([pr.mont_constants(int(p))["p_neg_inv"] for p in ps[:, 0]],
                      dtype=np.uint32)[:, None]
    _same(tm.mont_mul(T(a), T(b), T(ps), T(pinv)),
          jm.mont_mul(U(a), U(b), U(ps), U(pinv)))
    _same(tm.sub_mod(T(a), T(b), T(ps)), jm.sub_mod(U(a), U(b), U(ps)))
