"""Port ring-sharded NTT and cyclic transforms bit-exact vs JAX.

The four-step transform on 8 logical CPU shards (the exchange is K3's
plain version, the column and row transforms K2's cyclic plain version)
against the JAX package's `make_dist_ntt` on the conftest's 8 virtual
CPU devices, with both of its exchanges: the XLA collective and the
Pallas K3 kernel in interpret mode.  Also the round trip, the
negacyclic-convolution oracle of `tests/test_ntt_dist.py`, agreement with
the single-device NTT, and the cyclic transforms against JAX's
`_cyclic_fwd`/`_cyclic_inv`.  Tolerance: none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import ntt as jntt
from fhe_icp_tpu.parallel import ntt_dist as jdist
from fhe_icp_tpu_torch.ops import modmath as tm
from fhe_icp_tpu_torch.ops import ntt as tntt
from fhe_icp_tpu_torch.ops import ntt_cuda
from fhe_icp_tpu_torch.ops import primes as pr
from fhe_icp_tpu_torch.parallel import ntt_dist as tdist
from fhe_icp_tpu_torch.parallel.mesh import SP_AXIS, gather, make_mesh, shard

PRIMES = pr.ntt_primes(2, bits=31)
SIZES = [(256, 16), (1024, 32), (1024, 64)]


@functools.lru_cache(maxsize=None)
def _plans(n, n1, limbs=2):
    return (jdist.build_dist_plan(n, PRIMES[:limbs], n1=n1),
            tdist.build_dist_plan(n, PRIMES[:limbs], n1=n1, device="cpu"))


@functools.lru_cache(maxsize=None)
def _port(n, n1, limbs=2, d=8):
    mesh = make_mesh(d, (d,), device="cpu", axes=(SP_AXIS,))
    fwd, inv = tdist.make_dist_ntt(_plans(n, n1, limbs)[1], mesh)

    def run(f, x):
        parts = shard(mesh, torch.from_numpy(x), tdist.ROW_SPEC)
        return gather(mesh, f(parts), tdist.ROW_SPEC).numpy()
    return functools.partial(run, fwd), functools.partial(run, inv)


@functools.lru_cache(maxsize=None)
def _jax(n, n1, exchange, limbs=2):
    mesh = jax.make_mesh((8,), (jdist.SP_AXIS,), axis_types=(jax.sharding.AxisType.Auto,))
    fwd, inv = jdist.make_dist_ntt(_plans(n, n1, limbs)[0], mesh, exchange=exchange)
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, jdist.SP_AXIS))

    def run(f, x):
        return np.asarray(f(jax.device_put(jnp.asarray(x), spec)))
    return functools.partial(run, fwd), functools.partial(run, inv)


def _residues(n1, n2, seed, limbs=2):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, size=(n1, n2), dtype=np.uint32)
                     for p in PRIMES[:limbs]])


@pytest.mark.parametrize("n,n1", SIZES)
def test_plan_tables_match(n, n1):
    jp, tp = _plans(n, n1)
    assert (tp.n, tp.n1, tp.n2, tp.primes) == (jp.n, jp.n1, jp.n2, jp.primes)
    for name in ("psi", "psi_sh", "psi_inv_n", "psi_inv_n_sh", "tw", "tw_sh", "tw_inv",
                 "tw_inv_sh", "p_col"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    for sub in ("plan1", "plan2"):
        for name in ("psi", "fw_sh", "inv_tw"):
            for t, j in zip(jax.tree_util.tree_leaves(getattr(getattr(tp, sub), name)),
                            jax.tree_util.tree_leaves(getattr(getattr(jp, sub), name))):
                np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.mark.parametrize("exchange", ["xla", "pallas"])
def test_transforms_match_jax(exchange):
    n, n1 = 256, 16
    x = _residues(n1, n // n1, seed=1)
    jf, ji = _jax(n, n1, exchange)
    tf, ti = _port(n, n1)
    fx = tf(x)
    np.testing.assert_array_equal(fx, jf(x))
    np.testing.assert_array_equal(ti(fx), ji(jf(x)))
    y = _residues(n1, n // n1, seed=2)
    np.testing.assert_array_equal(ti(y), ji(y))


@pytest.mark.parametrize("n,n1", SIZES)
def test_round_trip(n, n1):
    x = _residues(n1, n // n1, seed=n1)
    tf, ti = _port(n, n1)
    np.testing.assert_array_equal(ti(tf(x)), x)


@pytest.mark.parametrize("d", [2, 4])
def test_round_trip_on_fewer_shards(d):
    x = _residues(16, 16, seed=d)
    tf, ti = _port(256, 16, d=d)
    np.testing.assert_array_equal(ti(tf(x)), x)


def _mont_product(fa, fb, primes):
    """Pointwise a*b in the NTT domain: mont_mul(a, to_mont(b))."""
    mc = [pr.mont_constants(p) for p in primes]
    shape = (-1,) + (1,) * (fa.dim() - 1)
    p, pinv, r2 = (torch.tensor(np.asarray(v, np.uint32)).reshape(shape)
                   for v in (primes, [c["p_neg_inv"] for c in mc], [c["r2_mod_p"] for c in mc]))
    return tm.mont_mul(fa, tm.to_mont(fb, p, pinv, r2), p, pinv)


def _naive_negacyclic(a, b, p):
    n = len(a)
    full = np.zeros(2 * n, dtype=object)
    for i in range(n):
        full[i:i + n] += int(a[i]) * b.astype(object)
    return np.asarray([(full[k] - full[k + n]) % p for k in range(n)], dtype=np.uint32)


def test_negacyclic_convolution_distributed():
    n, n1 = 256, 16
    a, b = _residues(n1, 16, seed=3), _residues(n1, 16, seed=4)
    tf, ti = _port(n, n1)
    fc = _mont_product(torch.from_numpy(tf(a)), torch.from_numpy(tf(b)), PRIMES[:2])
    got = ti(fc.numpy()).reshape(2, n)
    for li, p in enumerate(PRIMES[:2]):
        np.testing.assert_array_equal(got[li], _naive_negacyclic(a[li].reshape(-1),
                                                                 b[li].reshape(-1), p))


def test_matches_single_device_convolution():
    """Distributed and single-device orderings differ; both multiply in the same ring."""
    n, n1 = 1024, 32
    a, b = _residues(n1, n // n1, seed=5), _residues(n1, n // n1, seed=6)
    tf, ti = _port(n, n1)
    dist = ti(_mont_product(torch.from_numpy(tf(a)), torch.from_numpy(tf(b)),
                            PRIMES[:2]).numpy()).reshape(2, n)
    plan = tntt.build_plan(n, PRIMES[:2], device="cpu")
    fa = tntt.ntt_fwd(plan, torch.from_numpy(a.reshape(2, n)))
    fb = tntt.ntt_fwd(plan, torch.from_numpy(b.reshape(2, n)))
    single = tntt.ntt_inv(plan, _mont_product(fa, fb, PRIMES[:2]))
    np.testing.assert_array_equal(dist, single.numpy())


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("limbs", [1, 2])
def test_cyclic_transforms_match_jax(n, limbs):
    jp = jntt.build_plan(n, PRIMES[:limbs])
    tp = tntt.build_plan(n, PRIMES[:limbs], device="cpu")
    x = np.stack([_residues(1, n, seed=n + i, limbs=limbs)[:, 0] for i in range(3)])
    want_f = jax.jit(lambda v: jntt._cyclic_fwd(jp, v, limbs))(jnp.asarray(x))
    want_i = jax.jit(lambda v: jntt._cyclic_inv(jp, v, limbs))(jnp.asarray(x))
    np.testing.assert_array_equal(tntt.cyclic_fwd(tp, torch.from_numpy(x)).numpy(),
                                  np.asarray(want_f))
    np.testing.assert_array_equal(ntt_cuda.cyclic_inv_ref(tp, torch.from_numpy(x)).numpy(),
                                  np.asarray(want_i))
