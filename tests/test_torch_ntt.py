"""Port NTT (plan tables and the kernel's plain version) bit-exact vs JAX.

The same residues, made with numpy from a seed, go through the JAX
`ntt_fwd`/`ntt_inv`, the JAX Pallas kernels (interpreted on the CPU) and
the port.  Tolerance: none, every output is an integer residue.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops import ntt as jntt
from fhe_icp_tpu.ops.ntt_pallas import ntt_fwd_pallas, ntt_inv_pallas
from fhe_icp_tpu_torch.ops import ntt as tntt
from fhe_icp_tpu_torch.ops import ntt_cuda
from fhe_icp_tpu_torch.ops import primes as pr

PRIMES = pr.ntt_primes(2, bits=31)


@functools.lru_cache(maxsize=None)
def _plans(n):
    return jntt.build_plan(n, PRIMES), tntt.build_plan(n, PRIMES, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_outputs(n):
    """JAX fwd/inv of one (2, 5, 2, N) batch; the shape cases slice it."""
    jp, _ = _plans(n)
    x = _polys(n, (2, 5), seed=n)
    flat = jnp.asarray(x.reshape(10, 2, n))
    fwd = jax.jit(lambda v: jntt.ntt_fwd(jp, v))(flat)
    inv = jax.jit(lambda v: jntt.ntt_inv(jp, v))(flat)
    return x, np.asarray(fwd).reshape(x.shape), np.asarray(inv).reshape(x.shape)


def _polys(n, shape, seed, limbs=2):
    rng = np.random.default_rng(seed)
    ps = np.asarray(PRIMES[:limbs], dtype=np.uint64)[:, None]
    x = rng.integers(0, 2 ** 31, size=shape + (limbs, n)).astype(np.uint64)
    return (x % ps).astype(np.uint32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [512, 4096])
def test_plan_tables_match(n):
    jp, tp = _plans(n)
    assert tp.primes == jp.primes and tp.log_n == jp.log_n
    for name in ("p", "psi", "psi_sh", "psi_inv_n", "psi_inv_n_sh"):
        _eq(getattr(tp, name), getattr(jp, name))
    for name in ("fw_tw", "fw_sh", "inv_tw", "inv_sh"):
        for t, j in zip(getattr(tp, name), getattr(jp, name), strict=True):
            _eq(t, j)


def test_kernel_table_layout():
    """Stage s of the packed kernel table sits at offset N - (N >> s)."""
    _, tp = _plans(512)
    n = tp.n
    for s in range(tp.log_n):
        off, m = n - (n >> s), n >> (s + 1)
        _eq(tp.fwd_table[:, 2 * n + off: 2 * n + off + m], tp.fw_tw[s][:, 0].numpy())
        _eq(tp.inv_table[:, 3 * n + off: 3 * n + off + m], tp.inv_sh[s][:, 0].numpy())
    _eq(tp.fwd_table[:, :n], tp.psi.numpy())
    _eq(tp.inv_table[:, n: 2 * n], tp.psi_inv_n_sh.numpy())


@pytest.mark.parametrize("n", [512, 1024, 2048, 4096])
@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_matches_jax_ntt(n, shape):
    _, tp = _plans(n)
    x, want_fwd, want_inv = (
        a.reshape((10, 2, n))[: int(np.prod(shape))].reshape(shape + (2, n))
        for a in _jax_outputs(n))
    fwd = tntt.ntt_fwd(tp, torch.from_numpy(x))
    _eq(fwd, want_fwd)
    _eq(tntt.ntt_inv(tp, torch.from_numpy(x)), want_inv)
    _eq(tntt.ntt_inv(tp, fwd), x)


@pytest.mark.parametrize("n", [512, 1024, 2048, 4096])
def test_matches_pallas_kernel(n):
    """Against the TPU kernel itself, in the Pallas interpreter."""
    jp, tp = _plans(n)
    x = _polys(n, (2,), seed=7 * n)
    _eq(ntt_cuda.ntt_fwd_ref(tp, torch.from_numpy(x)), ntt_fwd_pallas(jp, jnp.asarray(x)))
    _eq(ntt_cuda.ntt_inv_ref(tp, torch.from_numpy(x)), ntt_inv_pallas(jp, jnp.asarray(x)))


@pytest.mark.parametrize("n", [512, 2048])
def test_single_limb_slice_and_plan(n):
    """A 1-limb input uses the first limb's tables; a 1-prime plan its own."""
    jp, tp = _plans(n)
    x = _polys(n, (3,), seed=11)[:, :1]
    _eq(tntt.ntt_fwd(tp, torch.from_numpy(x)),
        jax.jit(lambda v: jntt.ntt_fwd(jp, v))(jnp.asarray(x)))
    one_j = jntt.build_plan(n, PRIMES[1:])
    one_t = tntt.build_plan(n, PRIMES[1:], device="cpu")
    y = _polys(n, (3,), seed=12)[:, 1:]
    _eq(tntt.ntt_inv(one_t, torch.from_numpy(y)),
        jax.jit(lambda v: jntt.ntt_inv(one_j, v))(jnp.asarray(y)))


def test_ring_16384_row():
    n = 16384
    jp, tp = jntt.build_plan(n, PRIMES[:1]), tntt.build_plan(n, PRIMES[:1], device="cpu")
    x = _polys(n, (), seed=3, limbs=1)
    _eq(tntt.ntt_fwd(tp, torch.from_numpy(x)),
        jax.jit(lambda v: jntt.ntt_fwd(jp, v))(jnp.asarray(x)))


def test_negacyclic_convolution():
    """NTT-domain pointwise product = product mod X^N + 1 (schoolbook oracle)."""
    n, p = 512, PRIMES[0]
    _, tp = _plans(n)
    rng = np.random.default_rng(9)
    a = rng.integers(-50, 51, size=n)
    b = rng.integers(-50, 51, size=n)
    full = np.convolve(a, b)
    want = full[:n].copy()
    want[: n - 1] -= full[n:]
    res = lambda v: torch.from_numpy((np.asarray(v) % p).astype(np.uint32)[None])
    fa, fb = tntt.ntt_fwd(tp, res(a)), tntt.ntt_fwd(tp, res(b))
    prod = (fa.to(torch.int64) * fb.to(torch.int64) % p).to(torch.uint32)
    _eq(tntt.ntt_inv(tp, prod)[0], (want % p).astype(np.uint32))
