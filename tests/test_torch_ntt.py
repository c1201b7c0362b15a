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
    """Stage s's twiddle j and its companion are pair N - (N >> s) + j."""
    _, tp = _plans(512)
    n = tp.n
    for s in range(tp.log_n):
        off, m = n - (n >> s), n >> (s + 1)
        pairs = slice(2 * n + 2 * off, 2 * n + 2 * (off + m))
        _eq(tp.fwd_table[:, pairs][:, 0::2], tp.fw_tw[s][:, 0].numpy())
        _eq(tp.fwd_table[:, pairs][:, 1::2], tp.fw_sh[s][:, 0].numpy())
        _eq(tp.inv_table[:, pairs][:, 0::2], tp.inv_tw[s][:, 0].numpy())
        _eq(tp.inv_table[:, pairs][:, 1::2], tp.inv_sh[s][:, 0].numpy())
    _eq(tp.fwd_table[:, :n], tp.psi.numpy())
    _eq(tp.fwd_table[:, n: 2 * n], tp.psi_sh.numpy())
    _eq(tp.inv_table[:, :n], tp.psi_inv_n.numpy())
    _eq(tp.inv_table[:, n: 2 * n], tp.psi_inv_n_sh.numpy())
    _eq(tp.fwd_table[:, 4 * n - 2:], np.zeros((2, 2), dtype=np.uint32))


# Every (rows, L, N) the paths launch K2 with: keygen / encrypt batches /
# the per-query row / decrypt at pairwise-4096, test-512's shapes, the
# ring-16384 polynomial, a mod_switch limb, and the four-step NTT's column
# and row transforms (cyclic, N = 16 .. 256).
PATH_SHAPES = [(16384, 2, 4096), (2, 2, 4096), (2, 1, 4096), (16, 2, 4096), (64, 2, 512),
               (4, 1, 512), (12, 12, 16384), (1, 1, 16384), (16384, 2, 16384),
               (192, 12, 128), (96, 12, 128), (16 * 12, 12, 16), (4 * 12, 12, 256),
               (10, 2, 32), (3, 1, 64), (16 * 6, 6, 8192)]


def _assert_legal(s, rows, l, n):
    """What csrc/ntt.cu's entry points accept, within the H100's limits."""
    assert s.rows_per_block <= max(1, rows // l) or s.regime == "warp"
    assert s.smem <= ntt_cuda.SMEM_PER_BLOCK and s.cluster in (1, 2, 4, 8, 16)
    assert 32 <= s.threads <= 1024 and s.threads % 32 == 0
    if s.regime == "warp":
        assert n <= 256 and s.cluster == 1 and s.smem == 0
        lanes = n // max(2, n // 32)
        assert s.rows_per_block == s.threads // lanes and s.blocks * s.rows_per_block >= rows
        return
    m = n // s.cluster
    assert n >= 512 and s.threads == min(m // 8, ntt_cuda.MAX_BLOCK_THREADS)
    assert s.smem == s.rows_per_block * m * 4 and s.rows_per_block in (1, 2, 4, 8)
    if s.cluster > 1:
        assert s.rows_per_block == 1 and s.blocks == rows * s.cluster
        assert m >= ntt_cuda.MIN_CLUSTER_WORDS
    else:
        assert s.blocks * s.rows_per_block >= rows


@pytest.mark.parametrize("rows,l,n", PATH_SHAPES)
def test_launch_shape_is_legal(rows, l, n):
    s = ntt_cuda.launch_shape(rows, l, n)
    _assert_legal(s, rows, l, n)
    costs = ntt_cuda.launch_candidates(rows, l, n)
    assert s in [c for _, c in costs] and min(cost for cost, _ in costs) == \
        next(cost for cost, c in costs if c == s)


@pytest.mark.parametrize("rows,l,n", PATH_SHAPES)
def test_launch_candidates_are_legal(rows, l, n):
    for _, s in ntt_cuda.launch_candidates(rows, l, n):
        _assert_legal(s, rows, l, n)


@pytest.mark.parametrize("rows,l,n", [(2, 2, 4096), (1, 1, 4096), (12, 12, 16384),
                                      (2, 1, 16384), (4, 2, 8192)])
def test_launch_shape_short_batches_use_clusters(rows, l, n):
    assert ntt_cuda.launch_shape(rows, l, n).cluster > 1


def test_launch_shape_many_rows_share_twiddles():
    s = ntt_cuda.launch_shape(16384, 2, 4096)
    assert s.cluster == 1 and s.rows_per_block > 1
    # a ragged batch: rows of one limb that R does not divide
    r = ntt_cuda.launch_shape(2 * 8191, 2, 4096)
    assert r.rows_per_block > 1 and r.blocks == 2 * -(-8191 // r.rows_per_block)


@pytest.mark.parametrize("rows,l,n", [(4, 2, 8), (4, 2, 65536), (4, 2, 3000), (5, 2, 512),
                                      (0, 1, 512)])
def test_launch_shape_refuses(rows, l, n):
    with pytest.raises(ValueError):
        ntt_cuda.launch_shape(rows, l, n)


def test_local_passes():
    """Radix-8 passes, then radix-4 ones so that no pass has stride 2."""
    assert [ntt_cuda.local_passes(k) for k in (5, 6, 8, 9, 10, 12, 14)] == [2, 2, 3, 3, 4, 4, 5]


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
