"""Fused negacyclic NTT/INTT: CUDA kernel wrappers and their plain versions.

Replaces the JAX package's Pallas kernels `ops/ntt_pallas.py::_fwd_kernel`
and `::_inv_kernel` (called through `ntt_fwd_pallas`/`ntt_inv_pallas`).
The kernels are in `csrc/ntt.cu`, in three regimes that `launch_shape`
chooses from the row count, the limb count and N:

* "block", C = 1: a block takes R rows of one limb and runs radix-8 passes
  on them, each twiddle loaded once for all R rows;
* "block", C > 1: a short batch spreads each row over a thread-block
  cluster of C blocks, the first (last) log2 C stages across the cluster's
  shared memory;
* "warp" (N <= 256): one warp per row, stages across lanes by shuffles.

`ntt_fwd`/`ntt_inv` launch the kernel for a CUDA tensor and run the plain
version `ntt_fwd_ref`/`ntt_inv_ref` for a CPU tensor.  `cyclic_fwd`/
`cyclic_inv` do the same for the cyclic stages alone (no twist, no
untwist, unscaled): the JAX package's `ops/ntt.py::_cyclic_fwd` and
`::_cyclic_inv`, which the four-step ring-sharded NTT runs on its columns
and rows.  The plain versions are radix-2 loops in int64 with the stage
order of the JAX package's `ops/ntt.py`, and give the same integers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import kernels
from .modmath import i64, u32


def _check(plan, x: torch.Tensor) -> int:
    if x.dtype != torch.uint32:
        raise TypeError(f"NTT input must be uint32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != plan.n:
        raise ValueError(f"NTT input must be (..., L, {plan.n}), got {tuple(x.shape)}")
    l = x.shape[-2]
    if l > len(plan.primes):
        raise ValueError(f"{l} limbs but the plan has {len(plan.primes)} primes")
    if x.device != plan.device:
        raise ValueError(f"input on {x.device}, plan tables on {plan.device}")
    return l


# ---------------------------------------------------------------------------
# Plain versions (int64)
# ---------------------------------------------------------------------------


def cyclic_fwd_ref(plan, x: torch.Tensor) -> torch.Tensor:
    """Plain cyclic forward transform: DIF stages m = N/2 .. 1, no twist."""
    l = _check(plan, x)
    return u32(_dif(plan, i64(x), l))


def cyclic_inv_ref(plan, x: torch.Tensor) -> torch.Tensor:
    """Plain cyclic inverse transform: DIT stages m = 1 .. N/2, unscaled."""
    l = _check(plan, x)
    return u32(_dit(plan, i64(x), l))


def ntt_fwd_ref(plan, x: torch.Tensor) -> torch.Tensor:
    """Plain forward transform: twist, then the cyclic DIF stages."""
    l = _check(plan, x)
    p = i64(plan.p[:l])
    return u32(_dif(plan, torch.remainder(i64(x) * i64(plan.psi[:l]), p), l))


def ntt_inv_ref(plan, x: torch.Tensor) -> torch.Tensor:
    """Plain inverse transform: the cyclic DIT stages, then untwist."""
    l = _check(plan, x)
    p = i64(plan.p[:l])
    return u32(torch.remainder(_dit(plan, i64(x), l) * i64(plan.psi_inv_n[:l]), p))


def _dif(plan, y: torch.Tensor, l: int) -> torch.Tensor:
    """DIF stages on int64 residues (..., l, N), in the JAX stage order."""
    n, shape, lead = plan.n, y.shape, y.shape[:-1]
    p = i64(plan.p[:l])[:, :, None]                       # (l, 1, 1)
    for s in range(plan.log_n):
        m = n >> (s + 1)
        y = y.reshape(lead + (1 << s, 2, m))
        u, v = y[..., 0, :], y[..., 1, :]
        hi = torch.remainder(torch.remainder(u - v, p) * i64(plan.fw_tw[s][:l]), p)
        y = torch.stack([torch.remainder(u + v, p), hi], dim=-2)
    return y.reshape(shape)


def _dit(plan, y: torch.Tensor, l: int) -> torch.Tensor:
    """DIT stages on int64 residues (..., l, N), in the JAX stage order."""
    n, shape, lead = plan.n, y.shape, y.shape[:-1]
    p = i64(plan.p[:l])[:, :, None]
    for s in range(plan.log_n - 1, -1, -1):
        m = n >> (s + 1)
        y = y.reshape(lead + (1 << s, 2, m))
        u = y[..., 0, :]
        t = torch.remainder(y[..., 1, :] * i64(plan.inv_tw[s][:l]), p)
        y = torch.stack([torch.remainder(u + t, p), torch.remainder(u - t, p)],
                        dim=-2)
    return y.reshape(shape)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# H100 limits (CUDA occupancy rules for sm_90).
SMS = 132
SMEM_PER_BLOCK = 232_448           # 227 KB of dynamic shared memory
SMEM_PER_SM = 233_472              # 228 KB, of which 1 KB per resident block
THREADS_PER_SM, BLOCKS_PER_SM = 2048, 32
# The kernels' own limits (csrc/ntt.cu).
MAX_BLOCK_THREADS, WARP_BLOCK_THREADS = 256, 128
ROWS_PER_BLOCK = (1, 2, 4, 8)
CLUSTERS = (2, 4, 8, 16)           # 16 is a non-portable cluster size
MIN_CLUSTER_WORDS = 256            # a cluster's block keeps >= 32 threads
# Cost model, in units of one warp's pass over its 8-coefficient groups of
# one row at the SM's full rate: a pass also loads each group's twiddles
# once for all R rows (TWIDDLE_COST), and every pass waits for its barrier
# and loads (PASS_LATENCY); a cluster's cross step costs CLUSTER_STEPS
# passes.  R > 1 rows a block only where two such blocks fit on an SM, so
# that one block's barrier waits overlap another's work.
TWIDDLE_COST, PASS_LATENCY, CLUSTER_STEPS = 0.5, 32, 2


@dataclass(frozen=True)
class NttLaunch:
    """How one K2 launch is cut: see `launch_shape`."""

    regime: str            # "block" or "warp"
    rows_per_block: int    # R: rows of one limb per block (warp: rows per block)
    cluster: int           # C: blocks per row (1: none)
    threads: int           # per block
    blocks: int
    smem: int              # dynamic shared memory per block, bytes


def local_passes(lg_m: int) -> int:
    """Passes over 2^lg_m local stages: radix-8, then 0-2 radix-4 passes."""
    radix4 = (3 - lg_m % 3) % 3
    return radix4 + (lg_m - 2 * radix4) // 3


def launch_candidates(rows: int, l: int, n: int) -> list:
    """Every launch the kernels take for these rows, each with its modelled cost.

    N <= 256: the warp regime alone.  Above, every legal (R, C), costed as
    waves x steps x (PASS_LATENCY + k x N / C / 256 x (R + TWIDDLE_COST)):
    k blocks share an SM in a wave (as many as shared memory, threads and
    the batch allow), steps are the local passes plus CLUSTER_STEPS for a
    cluster's cross step.  Raises on a shape the kernels do not take.
    """
    if n & (n - 1) or not 16 <= n <= 32768:
        raise ValueError(f"K2 takes N = 16 .. 32768, a power of two; got {n}")
    if rows <= 0 or l <= 0 or rows % l:
        raise ValueError(f"K2 needs a whole number of {l}-limb rows, got {rows}")
    if n <= 256:
        lanes = n // max(2, n // 32)
        per_block = WARP_BLOCK_THREADS // lanes
        return [(0.0, NttLaunch("warp", per_block, 1, WARP_BLOCK_THREADS,
                                -(-rows // per_block), 0))]
    batch, out = rows // l, []
    for c in (1,) + CLUSTERS:
        m = n // c
        if c > 1 and m < MIN_CLUSTER_WORDS:
            break
        threads = min(m // 8, MAX_BLOCK_THREADS)
        for r in ROWS_PER_BLOCK if c == 1 else (1,):
            smem = r * m * 4
            per_sm = min(SMEM_PER_SM // (smem + 1024), THREADS_PER_SM // threads,
                         BLOCKS_PER_SM)
            if r > batch or (r > 1 and per_sm < 2) or smem > SMEM_PER_BLOCK:
                break
            blocks = l * -(-batch // r) if c == 1 else rows * c
            waves = -(-blocks // (SMS * per_sm))
            k = min(per_sm, -(-blocks // SMS))
            steps = local_passes(m.bit_length() - 1) + (CLUSTER_STEPS if c > 1 else 0)
            cost = waves * steps * (PASS_LATENCY + k * m / 256 * (r + TWIDDLE_COST))
            out.append((cost, NttLaunch("block", r, c, threads, blocks, smem)))
    return out


@functools.lru_cache(maxsize=256)
def launch_shape(rows: int, l: int, n: int) -> NttLaunch:
    """The launch of K2 for `rows` rows of N coefficients, limb = row % l.

    The cheapest of `launch_candidates`, then the smaller C, then the
    larger R.  So many rows of one limb share twiddles (R = 4 at 16,384
    rows x N = 4096), and a batch that cannot fill the card is spread over
    clusters (C = 16 for 2 rows of N = 4096, C = 8 for 12 rows of 16384).
    """
    return min(launch_candidates(rows, l, n),
               key=lambda cs: (cs[0], cs[1].cluster, -cs[1].rows_per_block))[1]


# C entry point of each wrapper; the cyclic ones skip the (un)twist.
_ENTRY = {"ntt_fwd": "fhe_ntt_fwd", "ntt_inv": "fhe_ntt_inv",
          "ntt_cyclic_fwd": "fhe_ntt_cyclic_fwd", "ntt_cyclic_inv": "fhe_ntt_cyclic_inv"}


def _launch(plan, x: torch.Tensor, name: str, shape: NttLaunch | None = None) -> torch.Tensor:
    """Launch entry `name` on x, cut as `shape` (default: launch_shape's)."""
    l = _check(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"the NTT kernel needs a CUDA tensor, got {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:          # a view into its storage: the kernels move 16-byte vectors
        x = x.clone()
    y = torch.empty_like(x)
    rows = x.numel() // plan.n
    if rows == 0:
        return y
    shape = shape or launch_shape(rows, l, plan.n)
    table = plan.inv_table if name.endswith("inv") else plan.fwd_table
    fn = getattr(kernels.load(), _ENTRY[name])
    with kernels.launch_on(x.device) as stream:
        err = fn(x.data_ptr(), y.data_ptr(), table.data_ptr(), plan.p.data_ptr(), rows, l,
                 plan.n, plan.log_n, shape.rows_per_block, shape.cluster, shape.threads,
                 stream)
    kernels.check(err, name)
    kernels.launches[name] += 1
    return y


def ntt_fwd(plan, x: torch.Tensor) -> torch.Tensor:
    """(..., L, N) uint32, natural order -> NTT domain, bit-reversed order."""
    if x.device.type == "cpu":
        return ntt_fwd_ref(plan, x)
    return _launch(plan, x, "ntt_fwd")


def ntt_inv(plan, x: torch.Tensor) -> torch.Tensor:
    """(..., L, N) uint32, bit-reversed NTT domain -> natural order."""
    if x.device.type == "cpu":
        return ntt_inv_ref(plan, x)
    return _launch(plan, x, "ntt_inv")


def cyclic_fwd(plan, x: torch.Tensor) -> torch.Tensor:
    """(..., L, N) uint32: size-N cyclic DIF transform, bit-reversed out, no twist."""
    if x.device.type == "cpu":
        return cyclic_fwd_ref(plan, x)
    return _launch(plan, x, "ntt_cyclic_fwd")


def cyclic_inv(plan, x: torch.Tensor) -> torch.Tensor:
    """(..., L, N) uint32: size-N cyclic DIT transform, bit-reversed in, unscaled."""
    if x.device.type == "cpu":
        return cyclic_inv_ref(plan, x)
    return _launch(plan, x, "ntt_cyclic_inv")
