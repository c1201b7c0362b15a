"""Fused negacyclic NTT/INTT: CUDA kernel wrappers and their plain versions.

Replaces the JAX package's Pallas kernels `ops/ntt_pallas.py::_fwd_kernel`
and `::_inv_kernel` (called through `ntt_fwd_pallas`/`ntt_inv_pallas`).
The kernels are in `csrc/ntt.cu`: one thread block per (row, limb)
polynomial, which stays in shared memory for the twist and all log2 N
butterfly stages, so a transform reads and writes device memory once.

`ntt_fwd`/`ntt_inv` launch the kernel for a CUDA tensor and run the plain
version `ntt_fwd_ref`/`ntt_inv_ref` for a CPU tensor.  The plain versions
are radix-2 loops in int64 with the stage order of the JAX package's
`ops/ntt.py`, and give the same integers.
"""

from __future__ import annotations

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


def ntt_fwd_ref(plan, x: torch.Tensor) -> torch.Tensor:
    """Plain forward transform: twist, then DIF stages m = N/2 .. 1."""
    l = _check(plan, x)
    n, lead = plan.n, x.shape[:-1]
    p = i64(plan.p[:l])[:, :, None]                       # (l, 1, 1)
    y = torch.remainder(i64(x) * i64(plan.psi[:l]), p[:, :, 0])
    for s in range(plan.log_n):
        m = n >> (s + 1)
        y = y.reshape(lead + (1 << s, 2, m))
        u, v = y[..., 0, :], y[..., 1, :]
        hi = torch.remainder(torch.remainder(u - v, p) * i64(plan.fw_tw[s][:l]), p)
        y = torch.stack([torch.remainder(u + v, p), hi], dim=-2)
    return u32(y.reshape(x.shape))


def ntt_inv_ref(plan, x: torch.Tensor) -> torch.Tensor:
    """Plain inverse transform: DIT stages m = 1 .. N/2, then untwist."""
    l = _check(plan, x)
    n, lead = plan.n, x.shape[:-1]
    p = i64(plan.p[:l])[:, :, None]
    y = i64(x)
    for s in range(plan.log_n - 1, -1, -1):
        m = n >> (s + 1)
        y = y.reshape(lead + (1 << s, 2, m))
        u = y[..., 0, :]
        t = torch.remainder(y[..., 1, :] * i64(plan.inv_tw[s][:l]), p)
        y = torch.stack([torch.remainder(u + t, p), torch.remainder(u - t, p)],
                        dim=-2)
    y = y.reshape(x.shape)
    return u32(torch.remainder(y * i64(plan.psi_inv_n[:l]), p[:, :, 0]))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _launch(plan, x: torch.Tensor, forward: bool) -> torch.Tensor:
    l = _check(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"the NTT kernel needs a CUDA tensor, got {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // plan.n
    if rows == 0:
        return y
    name = "ntt_fwd" if forward else "ntt_inv"
    lib = kernels.load()
    fn = lib.fhe_ntt_fwd if forward else lib.fhe_ntt_inv
    table = plan.fwd_table if forward else plan.inv_table
    err = fn(x.data_ptr(), y.data_ptr(), table.data_ptr(), plan.p.data_ptr(),
             rows, l, plan.n, plan.log_n, kernels.stream_ptr(x.device))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return y


def ntt_fwd(plan, x: torch.Tensor) -> torch.Tensor:
    """(..., L, N) uint32, natural order -> NTT domain, bit-reversed order."""
    if x.device.type == "cpu":
        return ntt_fwd_ref(plan, x)
    return _launch(plan, x, forward=True)


def ntt_inv(plan, x: torch.Tensor) -> torch.Tensor:
    """(..., L, N) uint32, bit-reversed NTT domain -> natural order."""
    if x.device.type == "cpu":
        return ntt_inv_ref(plan, x)
    return _launch(plan, x, forward=False)
