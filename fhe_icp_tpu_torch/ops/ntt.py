"""Negacyclic NTT/INTT over RNS limbs.

Negacyclic convolution (mod X^N + 1) is a twist by powers of psi (a 2N-th
root of unity) followed by a cyclic transform:

* forward = decimation-in-frequency (Gentleman-Sande): natural order in,
  bit-reversed order out;
* inverse = decimation-in-time (Cooley-Tukey): bit-reversed order in,
  then the psi^{-i} N^{-1} untwist, natural order out.

Pointwise products happen in bit-reversed order, so no bit-reversal is
ever materialized.  Polynomials are `(..., L, N)` uint32, one row per RNS
limb; every table carries a leading L axis.  The stage order and the
tables are those of the JAX package's `ops/ntt.py`, so both give the same
integers.

For a CUDA tensor `ntt_fwd`/`ntt_inv` run the fused kernel of
`csrc/ntt.cu` (`ops/ntt_cuda.py`); for a CPU tensor they run its plain
version.  `cyclic_fwd`/`cyclic_inv` are the cyclic stages alone, on the
same kernel, for the four-step ring-sharded NTT (`parallel/ntt_dist.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Tuple

import numpy as np
import torch

from ..devices import target
from . import primes as pr
from .ntt_cuda import cyclic_fwd, cyclic_inv, ntt_fwd, ntt_inv  # noqa: F401  (public)


@dataclass(frozen=True)
class NttPlan:
    """Precomputed tables for a fixed (N, primes) pair, on one device.

    All tensors are uint32.  Per-stage twiddles of stage `s` have shape
    (L, 1, N >> (s+1)) so they broadcast against data viewed as
    (..., L, B, 2, m).  `fwd_table`/`inv_table` pack, per limb, the twist,
    its Shoup companion and every stage's twiddles into one (L, 4N) row
    for the kernel: [psi | psi_sh | (tw, tw_sh) pairs], stage s's twiddle j
    as the pair at index N - (N >> s) + j of the last 2N words, so that one
    8-byte load fetches a twiddle with its companion.
    """

    n: int
    primes: Tuple[int, ...]
    p: torch.Tensor                      # (L, 1)
    fw_tw: Tuple[torch.Tensor, ...]      # per stage (L, 1, m)
    fw_sh: Tuple[torch.Tensor, ...]
    inv_tw: Tuple[torch.Tensor, ...]
    inv_sh: Tuple[torch.Tensor, ...]
    psi: torch.Tensor                    # (L, N) twist psi^i
    psi_sh: torch.Tensor
    psi_inv_n: torch.Tensor              # (L, N) psi^{-i} * N^{-1}
    psi_inv_n_sh: torch.Tensor
    fwd_table: torch.Tensor              # (L, 4N) kernel layout
    inv_table: torch.Tensor              # (L, 4N) kernel layout

    @property
    def log_n(self) -> int:
        return self.n.bit_length() - 1

    @property
    def device(self) -> torch.device:
        return self.p.device

    def to(self, device: torch.device | str) -> "NttPlan":
        """The same tables on `device` (this plan itself if already there)."""
        device = torch.device(device)
        if device == self.device:
            return self

        def move(v):
            if isinstance(v, torch.Tensor):
                return v.to(device)
            if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
                return tuple(t.to(device) for t in v)
            return v
        return NttPlan(**{f.name: move(getattr(self, f.name)) for f in fields(self)})


def _u32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint32)


def _kernel_table(twist, twist_sh, stages, stages_sh, n: int) -> np.ndarray:
    """(L, 4N): twist | twist companion | (stage twiddle, companion) pairs."""
    pairs = np.zeros((len(twist), n, 2), dtype=np.uint32)
    for k, tabs in enumerate((stages, stages_sh)):
        pairs[:, : n - 1, k] = np.concatenate([np.stack(t) for t in tabs], axis=1)
    return np.concatenate([twist, twist_sh, pairs.reshape(len(twist), 2 * n)], axis=1)


def build_plan(n: int, prime_list: Tuple[int, ...],
               device: torch.device | str = "cuda") -> NttPlan:
    """Build twiddle tables host-side with exact big-int arithmetic.

    The tables go to the card unless `device` names another.
    """
    device = target(device, "build_plan")
    assert n & (n - 1) == 0, "N must be a power of two"
    log_n = n.bit_length() - 1
    fw_tw = [[] for _ in range(log_n)]
    fw_sh = [[] for _ in range(log_n)]
    inv_tw = [[] for _ in range(log_n)]
    inv_sh = [[] for _ in range(log_n)]
    psi_rows, psi_sh_rows, psi_inv_rows, psi_inv_sh_rows = [], [], [], []

    for p in prime_list:
        psi = pr.root_of_unity(p, 2 * n)       # psi^n = -1 mod p
        w = psi * psi % p                      # n-th root for the cyclic part
        w_inv = pow(w, p - 2, p)
        n_inv = pow(n, p - 2, p)
        psi_inv = pow(psi, p - 2, p)

        for s in range(log_n):
            m = n >> (s + 1)
            step = 1 << s
            tws = [pow(w, i * step, p) for i in range(m)]
            itws = [pow(w_inv, i * step, p) for i in range(m)]
            fw_tw[s].append(_u32(tws))
            fw_sh[s].append(_u32([pr.shoup(t, p) for t in tws]))
            inv_tw[s].append(_u32(itws))
            inv_sh[s].append(_u32([pr.shoup(t, p) for t in itws]))

        psi_pow = [pow(psi, i, p) for i in range(n)]
        psi_inv_n = [pow(psi_inv, i, p) * n_inv % p for i in range(n)]
        psi_rows.append(_u32(psi_pow))
        psi_sh_rows.append(_u32([pr.shoup(t, p) for t in psi_pow]))
        psi_inv_rows.append(_u32(psi_inv_n))
        psi_inv_sh_rows.append(_u32([pr.shoup(t, p) for t in psi_inv_n]))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def stack_stage(rows_per_stage):
        return tuple(dev(np.stack(rows)[:, None, :]) for rows in rows_per_stage)

    psi_np, psi_sh_np = np.stack(psi_rows), np.stack(psi_sh_rows)
    ipsi_np, ipsi_sh_np = np.stack(psi_inv_rows), np.stack(psi_inv_sh_rows)
    return NttPlan(
        n=n,
        primes=tuple(prime_list),
        p=dev(_u32(prime_list)[:, None]),
        fw_tw=stack_stage(fw_tw),
        fw_sh=stack_stage(fw_sh),
        inv_tw=stack_stage(inv_tw),
        inv_sh=stack_stage(inv_sh),
        psi=dev(psi_np),
        psi_sh=dev(psi_sh_np),
        psi_inv_n=dev(ipsi_np),
        psi_inv_n_sh=dev(ipsi_sh_np),
        fwd_table=dev(_kernel_table(psi_np, psi_sh_np, fw_tw, fw_sh, n)),
        inv_table=dev(_kernel_table(ipsi_np, ipsi_sh_np, inv_tw, inv_sh, n)),
    )

