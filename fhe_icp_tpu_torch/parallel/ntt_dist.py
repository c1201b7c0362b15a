"""Ring-dimension-sharded negacyclic NTT: the four-step transform over `sp` shards.

Large rings are split across shards, each holding N/D contiguous
coefficient rows.  The transform is the four-step (Bailey) decomposition
N = N1 x N2, in the stage order of the JAX package's `parallel/ntt_dist.py`:

    view x as M[i1, i2]  (i = i1*N2 + i2, rows i1 sharded over 'sp')
    1. twist by psi^i                               (per shard)
    2. all_to_all: rows-sharded -> columns-sharded  (kernel K3)
    3. size-N1 cyclic NTT over columns              (kernel K2, cyclic entry)
    4. twiddle by w^(i2 * brv_N1(k1))               (per shard)
    5. all_to_all: columns-sharded -> rows-sharded  (kernel K3)
    6. size-N2 cyclic NTT over rows                 (kernel K2, cyclic entry)

Slot (k1r, k2r) of the output holds frequency brv(k1r) + N1*brv(k2r): the
same integers as the JAX package, consistent between forward and inverse
and for pointwise products.  The inverse mirrors the sequence with the
inverse tables.  The twist and twiddle are the plain `modmath.shoup_mul`
(int64), as XLA computes them in the JAX package.

The program is single-controller over a mesh of logical shards
(`mesh.py`): `make_dist_ntt` returns functions that take and return the D
row shards (L, N1/D, N2) as a list.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..devices import target
from ..ops import primes as pr
from ..ops.cipher import bitrev
from ..ops.modmath import shoup_mul
from ..ops.ntt import NttPlan, build_plan, cyclic_fwd, cyclic_inv
from .ici import all_to_all
from .mesh import SP_AXIS, Mesh, shard

# Operands (L, N1, N2) are sharded on their rows (axis 1); the twiddle
# step works on column shards (axis 2).
ROW_SPEC = (None, SP_AXIS, None)
COL_SPEC = (None, None, SP_AXIS)


@dataclass(frozen=True)
class DistNttPlan:
    """Tables for a sharded (N1 x N2) negacyclic NTT, on one device.

    The big tables are (L, N1, N2) uint32 in the natural (i1, i2) layout;
    `make_dist_ntt` cuts the twist tables by rows and the twiddle tables by
    columns, one slice per shard.
    """

    n: int
    n1: int
    n2: int
    primes: Tuple[int, ...]
    plan1: NttPlan                # size-N1 cyclic tables (column transform)
    plan2: NttPlan                # size-N2 cyclic tables (row transform)
    psi: torch.Tensor             # psi^i
    psi_sh: torch.Tensor
    psi_inv_n: torch.Tensor       # psi^{-i} * N^{-1}
    psi_inv_n_sh: torch.Tensor
    tw: torch.Tensor              # w^(i2 * brv(k1)), axes (k1, i2)
    tw_sh: torch.Tensor
    tw_inv: torch.Tensor
    tw_inv_sh: torch.Tensor
    p_col: torch.Tensor           # (L, 1, 1)


def _pow_table(w: int, n: int, p: int) -> np.ndarray:
    """w^k mod p for k in [0, n), n a power of two, uint64 (products < 2^62)."""
    tbl = np.ones(1, dtype=np.uint64)
    while len(tbl) < n:
        tbl = np.concatenate([tbl, tbl * np.uint64(pow(w, len(tbl), p)) % np.uint64(p)])
    return tbl[:n]


def _shoup(t: np.ndarray, p: int) -> np.ndarray:
    """floor(t * 2^32 / p) for residues t < p < 2^31 (exact in uint64)."""
    return ((t.astype(np.uint64) << np.uint64(32)) // np.uint64(p)).astype(np.uint32)


def build_dist_plan(n: int, prime_list: Tuple[int, ...], n1: int | None = None,
                    device: torch.device | str = "cuda") -> DistNttPlan:
    """Host tables with exact arithmetic, equal to the JAX package's, on `device`."""
    device = target(device, "build_dist_plan")
    assert n & (n - 1) == 0, "N must be a power of two"
    n1 = n1 or 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    # Exponents of w in the twiddle: brv(k1r) * i2, reduced mod N (w has order N).
    expo = (bitrev(n1)[:, None] * np.arange(n2)[None, :]) % n

    tabs = {k: [] for k in ("psi", "psi_sh", "psi_inv_n", "psi_inv_n_sh",
                            "tw", "tw_sh", "tw_inv", "tw_inv_sh")}
    for p in prime_list:
        psi = pr.root_of_unity(p, 2 * n)
        w = psi * psi % p
        psi_inv, w_inv = pow(psi, p - 2, p), pow(w, p - 2, p)
        n_inv = pow(n, p - 2, p)
        rows = {
            "psi": _pow_table(psi, n, p),
            "psi_inv_n": _pow_table(psi_inv, n, p) * np.uint64(n_inv) % np.uint64(p),
            "tw": _pow_table(w, n, p)[expo],
            "tw_inv": _pow_table(w_inv, n, p)[expo],
        }
        for name, t in rows.items():
            tabs[name].append(t.astype(np.uint32).reshape(n1, n2))
            tabs[name + "_sh"].append(_shoup(t, p).reshape(n1, n2))

    def dev(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DistNttPlan(
        n=n, n1=n1, n2=n2, primes=tuple(prime_list),
        plan1=build_plan(n1, prime_list, device),
        plan2=build_plan(n2, prime_list, device),
        **{name: dev(np.stack(rows)) for name, rows in tabs.items()},
        p_col=dev(np.asarray(prime_list, dtype=np.uint32)[:, None, None]),
    )


# ---------------------------------------------------------------------------
# Over the shards.  `plans[i]` is shard i's plan: its slice of each big
# table, and the small tables on its device (see make_dist_ntt).
# ---------------------------------------------------------------------------


def _col_ntt(plan: DistNttPlan, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Cyclic transform over axis 1 of (L, N1, n2_shard).

    The kernel wants the limb axis just left of the transform axis, row r
    holding limb r % L: permute to a contiguous (n2_shard, L, N1) and back.
    """
    xt = x.permute(2, 0, 1).contiguous()
    out = cyclic_inv(plan.plan1, xt) if inverse else cyclic_fwd(plan.plan1, xt)
    return out.permute(1, 2, 0)


def _row_ntt(plan: DistNttPlan, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Cyclic transform over axis 2 of (L, n1_shard, N2)."""
    xt = x.permute(1, 0, 2).contiguous()                 # (n1_shard, L, N2)
    out = cyclic_inv(plan.plan2, xt) if inverse else cyclic_fwd(plan.plan2, xt)
    return out.permute(1, 0, 2)


def dist_ntt_fwd_shard(plans: Sequence[DistNttPlan],
                       xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Forward transform of the D row shards xs, each (L, N1/D, N2)."""
    xs = [shoup_mul(x, sp.psi, sp.psi_sh, sp.p_col) for sp, x in zip(plans, xs)]
    xs = all_to_all(xs, 2, 1)                            # -> (L, N1, N2/D)
    xs = [_col_ntt(sp, x, inverse=False) for sp, x in zip(plans, xs)]
    xs = [shoup_mul(x, sp.tw, sp.tw_sh, sp.p_col) for sp, x in zip(plans, xs)]
    xs = all_to_all(xs, 1, 2)                            # -> (L, N1/D, N2)
    return [_row_ntt(sp, x, inverse=False) for sp, x in zip(plans, xs)]


def dist_ntt_inv_shard(plans: Sequence[DistNttPlan],
                       ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inverse transform of the D row shards ys (the forward sequence mirrored)."""
    ys = [_row_ntt(sp, y, inverse=True) for sp, y in zip(plans, ys)]
    ys = all_to_all(ys, 2, 1)                            # -> (L, N1, N2/D)
    ys = [shoup_mul(y, sp.tw_inv, sp.tw_inv_sh, sp.p_col) for sp, y in zip(plans, ys)]
    ys = [_col_ntt(sp, y, inverse=True) for sp, y in zip(plans, ys)]
    ys = all_to_all(ys, 1, 2)                            # -> (L, N1/D, N2)
    return [shoup_mul(y, sp.psi_inv_n, sp.psi_inv_n_sh, sp.p_col)
            for sp, y in zip(plans, ys)]


Transform = Callable[[Sequence[torch.Tensor]], List[torch.Tensor]]


def make_dist_ntt(plan: DistNttPlan, mesh: Mesh) -> Tuple[Transform, Transform]:
    """(fwd, inv) over the mesh's 'sp' axis.

    Both take and return the D row shards (L, N1/D, N2) of an (L, N1, N2)
    operand, in mesh order (`shard(mesh, x, ROW_SPEC)`).
    """
    if mesh.axes != (SP_AXIS,):
        raise ValueError(f"the distributed NTT runs on a 1-D '{SP_AXIS}' mesh, "
                         f"got axes {mesh.axes}")
    rows = {name: shard(mesh, getattr(plan, name), ROW_SPEC)
            for name in ("psi", "psi_sh", "psi_inv_n", "psi_inv_n_sh")}
    cols = {name: shard(mesh, getattr(plan, name), COL_SPEC)
            for name in ("tw", "tw_sh", "tw_inv", "tw_inv_sh")}
    plans = [replace(plan, plan1=plan.plan1.to(dev), plan2=plan.plan2.to(dev),
                     p_col=plan.p_col.to(dev),
                     **{name: t[i] for name, t in {**rows, **cols}.items()})
             for i, dev in enumerate(mesh.devices)]
    return (lambda xs: dist_ntt_fwd_shard(plans, xs),
            lambda ys: dist_ntt_inv_shard(plans, ys))
