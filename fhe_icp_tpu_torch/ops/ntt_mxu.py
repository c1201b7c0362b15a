"""The four-step negacyclic NTT with its sub-transforms as exact int8 products.

The JAX package kept this transform to measure the one road past the
butterfly NTT's 32-bit multiplies: a four-step (Bailey) decomposition
N = N1 x N2 whose size-N1 and size-N2 sub-transforms are dense DFT-matrix
products, evaluated exactly on int8 operands by splitting both into
balanced base-256 digits (`ops/fastdot.py`): a partial sum over a length-N1
contraction is bounded by N1 * 128^2 < 2^31, so the int8 x int8 -> int32
product is exact, and the 16 digit-pair partials fold back mod p with a
bucket combine that stays in int32 (`_fold_buckets`).

Math (cyclic DFT per limb prime p, w a primitive N-th root):
  j = N2*j1 + j2,  k = k1 + N1*k2
  X[k] = sum_{j2} w^{j2*k1} * [ sum_{j1} (w^{N2})^{j1*k1} x[N2*j1+j2] ]
                   * (w^{N1})^{j2*k2}
Step 1: A = W1 @ M     (M[j1, j2] = x[N2*j1 + j2]; W1 the N1 x N1 DFT)
Step 2: B = A .* T     (T[k1, j2] = w^{k1*j2} twiddles)
Step 3: C = W2T @ B    (the N2-point DFT over j2)
Output: C[k2, k1] = X[k1 + N1*k2], natural order.

The negacyclic twist by psi^j comes first, as in `ops/ntt.py`.  The output
is in NATURAL order where `ntt_fwd` (K2) gives bit-reversed order: the two
are relabelings of the NTT domain, and this module exists to be measured
against K2 (`chip_smoke.py`, phase 8), not as a drop-in.  The DFT products
run as `pack_cuda.int_mm` (`torch._int_mm` on the card); the twist, the
twiddles and the bucket fold are plain PyTorch.  Each output coefficient
still needs two bucket folds (5 reductions and 4 Montgomery multiplies
each) where the butterfly transform needs about 7 Shoup multiplies, which
is why the JAX package kept the butterfly transform.
"""

from __future__ import annotations

import numpy as np
import torch

from . import primes as pr
from .context import CryptoContext
from .fastdot import N_DIGITS, _shift_consts, balanced_digits, center_residues
from .modmath import add_mod, i64, mont_mul, shoup_mul, u32
from .pack_cuda import int_mm


def _tables(ctx: CryptoContext, l: int, n1: int) -> dict:
    """Per-limb four-step constants, cached on the context.

    The int8 digit planes of W1 (the N1-DFT) and W2T (the N2-DFT,
    transposed), the twiddle and twist tables with their Shoup companions,
    and the Montgomery fold constants mont(2^{8s}) (fastdot's shift
    constants, limb-major); numpy with Python ints
    as in the JAX package, then tensors on the context's device.
    """
    def build():
        n = ctx.n
        n2 = n // n1
        w1d = np.empty((l, N_DIGITS, n1, n1), dtype=np.int8)
        w2d = np.empty((l, N_DIGITS, n2, n2), dtype=np.int8)
        tw = np.empty((l, n1, n2), dtype=np.uint32)
        tw_sh = np.empty_like(tw)
        psi_t = np.empty((l, n), dtype=np.uint32)
        psi_sh = np.empty_like(psi_t)

        def digits_of(mat, p):
            c = np.where(mat > p // 2, mat.astype(np.int64) - p, mat.astype(np.int64))
            out = []
            for _ in range(N_DIGITS):
                d = ((c + 128) % 256) - 128
                out.append(d.astype(np.int8))
                c = (c - d) >> 8
            return np.stack(out)

        for li, p in enumerate(ctx.primes[:l]):
            psi = pr.root_of_unity(p, 2 * n)
            w = psi * psi % p
            psi_row = np.array([pow(psi, e, p) for e in range(n)], dtype=np.uint64)
            psi_t[li] = psi_row.astype(np.uint32)
            psi_sh[li] = np.array([pr.shoup(int(v), p) for v in psi_row], dtype=np.uint32)
            wn2, wn1 = pow(w, n2, p), pow(w, n1, p)
            w1 = np.array([[pow(wn2, a * b % n1, p) for b in range(n1)] for a in range(n1)],
                          dtype=np.uint64)
            w2 = np.array([[pow(wn1, a * b % n2, p) for b in range(n2)] for a in range(n2)],
                          dtype=np.uint64)
            w1d[li] = digits_of(w1, p)                    # [k1, j1]
            w2d[li] = digits_of(w2.T, p)                  # transposed: [k2, j2]
            t = np.array([[pow(w, a * b % n, p) for b in range(n2)] for a in range(n1)],
                         dtype=np.uint64)
            tw[li] = t.astype(np.uint32)
            tw_sh[li] = np.array([[pr.shoup(int(v), p) for v in row] for row in t],
                                 dtype=np.uint32)
        tabs = {"w1_dig": w1d.reshape(l, N_DIGITS * n1, n1),
                "w2t_dig": w2d.reshape(l, N_DIGITS * n2, n2),
                "tw": tw, "tw_sh": tw_sh, "psi": psi_t, "psi_sh": psi_sh,
                "fold_c": _shift_consts(ctx, l).T.astype(np.int64)}
        return {**{k: ctx.tensor(v) for k, v in tabs.items()}, "n1": n1, "n2": n2}
    return ctx.cached(("ntt_mxu", l, n1), build)


# Bucket groups for the digit fold: bucket s = i+j holds sum_{i+j=s} P[i,j]
# with |P| <= Nmat*128^2 and multiplicity m_s = [1,2,3,4,3,2,1][s].  A group
# (s, s+1) combines as C_s + 256*C_{s+1}, bound (m_s + 256*m_{s+1})*Nmat*128^2;
# at Nmat = 128 the pair (2, 3) reaches exactly 2^31 (not int32-safe), so it
# stays split.  Every listed group is below 2^31 for Nmat <= 128.
_FOLD_GROUPS = ((0, 1), (2,), (3,), (4, 5), (6,))


def _fold_buckets(part: torch.Tensor, nmat: int, p, pinv, fold_c) -> torch.Tensor:
    """(L, 4*Nmat, 4, cols) int32 digit partials -> (L, Nmat, cols) uint32.

    part[l, i*Nmat + r, j, c] is the product of W-digit i row r with
    data-digit j.  The buckets combine in int32 per _FOLD_GROUPS, then one
    reduction and one Montgomery multiply by mont(2^{8s}) per group.
    """
    l, cols = part.shape[0], part.shape[-1]
    p5 = part.reshape(l, N_DIGITS, nmat, N_DIGITS, cols)
    buckets: dict = {}
    for i in range(N_DIGITS):
        for j in range(N_DIGITS):
            t = p5[:, i, :, j, :]
            buckets[i + j] = t if i + j not in buckets else buckets[i + j] + t
    acc = None
    for group in _FOLD_GROUPS:
        c = buckets[group[0]]
        if len(group) == 2:
            c = c + buckets[group[1]] * 256
        r = u32(torch.remainder(i64(c), i64(p)))         # the signed sum's residue
        if group[0]:
            r = mont_mul(r, fold_c[:, group[0]][:, None, None], p, pinv)
        acc = r if acc is None else add_mod(acc, r, p)
    return acc


def ntt_fwd_mxu(ctx: CryptoContext, x: torch.Tensor, n1: int = 128) -> torch.Tensor:
    """Negacyclic forward NTT by int8 products; NATURAL-order output.

    x: (B, L, N) uint32 residues.  Returns (B, L, N) uint32 with
    out[b, l, k] = sum_j psi^j x[b, l, j] w^{jk} mod p_l.
    """
    b, l, n = x.shape
    tabs = _tables(ctx, l, n1)
    n2 = tabs["n2"]
    p = ctx.lp(l).reshape(l, 1, 1)
    pinv = ctx.lpinv(l).reshape(l, 1, 1)

    # Twist (psi^j), then view as (B, L, N1, N2).
    m = shoup_mul(x, tabs["psi"], tabs["psi_sh"], ctx.lp(l)).reshape(b, l, n1, n2)

    # Step 1: A = W1 @ M per limb; rhs digits (L, N1, B*4*N2).
    md = balanced_digits(center_residues(m, p[None]))              # (B, L, N1, N2, 4)
    rhs = md.permute(1, 2, 0, 4, 3).reshape(l, n1, b * N_DIGITS * n2)
    part = int_mm(tabs["w1_dig"], rhs)                              # (L, 4N1, B*4*N2)
    part = part.reshape(l, N_DIGITS * n1, b, N_DIGITS, n2).permute(0, 1, 3, 2, 4)
    a = _fold_buckets(part.reshape(l, N_DIGITS * n1, N_DIGITS, b * n2), n1, p, pinv,
                      tabs["fold_c"]).reshape(l, n1, b, n2)

    # Step 2: twiddle w^{k1*j2}.
    bmat = shoup_mul(a, tabs["tw"][:, :, None, :], tabs["tw_sh"][:, :, None, :],
                     p[..., None])                                  # (L, N1, B, N2)

    # Step 3: C = W2T @ B over j2; rhs digits (L, N2, B*4*N1).
    bd = balanced_digits(center_residues(bmat.permute(0, 3, 2, 1), p[..., None]))
    rhs2 = bd.permute(0, 1, 2, 4, 3).reshape(l, n2, b * N_DIGITS * n1)
    part2 = int_mm(tabs["w2t_dig"], rhs2)                           # (L, 4N2, B*4*N1)
    part2 = part2.reshape(l, N_DIGITS * n2, b, N_DIGITS, n1).permute(0, 1, 3, 2, 4)
    c = _fold_buckets(part2.reshape(l, N_DIGITS * n2, N_DIGITS, b * n1), n2, p, pinv,
                      tabs["fold_c"])                               # (L, N2, B*N1)
    # C[k2, k1] = X[k1 + N1*k2]: (L, N2, B, N1) -> (B, L, N2*N1), natural order.
    return c.reshape(l, n2, b, n1).permute(2, 0, 1, 3).reshape(b, l, n)
