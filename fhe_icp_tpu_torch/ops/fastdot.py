"""Exact encrypted dot-product scoring of per-document ciphertexts by int8 products.

The score of one stored ciphertext (c0, c1) against a clear query q is

    score = coeff_{d-1}( INTT( (c0 + c1*s) . q_ntt ) )
          = sum_k c0[k]*v[k] + c1[k]*vs[k]          (mod p, per limb)

with v = q_ntt . w and vs = v . s_ntt folded per query, where w is the
single-coefficient INTT row (`cipher.coeff_weights`).  Scoring a store is
then one integer matrix-vector product per limb, evaluated exactly:

* residues are centered to (-p/2, p/2] and split into 4 balanced base-256
  digits in [-128, 127] (int8);
* an int8 x int8 -> int32 product contracts the 2N axis: every digit-pair
  partial is below 128*128*2N < 2^31, so the int32 sums are exact
  (`pack_cuda.int_mm`: `torch._int_mm` on the card);
* the partials fold back mod p with Montgomery multiplies by 2^{8s}
  (`_shift_consts`), then the (B, L) residues go through the exact RNS
  decode.

The layouts are the JAX package's, so digits compare bit for bit: a
`DocOperand` holds (L, 4, B, 2N) int8, a `QueryOperand` (L, 4, 2N).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cipher import SecretKey, centered_residues, coeff_weights, rns_decode_centered
from .context import CryptoContext
from .encoding import encode_rev
from .modmath import add_mod, i64, mont_mul, u32
from .ntt import ntt_fwd

N_DIGITS = 4


def center_residues(x: torch.Tensor, p) -> torch.Tensor:
    """uint32 residues in [0, p) -> centered int32 in (-p/2, p/2]."""
    x, p = i64(x), i64(p)
    return torch.where(x > (p >> 1), x - p, x).to(torch.int32)


def balanced_digits(x: torch.Tensor) -> torch.Tensor:
    """int32 (|x| < 2^30) -> (..., 4) int8 balanced base-256 digits.

    x == sum_i d_i * 256^i with d_i in [-128, 127].
    """
    digits = []
    c = x.to(torch.int32)
    for _ in range(N_DIGITS):
        d = ((c + 128) & 255) - 128
        digits.append(d.to(torch.int8))
        c = (c - d) >> 8
    return torch.stack(digits, dim=-1)


@dataclass(frozen=True)
class DocOperand:
    """Digit planes of a batch of stored ciphertexts: (L, 4, B, 2N) int8."""

    digits: torch.Tensor
    level: int

    @property
    def batch(self) -> int:
        return self.digits.shape[2]


@dataclass(frozen=True)
class QueryOperand:
    """Folded query vectors as digit planes: (L, 4, 2N) int8."""

    digits: torch.Tensor
    level: int
    d: int


def make_doc_operand(ctx: CryptoContext, ct_data: torch.Tensor, level: int) -> DocOperand:
    """(B, 2, L, N) uint32 ciphertexts -> digit planes, the same bytes as the
    ciphertexts; built once at ingestion."""
    b = ct_data.shape[0]
    a = ct_data.movedim(1, -2).reshape(b, level, 2 * ctx.n)          # (B, L, 2N)
    dig = balanced_digits(center_residues(a, ctx.p[:level]))         # (B, L, 2N, 4)
    return DocOperand(dig.permute(1, 3, 0, 2).contiguous(), level)


def make_query_operand(ctx: CryptoContext, sk: SecretKey, q_int: torch.Tensor,
                       d: int, level: int) -> QueryOperand:
    """Fold query, INTT row and secret key into digit planes.

    v  = NTT(encode_rev(q)) . w_{d-1}   (per limb)
    vs = v . s_ntt
    """
    l = level
    p, pinv = ctx.lp(l), ctx.lpinv(l)
    q_res = centered_residues(ctx, encode_rev(torch.as_tensor(q_int).to(ctx.device), ctx.n), l)
    q_ntt = ntt_fwd(ctx.plan, q_res)                                 # (L, N)
    v = mont_mul(q_ntt, coeff_weights(ctx, d - 1, l), p, pinv)       # q.w, normal domain
    vs = mont_mul(v, sk.s_ntt_mont[:l], p, pinv)                     # q.w.s
    dig = balanced_digits(center_residues(torch.cat([v, vs], dim=-1), p))   # (L, 2N, 4)
    return QueryOperand(dig.permute(0, 2, 1).contiguous(), l, d)


def fold_digit_products(ctx: CryptoContext, part: torch.Tensor, l: int,
                        k_len: int) -> torch.Tensor:
    """(L, 4, M, 4) int32 digit-pair partials -> (L, M) uint32 residues of
    sum_{i,j} part[:, i, :, j] * 2^{8(i+j)} mod p.

    Pairs group by shift s = i + j and each group folds with one Montgomery
    multiply by 2^{8s}.  A pair partial is bounded by 128*128*K (K the
    contraction length), so a group holds at most (2^31-1) // (128*128*K)
    pairs: its int32 sum cannot overflow even when every digit is -128
    (three pairs at K = 32768, ring-16384's 2N), as in the JAX package.
    """
    max_group = max(1, ((1 << 31) - 1) // (128 * 128 * k_len))
    p = ctx.p[:l]                                                    # (L, 1)
    pinv = ctx.p_neg_inv[:l]
    consts = _shift_tensor(ctx, l).to(part.device)
    acc = None
    for s in range(2 * N_DIGITS - 1):
        pairs = [part[:, i, :, s - i]                                # (L, M)
                 for i in range(max(0, s - N_DIGITS + 1), min(N_DIGITS, s + 1))]
        for g0 in range(0, len(pairs), max_group):
            ps = pairs[g0]
            for t in pairs[g0 + 1: g0 + max_group]:
                ps = ps + t
            # The signed group sum's canonical residue, times 2^{8s}.
            r = mont_mul(u32(torch.remainder(i64(ps), i64(p))), consts[s][:, None], p, pinv)
            acc = r if acc is None else add_mod(acc, r, p)
    return acc


def scores(ctx: CryptoContext, docs: DocOperand, query: QueryOperand,
           pt_corr: int = 1) -> torch.Tensor:
    """(B,) int32 exact dot-product scores of every document against the query."""
    from .pack_cuda import int_mm       # pack_cuda imports this module
    l = docs.level
    if query.level != l:
        raise ValueError(f"query at level {query.level}, documents at {l}")
    a = docs.digits                                                  # (L, 4, B, 2N)
    la, b = a.shape[0], a.shape[2]
    # One int8 product a limb: contract 2N -> (L, 4B, 4) int32, exact.
    part = int_mm(a.reshape(la, N_DIGITS * b, -1), query.digits.transpose(1, 2))
    part = part.reshape(la, N_DIGITS, b, N_DIGITS)                   # (L, i, B, j)
    acc = fold_digit_products(ctx, part, l, a.shape[-1])             # (L, B)
    return rns_decode_centered(ctx, acc.T[..., None], l, pt_corr)[..., 0]


def _shift_consts(ctx: CryptoContext, l: int) -> np.ndarray:
    """Per-shift Montgomery constants 2^{8s} * 2^32 mod p, shape (7, l)."""
    return ctx.cached(("fastdot_shift", l), lambda: np.asarray(
        [[(1 << (8 * s)) * (1 << 32) % p for p in ctx.primes[:l]]
         for s in range(2 * N_DIGITS - 1)], dtype=np.uint32))


def _shift_tensor(ctx: CryptoContext, l: int) -> torch.Tensor:
    """`_shift_consts` as int64 on the context's device, cached there: a copy
    from pageable host memory on every fold would make the host wait for the
    card's queue to drain before each fold's launches."""
    return ctx.cached(("fastdot_shift_t", l),
                      lambda: ctx.tensor(_shift_consts(ctx, l).astype(np.int64)))
