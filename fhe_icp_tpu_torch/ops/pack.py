"""Slot-packed encrypted scoring: many documents per ciphertext.

S = N/d documents share one ciphertext in disjoint coefficient blocks:
slot s holds document s at coefficients [s*d, (s+1)*d).  Against a query
in the reversed encoding, the negacyclic product places document s's
inner product at coefficient s*d + d - 1 with no cross-slot terms.

Packing is homomorphic: stored per-document ciphertexts (ascending
encoding) combine as ct_packed = sum_s ct_s * X^{s*d}, where the monomial
product is a pointwise NTT-domain multiply that adds no noise.

Scoring is one int8 digit product per limb, a separable digit fold and
the exact RNS decode.  For CUDA tensors the product and the fold run as
one kernel (`ops/pack_cuda.py`, `csrc/pack_score.cu`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import pack_cuda
from . import primes as pr
from .cipher import SecretKey, _pow_table, bitrev, centered_residues, rns_decode_centered
from .context import CryptoContext
from .encoding import encode_rev
from .fastdot import N_DIGITS, _shift_consts, balanced_digits, center_residues
from .modmath import add_mod, i64, mont_mul, u32
from .ntt import ntt_fwd


def slots_per_ct(n: int, d: int) -> int:
    """Number of d-dim documents one degree-N ciphertext holds."""
    assert n % d == 0, f"slot width {d} must divide ring degree {n}"
    return n // d


def encode_packed(vecs: torch.Tensor, n: int) -> torch.Tensor:
    """(..., S, d) int -> (..., N) int32 poly with doc s at X^{s*d + i}."""
    s, d = vecs.shape[-2], vecs.shape[-1]
    assert s * d <= n
    flat = vecs.reshape(vecs.shape[:-2] + (s * d,)).to(torch.int32)
    return F.pad(flat, (0, n - s * d))


# ---------------------------------------------------------------------------
# Homomorphic packing
# ---------------------------------------------------------------------------


def _monomial_table(ctx: CryptoContext, d: int, slots: int, l: int) -> torch.Tensor:
    """(S, l, N) uint32: NTT(X^{s*d}) in Montgomery form, cached.

    With the bit-reversed layout, slot m of NTT(X^k) is
    psi^k * w^{k * bitrev(m)} (twist, then the cyclic transform of a one-hot).
    """
    def build():
        n = ctx.n
        brv = bitrev(n)
        out = np.empty((slots, l, n), dtype=np.uint32)
        for li, p in enumerate(ctx.primes[:l]):
            psi = pr.root_of_unity(p, 2 * n)
            tbl = _pow_table(psi * psi % p, n, p)
            for s in range(slots):
                k = s * d
                lead = pow(psi, k, p) * ((1 << 32) % p) % p    # Montgomery form
                out[s, li] = (tbl[(k * brv) % n] * lead % p).astype(np.uint32)
        return ctx.tensor(out)
    return ctx.cached(("pack_mono", d, slots, l), build)


def pack_ciphertexts(ctx: CryptoContext, cts_data: torch.Tensor, d: int,
                     level: int) -> torch.Tensor:
    """(B, 2, L, N) uint32 per-doc ciphertexts -> (G, 2, L, N) packed.

    G = ceil(B / S); the tail group is padded with zero ciphertexts (which
    decrypt to 0).  Documents must be in the ascending encoding.  The
    per-slot loop keeps the temporaries at (G, 2, L, N).
    """
    slots = slots_per_ct(ctx.n, d)
    b = cts_data.shape[0]
    g = -(-b // slots)
    pad = g * slots - b
    if pad:
        cts_data = torch.cat(
            [cts_data, cts_data.new_zeros((pad,) + tuple(cts_data.shape[1:]))])
    grouped = cts_data.reshape(g, slots, 2, level, ctx.n)
    mono = _monomial_table(ctx, d, slots, level)                  # (S, L, N)
    p, pinv = ctx.lp(level), ctx.lpinv(level)
    acc = mont_mul(grouped[:, 0], mono[0], p, pinv)
    for s in range(1, slots):
        acc = add_mod(acc, mont_mul(grouped[:, s], mono[s], p, pinv), p)
    return acc


# ---------------------------------------------------------------------------
# Packed query operand + scoring
# ---------------------------------------------------------------------------


def packed_coeff_weights(ctx: CryptoContext, d: int, slots: int, l: int) -> torch.Tensor:
    """(l, N, S) uint32 Montgomery: per-slot single-coefficient INTT rows.

    Column s is cipher.coeff_weights for output coefficient s*d + d - 1.
    """
    def build():
        n = ctx.n
        brv = bitrev(n)
        j_s = np.arange(slots, dtype=np.int64) * d + (d - 1)       # (S,)
        out = np.empty((l, n, slots), dtype=np.uint32)
        for li, p in enumerate(ctx.primes[:l]):
            psi = pr.root_of_unity(p, 2 * n)
            tbl = _pow_table(pow(psi * psi % p, p - 2, p), n, p)
            n_inv = pow(n, p - 2, p)
            lead = np.array([pow(psi, -(int(j) % (2 * n)), p) * n_inv % p
                             for j in j_s], dtype=np.uint64)       # (S,)
            rows = tbl[(j_s[None, :] * brv[:, None]) % n] * lead[None, :] % p
            out[li] = (rows * ((1 << 32) % p) % p).astype(np.uint32)
        return ctx.tensor(out)
    return ctx.cached(("pack_coeff_w", d, slots, l), build)


@dataclass(frozen=True)
class PackedDocOperand:
    """Digit planes of packed ciphertexts: (L, G*4, 2N) int8, group-major.

    Row g*4 + i is digit plane i of packed group g, so a split of the rows
    over shards keeps whole groups together.  `n_groups` is the group
    count before padding (None when there is none): a ranking over the
    scores must leave the zero-scoring pad slots out.
    """

    digits: torch.Tensor
    level: int
    n_groups: Optional[int] = None

    @property
    def groups(self) -> int:
        return self.digits.shape[1] // N_DIGITS

    def real_docs(self, slots: int) -> int:
        """Upper bound on real documents: pre-pad groups x slots."""
        return (self.n_groups if self.n_groups is not None else self.groups) * slots


def make_packed_doc_operand(ctx: CryptoContext, ct_data: torch.Tensor, level: int,
                            pad_groups_to: int = 1) -> PackedDocOperand:
    """(G, 2, L, N) uint32 packed ciphertexts -> int8 digit planes.

    `pad_groups_to` rounds the group count up with zero ciphertexts, which
    score exactly 0, so that the groups divide over the shards of a mesh.
    A zero ciphertext's digits are zero, so the padding is added to the
    int8 digits directly.
    """
    g = ct_data.shape[0]
    a = ct_data.movedim(1, -2).reshape(g, level, 2 * ctx.n)       # (G, L, 2N)
    dig = balanced_digits(center_residues(a, ctx.p[:level]))     # (G, L, 2N, 4)
    extra = -g % pad_groups_to
    if extra:
        dig = torch.cat([dig, dig.new_zeros((extra,) + tuple(dig.shape[1:]))])
    dig = dig.permute(1, 0, 3, 2).reshape(level, (g + extra) * N_DIGITS, 2 * ctx.n)
    return PackedDocOperand(dig.contiguous(), level, g if extra else None)


@dataclass(frozen=True)
class PackedQueryOperand:
    """Folded per-slot query digit planes in matmul layout: (L, 2N, 4S) int8.

    Column c = j*S + s is query digit j of slot s.
    """

    digits: torch.Tensor
    level: int
    d: int
    slots: int


def make_packed_query_operand(ctx: CryptoContext, sk: SecretKey, q_int: torch.Tensor,
                              d: int, level: int) -> PackedQueryOperand:
    """Fold query, per-slot INTT rows and secret key into digit planes.

    v[:, :, s]  = NTT(encode_rev(q)) . w_{s*d+d-1}   (per limb)
    vs[:, :, s] = v[:, :, s] . s_ntt
    """
    l = level
    slots = slots_per_ct(ctx.n, d)
    p3, pinv3 = ctx.p[:l, :, None], ctx.p_neg_inv[:l, :, None]
    q_res = centered_residues(ctx, encode_rev(q_int.to(ctx.device), ctx.n), l)
    q_ntt = ntt_fwd(ctx.plan, q_res)                              # (L, N)
    w = packed_coeff_weights(ctx, d, slots, l)                    # (L, N, S)
    v = mont_mul(q_ntt[:, :, None], w, p3, pinv3)
    vs = mont_mul(v, sk.s_ntt_mont[:l][:, :, None], p3, pinv3)
    dig = balanced_digits(center_residues(torch.cat([v, vs], dim=1), p3))
    vmat = dig.permute(0, 1, 3, 2).reshape(l, 2 * ctx.n, N_DIGITS * slots)
    return PackedQueryOperand(vmat.contiguous(), l, d, slots)


def fold_separable(ctx: CryptoContext, part: torch.Tensor, l: int,
                   slots: int) -> torch.Tensor:
    """(L, G*4, 4S) int32 digit-pair partials -> (L, G, S) uint32 residues.

    The weight 2^{8(i+j)} separates: fold the query-digit axis j (column
    blocks) first, then the doc-digit axis i (row phase).  Every partial
    is reduced on its own, so no grouping bound is needed.
    """
    p = ctx.p[:l].reshape(l, 1, 1)
    pinv = ctx.p_neg_inv[:l].reshape(l, 1, 1)
    consts = torch.from_numpy(_shift_consts(ctx, l).astype(np.int64)).to(part.device)
    inner = None                                                  # (L, G*4, S)
    for j in range(N_DIGITS):
        # Signed partials: the remainder is the canonical residue.
        r = u32(torch.remainder(i64(part[:, :, j * slots:(j + 1) * slots]), i64(p)))
        if j:
            r = mont_mul(r, consts[j].reshape(l, 1, 1), p, pinv)
        inner = r if inner is None else add_mod(inner, r, p)
    inner = inner.reshape(l, -1, N_DIGITS, slots)                 # (L, G, i, S)
    acc = None
    for i in range(N_DIGITS):
        r = inner[:, :, i, :]
        if i:
            r = mont_mul(r, consts[i].reshape(l, 1, 1), p, pinv)
        acc = r if acc is None else add_mod(acc, r, p)
    return acc


def packed_scores(ctx: CryptoContext, docs: PackedDocOperand,
                  query: PackedQueryOperand, pt_corr: int = 1) -> torch.Tensor:
    """(G, S) int32 exact per-slot scores of packed docs against the query."""
    l = docs.level
    assert query.level == l
    acc = pack_cuda.packed_score_residues(ctx, docs.digits, query.digits, l,
                                          query.slots)            # (L, G, S)
    res = acc.movedim(0, -1)[..., None]                           # (G, S, L, 1)
    return rns_decode_centered(ctx, res, l, pt_corr)[..., 0]
