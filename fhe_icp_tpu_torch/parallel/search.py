"""Sharded encrypted search: per-shard scoring and a distributed top-k over a mesh.

The counterparts of the JAX package's `parallel/search.py`, on a mesh of
logical shards (`mesh.py`) driven from one process:

* `make_sharded_packed_search` — the slot-packed search with its group
  rows over `dp`: each shard scores its groups with the scoring kernel K1
  (`ops/pack.packed_scores`), ranks them with `topk_hierarchical`, and
  only k values and k global indices per shard meet in the final merge.
* `make_sharded_fastdot_search` — per-document scoring (`ops/fastdot.py`)
  with the documents over `dp`: each shard scores its documents with one
  int8 product a limb against the replicated query operand, and the top-k
  runs on the gathered (B,) scores.
* `make_sharded_search` — the NTT-domain matvec sharded batch-over-dp and
  limbs-over-tp; the `tp` shards of each `dp` row are gathered along the
  limb axis for the single-coefficient decode, which needs every limb.

Shards on another card than the context's get a context of their own, so
every table a shard reads lies on its card.  The JAX package's placements
`doc_operand_sharding` and `packed_operand_sharding` give the specs
`mesh.DOC_OPERAND_SPEC` and `mesh.PACKED_OPERAND_SPEC`, which `mesh.shard`
cuts by.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import dot, fastdot, pack
from ..ops.arith import plain_to_eval
from ..ops.cipher import Ciphertext, SecretKey
from ..ops.context import CryptoContext
from ..ops.encoding import encode_rev
from ..ops.modmath import mont_mul
from .mesh import DOC_OPERAND_SPEC, DP_AXIS, PACKED_OPERAND_SPEC, TP_AXIS, Mesh, Spec


def _contexts(ctx: CryptoContext, mesh: Mesh) -> Dict[torch.device, CryptoContext]:
    """One context per device of the mesh; `ctx` itself on its own device (its
    tables' device: `ctx.device` may name the card without its index)."""
    return {dev: ctx if dev == ctx.p.device else CryptoContext(ctx.params, dev)
            for dev in dict.fromkeys(mesh.devices)}


def topk_hierarchical(flat: torch.Tensor, k: int,
                      seg: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of a long int vector: segment top-k, then a merge.

    Any element of the global top-k is in the top-k of its segment, so
    ranking s*k survivors is exact.  The tail segment is padded with the
    dtype's minimum; the global indices are clamped below n, so a pad slot
    that ties with real minimum values still points inside the vector.
    """
    n = flat.shape[0]
    if n <= 2 * seg:
        return torch.topk(flat, min(k, n))
    s = -(-n // seg)
    pad = s * seg - n
    fp = flat
    if pad:
        fp = torch.cat([flat, flat.new_full((pad,), torch.iinfo(flat.dtype).min)])
    v, i = torch.topk(fp.reshape(s, seg), min(k, seg))
    base = torch.arange(s, device=flat.device)[:, None] * seg
    gi = (i + base).reshape(-1).clamp(max=n - 1)
    fv, fpos = torch.topk(v.reshape(-1), k)
    return fv, gi[fpos]


SearchStep = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def doc_operand_sharding(mesh: Mesh) -> Spec:
    """DocOperand digits (L, 4, B, 2N): the documents over dp."""
    return DOC_OPERAND_SPEC


def packed_operand_sharding(mesh: Mesh) -> Spec:
    """PackedDocOperand digits (L, G*4, 2N): group-major rows over dp."""
    return PACKED_OPERAND_SPEC


def make_sharded_fastdot_search(ctx: CryptoContext, mesh: Mesh, top_k: int = 5,
                                pt_corr: int = 1) -> SearchStep:
    """Per-document scoring with the documents sharded over dp.

    Returns step(doc_shards, query_digits) -> (scores (B,) int32,
    topk_vals (k,), topk_idx (k,)).  doc_shards are the per-shard DocOperand
    digits, `shard(mesh, digits, DOC_OPERAND_SPEC)`; query_digits is the
    (L, 4, 2N) QueryOperand digits, copied to every card.  Each shard scores
    its documents on its own card; the top-k runs on the gathered score
    vector, as in the JAX package.  Results lie on the mesh's first device.
    """
    n_dp = mesh.shape[DP_AXIS]
    level = ctx.n_limbs
    ctxs = _contexts(ctx, mesh)
    out_dev = mesh.devices[0]

    def step(doc_shards: Sequence[torch.Tensor], query_digits: torch.Tensor):
        queries = {dev: query_digits.to(dev) for dev in ctxs}
        parts = []
        for i in range(n_dp):
            digits = doc_shards[mesh.index({DP_AXIS: i})]
            q = fastdot.QueryOperand(queries[digits.device], level, 0)
            parts.append(fastdot.scores(ctxs[digits.device], fastdot.DocOperand(digits, level),
                                        q, pt_corr).to(out_dev))
        scores = torch.cat(parts)
        vals, idx = torch.topk(scores, min(top_k, scores.shape[0]))
        return scores, vals, idx

    return step


def make_sharded_packed_search(ctx: CryptoContext, mesh: Mesh, d: int, top_k: int = 5,
                               pt_corr: int = 1, n_docs: Optional[int] = None) -> SearchStep:
    """The slot-packed search sharded over the document groups (`dp`).

    Returns step(doc_shards, query_digits) -> (scores (G*S,) int32,
    topk_vals (k,), topk_idx (k,)).  doc_shards are the per-shard
    PackedDocOperand digits, `shard(mesh, digits, PACKED_OPERAND_SPEC)`;
    query_digits is the (L, 2N, 4S) PackedQueryOperand digits.  Each shard
    ranks its own scores; the merge sees n_dp * k candidates, never the
    whole score vector.  `n_docs` leaves global indices >= n_docs (zero
    ciphertext padding) out of the ranking; the scores stay raw.  Results
    lie on the mesh's first device.
    """
    slots = pack.slots_per_ct(ctx.n, d)
    n_dp = mesh.shape[DP_AXIS]
    level = ctx.n_limbs
    ctxs = _contexts(ctx, mesh)
    out_dev = mesh.devices[0]
    low = torch.iinfo(torch.int32).min

    def step(doc_shards: Sequence[torch.Tensor], query_digits: torch.Tensor):
        queries = {dev: query_digits.to(dev) for dev in ctxs}
        flats, vals, idxs = [], [], []
        for i in range(n_dp):
            digits = doc_shards[mesh.index({DP_AXIS: i})]
            c = ctxs[digits.device]
            docs = pack.PackedDocOperand(digits, level)
            q = pack.PackedQueryOperand(queries[digits.device], level, d, slots)
            flat = pack.packed_scores(c, docs, q, pt_corr).reshape(-1)
            base = i * flat.shape[0]
            ranked = flat
            if n_docs is not None and n_docs < n_dp * flat.shape[0]:
                pos = base + torch.arange(flat.shape[0], device=flat.device)
                ranked = torch.where(pos < n_docs, flat, low)
            k = min(top_k, flat.shape[0])
            l_vals, l_idx = topk_hierarchical(ranked, k)
            flats.append(flat.to(out_dev))
            vals.append(l_vals.to(out_dev))
            idxs.append((l_idx + base).to(out_dev))
        vals_all, idx_all = torch.cat(vals), torch.cat(idxs)
        # With few scores per shard the global top-k spans shards, so the
        # merge keeps up to top_k of all n_dp * k candidates.
        m_vals, m_pos = torch.topk(vals_all, min(top_k, vals_all.shape[0]))
        return torch.cat(flats), m_vals, idx_all[m_pos]

    return step


def make_sharded_search(ctx: CryptoContext, sk: SecretKey, mesh: Mesh, d: int,
                        level: int, top_k: int = 5) -> SearchStep:
    """The NTT-domain search: documents over `dp`, limbs over `tp`.

    Returns step(cts_shards, query (d,) int32) -> (scores (B,) int32,
    topk_vals (k,), topk_idx (k,)).  cts_shards are the per-shard
    ciphertexts, `shard(mesh, cts.data, BATCH_SPEC)`, each
    (B/dp, 2, level/tp, N).  Results lie on the mesh's first device.
    """
    n_dp, n_tp = mesh.shape[DP_AXIS], mesh.shape[TP_AXIS]
    if level % n_tp:
        raise ValueError(f"{level} limbs do not split over {n_tp} tp shards")
    lt = level // n_tp
    ctxs = _contexts(ctx, mesh)
    sks = {dev: SecretKey(*(t.to(dev) for t in (sk.s, sk.s_ntt_mont, sk.s2_ntt_mont)))
           for dev in ctxs}
    out_dev = mesh.devices[0]

    def step(cts_shards: Sequence[torch.Tensor], query: torch.Tensor):
        pts = {dev: plain_to_eval(c, encode_rev(query.to(dev), c.n), level)
               for dev, c in ctxs.items()}
        rows: List[torch.Tensor] = []
        for i in range(n_dp):
            parts = []
            for j in range(n_tp):
                x = cts_shards[mesh.index({DP_AXIS: i, TP_AXIS: j})]
                c, lo = ctxs[x.device], j * lt
                parts.append(mont_mul(x, pts[x.device][lo:lo + lt][None],
                                      c.p[lo:lo + lt], c.p_neg_inv[lo:lo + lt]))
            row_dev = parts[0].device
            prod = Ciphertext(torch.cat([p.to(row_dev) for p in parts], dim=-2), level)
            rows.append(dot.decrypt_dot(ctxs[row_dev], sks[row_dev], prod, d).to(out_dev))
        scores = torch.cat(rows)
        vals, idx = torch.topk(scores, min(top_k, scores.shape[0]))
        return scores, vals, idx

    return step
