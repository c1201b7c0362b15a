"""Plain reference of a store's search, in PyTorch: exact scores and top-k of
integer documents and queries, in blocks of documents, on a device given to it.

Scores are computed in float64: the inputs are integers of at most 2^15 in
magnitude and at most 2^16 wide (quantized unit vectors are at most 1000 in
magnitude and 128 wide, so |score| <= 128 * 1000^2), so every product and
every partial sum is an integer below 2^46, which float64 holds exactly.
TF32 never applies to float64.  Answers are judged by the rules of
`scores.wrong_topk`.  Imports neither JAX nor any package of this repository.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

_EXACT_BOUND = 1 << 15
BLOCK = 1 << 18             # documents a block


def _exact(x, device: torch.device) -> torch.Tensor:
    x = torch.as_tensor(x).to(device=device, dtype=torch.float64)
    if x.numel() and (x.abs().max() > _EXACT_BOUND or x.shape[-1] > 1 << 16):
        raise ValueError("inputs too wide for exact float64 dot products")
    return x


def score_blocks(docs, queries, device: torch.device) -> Iterator[Tuple[int, torch.Tensor]]:
    """(n, d) documents x (m, d) queries: each block's first document and its
    (rows, m) exact scores as int64 on `device`."""
    q = _exact(queries, device).T
    for lo in range(0, len(docs), BLOCK):
        yield lo, (_exact(docs[lo: lo + BLOCK], device) @ q).to(torch.int64)


def scores(docs, queries, device: torch.device) -> torch.Tensor:
    """(n, m) int64 exact dot products on `device`."""
    return torch.cat([s for _, s in score_blocks(docs, queries, device)])


def topk(docs, queries, k: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores of each query, descending, and their documents'
    ids: two (k, m) int64 tensors on `device` (k at most n)."""
    vals = ids = None
    for lo, s in score_blocks(docs, queries, device):
        v, i = torch.topk(s, min(k, s.shape[0]), dim=0)
        if vals is not None:
            v, i = torch.cat([vals, v]), torch.cat([ids, i + lo])
            v, pos = torch.topk(v, min(k, v.shape[0]), dim=0)
            i = torch.gather(i, 0, pos)
        vals, ids = v, i
    return vals, ids


def wrong_topk(docs, queries, answers: Sequence[Optional[tuple]], k: int,
               device: torch.device) -> int:
    """How many answers are not an exact top-k of their query: values other
    than the k largest scores in descending order, an id out of range or
    repeated, or an id whose score is not the value beside it.  A missing
    answer counts as wrong."""
    if not len(answers):
        return 0
    n = len(docs)
    want = topk(docs, queries, min(k, n), device)[0].cpu()
    q64 = torch.as_tensor(np.asarray(queries)).to(torch.int64)
    wrong = 0
    for j, ans in enumerate(answers):
        if ans is None:
            wrong += 1
            continue
        vals, idx = (torch.from_numpy(np.array(a, dtype=np.int64)) for a in ans)
        ok = (vals.shape == want[:, j].shape and torch.equal(vals, want[:, j])
              and len(set(idx.tolist())) == len(idx)
              and bool((idx >= 0).all()) and bool((idx < n).all()))
        if ok:
            own = torch.as_tensor(docs[idx.numpy()]).to(torch.int64) @ q64[j]
            ok = torch.equal(own, vals)
        wrong += not ok
    return wrong


def wrong_scores(docs, queries, got: Sequence[Optional[torch.Tensor]],
                 device: torch.device) -> int:
    """How many of the (n,) score vectors `got`, one a query, differ from the
    exact scores; a missing vector counts each of its n scores."""
    present = [j for j, g in enumerate(got) if g is not None]
    wrong = len(docs) * (len(got) - len(present))
    if not present:
        return wrong
    qs = np.asarray(queries)[present]
    for lo, s in score_blocks(docs, qs, device):
        mine = torch.stack([got[j][lo: lo + s.shape[0]].to(device, torch.int64)
                            for j in present], dim=1)
        wrong += int((mine != s).sum())
    return wrong
