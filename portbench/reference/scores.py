"""Plain references for scores: exact dot products and top-k of integer vectors.

Scores are computed in float64 by BLAS: the inputs are integers of at
most 2^15 in magnitude and at most 2^16 wide, so every product and every
partial sum is an integer below 2^46, which float64 holds exactly.
Imports neither JAX nor any package of this repository.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_EXACT_BOUND = 1 << 15
_BLOCK = 64


def _exact(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.size and (np.abs(x.astype(np.int64)).max() > _EXACT_BOUND or x.shape[-1] > 1 << 16):
        raise ValueError("inputs too wide for exact float64 dot products")
    return x.astype(np.float64)


def scores(docs: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """(n, d) x (m, d) integers -> (n, m) int64 exact dot products."""
    return (_exact(docs) @ _exact(queries).T).astype(np.int64)


def topk_values(s: np.ndarray, k: int) -> np.ndarray:
    """The k largest values of each column of (n, m), descending: (k, m)."""
    part = -np.partition(-s, k - 1, axis=0)[:k]
    return -np.sort(-part, axis=0)


def wrong_topk(docs: np.ndarray, queries: np.ndarray,
               answers: Sequence[Tuple[np.ndarray, np.ndarray] | None], k: int) -> int:
    """How many answers are not an exact top-k of their query: values other
    than the reference's k largest scores in descending order, an id out of
    range or repeated, or an id whose score is not the value beside it.
    A missing answer counts as wrong."""
    wrong = 0
    for lo in range(0, len(answers), _BLOCK):
        s = scores(docs, queries[lo: lo + _BLOCK])
        want = topk_values(s, min(k, len(docs)))
        for j, ans in enumerate(answers[lo: lo + _BLOCK]):
            if ans is None:
                wrong += 1
                continue
            vals, idx = (np.asarray(a).astype(np.int64) for a in ans)
            ok = (vals.shape == want[:, j].shape and np.array_equal(vals, want[:, j])
                  and len(set(idx.tolist())) == len(idx)
                  and idx.min(initial=0) >= 0 and idx.max(initial=0) < len(docs)
                  and np.array_equal(s[idx, j], vals))
            wrong += not ok
    return wrong


def int8_round(x: np.ndarray, step: int = 8) -> np.ndarray:
    """Scale-1000 integers to the int8 range (|x| <= 1000 -> |x/8| <= 125)."""
    return np.round(np.asarray(x, dtype=np.float64) / step).astype(np.int64)


def topk_int8(docs: np.ndarray, query: np.ndarray, k: int, step: int = 8):
    """The control: the top-k of documents and query rounded to int8, its
    scores scaled back by step^2.  Returns (values, ids) as the program does."""
    s = scores(int8_round(docs, step), int8_round(query, step)[None])[:, 0] * step * step
    idx = np.argsort(-s, kind="stable")[:k]
    return s[idx], idx


def dot_int8(a: np.ndarray, b: np.ndarray, step: int = 8) -> int:
    """The control of one compare: the dot product of the int8-rounded vectors."""
    return int(int8_round(a, step) @ int8_round(b, step)) * step * step
