"""Dimension-reduction sweep: PCA against SVD against random projection.

For each method and target dimension, fit the port's `DimensionReducer`
(on `device`, the card by default) on a corpus of embeddings and report
explained variance, reconstruction error, similarity preservation
(correlation of pairwise cosines) and memory saving; the results go to
`dimension_reduction_results.json` and the best 128-dim reducer to
`pca_reducer_128.npz`, in the JAX package's layout.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.reduction import DimensionReducer

logger = logging.getLogger(__name__)


def make_corpus(n: int = 512, dim: int = 768, seed: int = 42) -> np.ndarray:
    """Synthetic embedding corpus with a realistic low-rank structure."""
    rng = np.random.default_rng(seed)
    rank = dim // 4
    basis = rng.standard_normal((rank, dim))
    weights = rng.standard_normal((n, rank)) * np.linspace(3, 0.1, rank)
    x = weights @ basis + 0.05 * rng.standard_normal((n, dim))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def run_sweep(corpus: Optional[np.ndarray] = None, target_dims=(64, 128, 256),
              methods=("pca", "svd", "random"),
              out_path: Optional[str] = "dimension_reduction_results.json",
              save_best: bool = True, device: torch.device | str = "cuda") -> List[Dict]:
    x = corpus if corpus is not None else make_corpus()
    in_dim = x.shape[1]
    results = []
    for dim in target_dims:
        for method in methods:
            r = DimensionReducer(dim, method=method, device=device).fit(x)
            evr = r.explained_variance_ratio_
            res = {"method": method, "target_dim": dim,
                   "explained_variance": float(np.sum(evr)) if evr is not None else None,
                   "reconstruction_error": r.reconstruction_error(x),
                   "similarity_preservation": r.similarity_preservation(x),
                   "memory_saving": 1.0 - dim / in_dim}
            res = {k: (None if isinstance(v, float) and np.isnan(v) else v)
                   for k, v in res.items()}
            results.append(res)
            logger.info("%s dim=%d: sim-preservation=%.4f", method, dim,
                        res["similarity_preservation"])
    if out_path:
        Path(out_path).write_text(json.dumps(results, indent=2))
    if save_best:
        best = max((r for r in results if r["target_dim"] == 128),
                   key=lambda r: r["similarity_preservation"])
        DimensionReducer(128, method=best["method"], device=device).fit(x).save(
            "pca_reducer_128.npz")
        logger.info("saved the best 128-dim reducer (%s) to pca_reducer_128.npz",
                    best["method"])
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(run_sweep(), indent=2))
