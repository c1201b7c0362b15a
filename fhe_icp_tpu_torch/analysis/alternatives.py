"""FHE-friendly similarity metrics, benchmarked against exact cosine.

Metrics that avoid division and square roots (hard or costly under FHE):
Manhattan, Chebyshev, Hamming-sign, a polynomial kernel and a
Taylor-corrected cosine, with a seed-42 correlation benchmark against
exact cosine persisted to `similarity_metrics_comparison.json`.  numpy
only, the JAX package's numbers.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


class FHEFriendlySimilarity:
    """All metrics assume L2-normalized inputs (as the pipeline produces)."""

    @staticmethod
    def cosine(a, b) -> float:
        """Ground truth (uses division: not FHE-friendly)."""
        return float(np.dot(a, b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))

    @staticmethod
    def dot(a, b) -> float:
        """Plain inner product: cosine for unit vectors, and the FHE-native
        metric (one ct x pt or ct x ct product)."""
        return float(np.dot(a, b))

    @staticmethod
    def manhattan(a, b) -> float:
        """1 - L1/2d, additions only."""
        return 1.0 - float(np.abs(a - b).sum()) / (2 * len(a))

    @staticmethod
    def chebyshev(a, b) -> float:
        """1 - max |a_i - b_i| (max is a comparator tree under FHE)."""
        return 1.0 - float(np.abs(a - b).max())

    @staticmethod
    def hamming_sign(a, b) -> float:
        """Fraction of coordinates with matching sign."""
        return float((np.sign(a) == np.sign(b)).mean())

    @staticmethod
    def polynomial(a, b, degree: int = 2) -> float:
        """((1 + a.b)/2)^degree: multiplications only."""
        return float(((1.0 + np.dot(a, b)) / 2.0) ** degree)

    @staticmethod
    def approx_cosine(a, b) -> float:
        """Taylor-corrected dot product, no division: for near-unit vectors
        cos ~= a.b * (1.5 - 0.5*|a|^2*|b|^2) (first-order inverse sqrt)."""
        d = float(np.dot(a, b))
        na2, nb2 = float(np.dot(a, a)), float(np.dot(b, b))
        return d * (1.5 - 0.5 * na2 * nb2)


def benchmark(n_pairs: int = 500, dim: int = 128, seed: int = 42,
              out_path: Optional[str] = "similarity_metrics_comparison.json"
              ) -> Dict[str, float]:
    """Pearson correlation of each metric with exact cosine (seed-42 data)."""
    rng = np.random.default_rng(seed)
    e1 = rng.standard_normal((n_pairs, dim))
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    mix = rng.random((n_pairs, 1))
    e2 = mix * e1 + (1 - mix) * rng.standard_normal((n_pairs, dim))
    e2 /= np.linalg.norm(e2, axis=1, keepdims=True)

    fns = {"dot": FHEFriendlySimilarity.dot,
           "manhattan": FHEFriendlySimilarity.manhattan,
           "chebyshev": FHEFriendlySimilarity.chebyshev,
           "hamming_sign": FHEFriendlySimilarity.hamming_sign,
           "polynomial": FHEFriendlySimilarity.polynomial,
           "approx_cosine": FHEFriendlySimilarity.approx_cosine}
    cos = np.asarray([FHEFriendlySimilarity.cosine(a, b) for a, b in zip(e1, e2)])
    corr = {}
    for name, fn in fns.items():
        vals = np.asarray([fn(a, b) for a, b in zip(e1, e2)])
        corr[name] = float(np.corrcoef(cos, vals)[0, 1])
        logger.info("%s: corr=%.4f", name, corr[name])
    if out_path:
        Path(out_path).write_text(json.dumps(corr, indent=2))
    return corr


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(benchmark(), indent=2))
