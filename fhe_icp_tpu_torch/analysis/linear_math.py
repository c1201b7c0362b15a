"""Why the similarity model uses product features: proof by experiment.

A linear model on CONCATENATED embeddings [a, b] cannot represent cosine
similarity (a linear function cannot multiply features), while the same
model on ELEMENT-WISE PRODUCTS a*b learns it exactly (it only has to sum).
This pins the design of `FHESimilarityModel` (features a*b,
`models/similarity.py`).  numpy only, the JAX package's numbers.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

logger = logging.getLogger(__name__)


def _fit_r2(x: np.ndarray, y: np.ndarray) -> float:
    a = np.hstack([x, np.ones((len(x), 1))])
    sol, *_ = np.linalg.lstsq(a, y, rcond=None)
    pred = a @ sol
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return 1.0 - ss_res / ss_tot if ss_tot else 1.0


def analyze_linear_relationship(n_samples: int = 2000, dim: int = 32,
                                seed: int = 42) -> Dict[str, float]:
    """R² of linear regression on concatenated against product features.

    Expected: concat R² ~ 0 (impossible), product R² = 1 (exact).
    """
    rng = np.random.default_rng(seed)
    e1 = rng.standard_normal((n_samples, dim))
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = rng.standard_normal((n_samples, dim))
    e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
    y = (e1 * e2).sum(axis=1)                      # cosine of unit vectors

    r2 = {"concat": _fit_r2(np.hstack([e1, e2]), y),
          "product": _fit_r2(e1 * e2, y)}
    logger.info("linear R² — concat: %.4f, product: %.4f", r2["concat"], r2["product"])
    return r2


def probe_identities(dim: int = 8) -> Dict[str, float]:
    """Algebraic probes a linear-on-products model must reproduce:
    identical -> 1.0, orthogonal -> 0.0, opposite -> -1.0."""
    e = np.zeros(dim)
    e[0] = 1.0
    f = np.zeros(dim)
    f[1] = 1.0
    return {"identical": float((e * e).sum()),
            "orthogonal": float((e * f).sum()),
            "opposite": float((e * -e).sum())}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    r2 = analyze_linear_relationship()
    probes = probe_identities()
    print("R²:", r2)
    print("probes:", probes)
    if not (r2["product"] > 0.99 > r2["concat"] + 0.9):
        raise SystemExit(f"unexpected R²: {r2}")
    print("conclusion: linear models need product features — concat cannot express cosine")
