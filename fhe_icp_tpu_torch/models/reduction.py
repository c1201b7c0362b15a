"""Dimension reduction 768 -> 128: PCA / truncated SVD by `torch.linalg.svd`
on the reducer's device, or a seeded Gaussian random projection.

Explained-variance and similarity-preservation metrics, and npz
persistence in the JAX package's `reducer.npz` layout (`target_dim`,
`method`, `random_state`, `mean`, `components`, `evr`): a persisted
reducer transforms identically in both packages.  A fresh "random" fit
cannot replay `jax.random.normal`; it draws from a CPU `torch.Generator`
seeded with `random_state`, so it is the same on every device but differs
from the JAX package's.  A store reloads its persisted reducer, so fits
never have to agree across packages.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..devices import target

logger = logging.getLogger(__name__)


class DimensionReducer:
    def __init__(self, target_dim: int = 128, method: str = "pca",
                 random_state: int = 42, device: torch.device | str = "cuda"):
        if method not in ("pca", "svd", "random"):
            raise ValueError(f"unknown method {method!r}")
        self.device = target(device, "DimensionReducer")
        self.target_dim = target_dim
        self.method = method
        self.random_state = random_state
        self.mean_: Optional[np.ndarray] = None
        self.components_: Optional[np.ndarray] = None   # (in_dim, target_dim)
        self.explained_variance_ratio_: Optional[np.ndarray] = None
        self.fitted = False

    def fit(self, x: np.ndarray) -> "DimensionReducer":
        x = torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)
        k = self.target_dim
        if self.method == "random":
            gen = torch.Generator().manual_seed(self.random_state)
            w = torch.randn((x.shape[1], k), generator=gen) / np.sqrt(k)
            self.mean_ = np.zeros(x.shape[1], dtype=np.float32)
            self.components_ = w.numpy().astype(np.float32)
            self.explained_variance_ratio_ = None
        else:
            mean = x.mean(dim=0) if self.method == "pca" else torch.zeros_like(x[0])
            # Economy SVD; components = the top-k right singular vectors.
            _, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
            self.mean_ = mean.cpu().numpy().astype(np.float32)
            self.components_ = vt[:k].T.cpu().numpy().astype(np.float32)
            var = s.cpu().numpy() ** 2
            self.explained_variance_ratio_ = (var[:k] / var.sum()).astype(np.float32)
        self.fitted = True
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        if not self.fitted:
            raise RuntimeError("reducer not fitted")
        x = np.atleast_2d(np.asarray(x, dtype=np.float32))
        out = (x - self.mean_) @ self.components_
        return out.astype(np.float32)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    # -- metrics -----------------------------------------------------------
    def similarity_preservation(self, x: np.ndarray, n_pairs: int = 200) -> float:
        """Correlation between original and reduced cosine similarities."""
        rng = np.random.default_rng(self.random_state)
        x = np.asarray(x, dtype=np.float32)
        r = self.transform(x)

        def cos(m):
            n = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-9)
            return n @ n.T

        c_full, c_red = cos(x), cos(r)
        idx = np.triu_indices(len(x), k=1)
        if len(idx[0]) > n_pairs:
            sel = rng.choice(len(idx[0]), n_pairs, replace=False)
            idx = (idx[0][sel], idx[1][sel])
        return float(np.corrcoef(c_full[idx], c_red[idx])[0, 1])

    def reconstruction_error(self, x: np.ndarray) -> float:
        if self.method == "random":
            return float("nan")
        x = np.asarray(x, dtype=np.float32)
        r = self.transform(x)
        back = r @ self.components_.T + self.mean_
        return float(np.mean((x - back) ** 2))

    # -- persistence -------------------------------------------------------
    def save(self, path) -> None:
        np.savez(
            path,
            target_dim=self.target_dim,
            method=self.method,
            random_state=self.random_state,
            mean=self.mean_,
            components=self.components_,
            evr=(self.explained_variance_ratio_
                 if self.explained_variance_ratio_ is not None else np.zeros(0)),
        )

    @classmethod
    def load(cls, path, device: torch.device | str = "cuda") -> "DimensionReducer":
        z = np.load(path, allow_pickle=False)
        r = cls(int(z["target_dim"]), str(z["method"]), int(z["random_state"]), device)
        r.mean_ = z["mean"]
        r.components_ = z["components"]
        evr = z["evr"]
        r.explained_variance_ratio_ = evr if evr.size else None
        r.fitted = True
        return r
