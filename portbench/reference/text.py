"""Plain text-to-vector reference: embedding, reduction and quantization.

* The embedding is the bag-of-words random projection the store uses
  without BERT weights: each lower-cased token [a-z0-9]+ (the first 100)
  maps to a unit Gaussian vector of 768 values drawn by NumPy's default
  generator seeded with the first 8 bytes (little-endian) of the token's
  BLAKE2b digest; a text is the float32 mean of its tokens' vectors.
* The reduction: `pca` fits the reference's own float64 PCA of the
  texts a store's reducer was fitted on, and `reducer_gaps` holds that
  reducer (mean, components) against it; `vectors` then applies the
  store's reducer in float64.  The subspace is what a reducer has to get
  right: dot products of reduced vectors are the same under any rotation
  of its components.
* The quantization is the store's contract: L2-normalize, times the
  scale, rounded.

Imports neither JAX nor any package of this repository.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List

import numpy as np

_TOKEN = re.compile(r"[a-z0-9]+")
DIM = 768
MAX_TOKENS = 100


class Embedder:
    def __init__(self):
        self._vec: Dict[str, np.ndarray] = {}

    def _token(self, tok: str) -> np.ndarray:
        v = self._vec.get(tok)
        if v is None:
            seed = int.from_bytes(hashlib.blake2b(tok.encode(), digest_size=8).digest(), "little")
            v = np.random.default_rng(seed).standard_normal(DIM)
            v = self._vec[tok] = v / np.linalg.norm(v)
        return v

    def embed(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), DIM), dtype=np.float32)
        for i, text in enumerate(texts):
            toks = _TOKEN.findall(text.lower())[:MAX_TOKENS]
            if toks:
                out[i] = np.stack([self._token(t) for t in toks]).mean(axis=0)
        return out


def quantize(reduced: np.ndarray, scale: int) -> np.ndarray:
    """Rows L2-normalized, times scale, rounded to integers."""
    r = np.asarray(reduced, dtype=np.float64)
    norm = np.linalg.norm(r, axis=-1, keepdims=True)
    return np.round(np.where(norm > 0, r / np.where(norm > 0, norm, 1), r) * scale).astype(np.int64)


def vectors(emb: np.ndarray, mean: np.ndarray, comps: np.ndarray, scale: int) -> np.ndarray:
    """Embeddings reduced by (mean, components) in float64, then quantized."""
    return quantize((np.asarray(emb, dtype=np.float64) - mean) @ comps, scale)


def to_bf16(x: np.ndarray) -> np.ndarray:
    import torch
    return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(torch.bfloat16).float().numpy()


def vectors_bf16(emb: np.ndarray, mean: np.ndarray, comps: np.ndarray, scale: int) -> np.ndarray:
    """The control's reduction, computed in bfloat16 (embeddings, mean,
    components and the product), then quantized."""
    import torch
    bf = torch.bfloat16
    x = torch.as_tensor(np.asarray(emb, dtype=np.float32)).to(bf)
    r = (x - torch.as_tensor(np.asarray(mean, dtype=np.float32)).to(bf)) @ \
        torch.as_tensor(np.asarray(comps, dtype=np.float32)).to(bf)
    return quantize(r.float().numpy(), scale)


def pca(fit_emb: np.ndarray, k: int) -> tuple:
    """The float64 PCA of the embeddings: (mean, the top-k right singular
    vectors of the centred embeddings as columns (dim, k), the singular
    values)."""
    x = np.asarray(fit_emb, dtype=np.float64)
    mu = x.mean(axis=0)
    _, s, vt = np.linalg.svd(x - mu, full_matrices=False)
    return mu, vt[:k].T, s


def pca_bf16(fit_emb: np.ndarray, k: int) -> tuple:
    """The control's reducer: the PCA of the embeddings rounded to bfloat16,
    its mean and components kept in bfloat16 (mean, components)."""
    mu, v, _ = pca(to_bf16(fit_emb), k)
    return to_bf16(mu), to_bf16(v)


def _sines(v: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Sines of the principal angles between the column spans of v and u."""
    qv, _ = np.linalg.qr(np.asarray(v, dtype=np.float64))
    qu, _ = np.linalg.qr(np.asarray(u, dtype=np.float64))
    cos = np.linalg.svd(qu.T @ qv, compute_uv=False)
    return np.sqrt(np.clip(1.0 - cos ** 2, 0.0, None))


# The reference's components whose eigenvalue stands at least this share
# above the (k+1)-th are the ones a sound fit must span: the angle of one
# that comes closer turns as the fit's rounding over the gap.
CLEAR_GAP = 0.02


def reducer_gaps(fit_emb: np.ndarray, mean: np.ndarray, comps: np.ndarray) -> dict:
    """How far a reducer (mean, components (dim, k)) is from the reference's
    float64 PCA of the embeddings it was fitted on.  Compared: the mean's
    largest gap relative to the largest mean value, and the subspace gap:
    the root mean square of the sines of the principal angles between the
    reducer's span and the span of the reference's components that stand
    clear of the (k+1)-th eigenvalue (`CLEAR_GAP`), which no sign and no
    rotation inside the span moves.  Printed beside them: how many
    components stand clear, the largest sine against the whole top-k span,
    and the components' largest departure from orthonormality."""
    v = np.asarray(comps, dtype=np.float64)
    k = v.shape[1]
    mu, u, s = pca(fit_emb, min(np.shape(fit_emb)))
    lam = s ** 2
    clear = lam[:k] >= (1.0 + CLEAR_GAP) * lam[k] if lam.size > k else np.ones(k, bool)
    clear[0] = True
    sines = _sines(v, u[:, :k][:, clear])
    return {
        "reducer_mean_gap": float(np.abs(np.asarray(mean, np.float64) - mu).max()
                                  / np.abs(mu).max()),
        "reducer_subspace_gap": float(np.sqrt(np.mean(sines ** 2))),
        "reducer_clear_components": int(clear.sum()),
        "reducer_largest_angle_sine": float(_sines(v, u[:, :k]).max()),
        "reducer_orthonormality_gap": float(np.abs(v.T @ v - np.eye(k)).max()),
    }
