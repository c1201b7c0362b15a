"""Integer quantization contracts for FHE evaluation (numpy only).

`prepare_embedding_for_fhe` is the store's contract: L2-normalize,
multiply by scale (default 1000), round to int32, and record
min/max/norm metadata.  This is the integer encoding the ciphertext
pipeline consumes.

`SymmetricQuantizer` is the n_bits-style symmetric quantizer of the
similarity model (n_bits=8 by default).

The port's own copy of the JAX package's `utils/quantize.py`, with the
same results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

DEFAULT_SCALE = 1000


def prepare_embedding_for_fhe(embedding: np.ndarray,
                              scale: int = DEFAULT_SCALE
                              ) -> Tuple[np.ndarray, Dict]:
    """Normalize + scale + round to int32, with metadata."""
    emb = np.asarray(embedding, dtype=np.float64).ravel()
    norm = float(np.linalg.norm(emb))
    normalized = emb / norm if norm > 0 else emb
    quantized = np.round(normalized * scale).astype(np.int32)
    meta = {
        "scale": scale,
        "original_norm": norm,
        "original_min": float(emb.min()) if emb.size else 0.0,
        "original_max": float(emb.max()) if emb.size else 0.0,
        "quantized_min": int(quantized.min()) if emb.size else 0,
        "quantized_max": int(quantized.max()) if emb.size else 0,
        "dim": int(emb.size),
    }
    return quantized, meta


def dequantize_score(score_int: int, scale: int = DEFAULT_SCALE) -> float:
    """Inner product of two scale-quantized unit vectors -> cosine value."""
    return float(score_int) / (scale * scale)


@dataclass
class SymmetricQuantizer:
    """Symmetric per-tensor quantizer: x_q = round(x / step), |x_q| < 2^(b-1)."""

    n_bits: int = 8
    step: float = 1.0
    calibrated: bool = False

    def calibrate(self, x: np.ndarray) -> "SymmetricQuantizer":
        qmax = (1 << (self.n_bits - 1)) - 1
        amax = float(np.max(np.abs(x))) if np.asarray(x).size else 1.0
        self.step = (amax / qmax) if amax > 0 else 1.0
        self.calibrated = True
        return self

    def quantize(self, x: np.ndarray) -> np.ndarray:
        qmax = (1 << (self.n_bits - 1)) - 1
        q = np.round(np.asarray(x, dtype=np.float64) / self.step)
        return np.clip(q, -qmax - 1, qmax).astype(np.int32)

    def dequantize(self, q: np.ndarray) -> np.ndarray:
        return np.asarray(q, dtype=np.float64) * self.step

    def state(self) -> Dict:
        return {"n_bits": self.n_bits, "step": self.step,
                "calibrated": self.calibrated}

    @classmethod
    def from_state(cls, s: Dict) -> "SymmetricQuantizer":
        return cls(n_bits=int(s["n_bits"]), step=float(s["step"]),
                   calibrated=bool(s["calibrated"]))
