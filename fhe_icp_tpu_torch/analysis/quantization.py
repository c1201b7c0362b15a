"""Quantization sweep: accuracy, circuit width and encrypted latency.

For each n_bits in {4, 8, 12}, fit the similarity model on the seed-42
dataset of 500 embedding pairs (dim 128), then measure R², compile time,
the worst-case accumulator ("circuit") bit width, a timed encrypted
prediction on `device` (the card by default) and the clear-vs-encrypted
mean absolute error over 5 samples; results go to
`quantization_results.json`.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.similarity import FHESimilarityModel

logger = logging.getLogger(__name__)


def create_similarity_dataset(n_samples: int = 500, dim: int = 128, seed: int = 42):
    """Seed-42 pairs of normalized embeddings: element-wise product features
    and their cosine targets."""
    rng = np.random.default_rng(seed)
    e1 = rng.standard_normal((n_samples, dim))
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    mix = rng.random((n_samples, 1))
    e2 = mix * e1 + (1 - mix) * rng.standard_normal((n_samples, dim))
    e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
    x = e1 * e2
    return x, x.sum(axis=1)


class QuantizationTester:
    def __init__(self, dim: int = 128, preset: str = "pairwise-4096",
                 n_fhe_samples: int = 5, device: torch.device | str = "cuda"):
        self.dim = dim
        self.preset = preset
        self.n_fhe_samples = n_fhe_samples
        self.device = device
        self.results: List[Dict] = []

    def test_bit_width(self, n_bits: int, runtime=None) -> Dict:
        x, _ = create_similarity_dataset(dim=self.dim)
        model = FHESimilarityModel(input_dim=self.dim, n_bits=n_bits, preset=self.preset)
        train_metrics = model.train()
        t0 = time.time()
        model.compile(x_sample=x, runtime=runtime, device=self.device)
        compile_time = time.time() - t0

        xs = x[: self.n_fhe_samples]
        clear = model.predict_clear(xs)
        t0 = time.time()
        fhe = model.predict_encrypted(xs)
        fhe_time = (time.time() - t0) / len(xs)
        result = {"n_bits": n_bits, "r2": train_metrics["r2"],
                  "compile_time_s": compile_time,
                  "circuit_max_bits": model.metrics["circuit_max_bits"],
                  "fhe_prediction_time_s": fhe_time,
                  "clear_vs_fhe_mae": float(np.mean(np.abs(clear - np.asarray(fhe))))}
        self.results.append(result)
        logger.info("n_bits=%d: r2=%.4f circuit=%d bits fhe=%.4fs mae=%.6f", n_bits,
                    result["r2"], result["circuit_max_bits"], fhe_time,
                    result["clear_vs_fhe_mae"])
        return result

    def run_sweep(self, bit_widths=(4, 8, 12), runtime=None,
                  out_path: Optional[str] = "quantization_results.json") -> List[Dict]:
        for b in bit_widths:
            self.test_bit_width(b, runtime=runtime)
        if out_path:
            Path(out_path).write_text(json.dumps(self.results, indent=2))
        return self.results


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(QuantizationTester().run_sweep(), indent=2))


if __name__ == "__main__":
    main()
