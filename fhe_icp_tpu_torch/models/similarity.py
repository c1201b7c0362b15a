"""FHESimilarityModel: quantized linear similarity scoring under encryption.

* train(): synthetic pairs (half of them correlated), seeded; element-wise
  product features x = a*b, so the linear model only sums; closed-form
  least squares by numpy `lstsq` (the same `coef_` as the JAX package's).
* compile(): calibrates the n_bits quantizers and binds an FheRuntime.
* predict_encrypted(): real encrypted evaluation: quantize x, encrypt it,
  compute w.x homomorphically with one NTT-domain ct x pt product,
  decrypt the score coefficient, dequantize, add the bias.  Exactly
  `predict_quantized_clear`.
* predict_clear(): the float path, for validation.

Saved as `<path>.npz` (coef, intercept) and `<path>.json` (config and
quantizer states), the JAX package's files.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.runtime import FheRuntime
from ..utils.quantize import SymmetricQuantizer

logger = logging.getLogger(__name__)


class FHESimilarityModel:
    def __init__(self, input_dim: int = 128, n_bits: int = 8,
                 similarity_type: str = "cosine",
                 preset: str = "pairwise-4096", seed: int = 42):
        if similarity_type not in ("cosine", "dot", "manhattan"):
            raise ValueError(f"unknown similarity_type {similarity_type!r}")
        self.input_dim = input_dim
        self.n_bits = n_bits
        self.similarity_type = similarity_type
        self.preset = preset
        self.seed = seed
        self.coef_: Optional[np.ndarray] = None
        self.intercept_: float = 0.0
        self.x_quant = SymmetricQuantizer(n_bits=n_bits)
        self.w_quant = SymmetricQuantizer(n_bits=n_bits)
        self.runtime: Optional[FheRuntime] = None
        self.metrics: Dict = {}
        self._key_seed = 0

    # -- training data (seeded) ---------------------------------------------
    def _prepare_training_data(self, n_samples: int = 1000):
        rng = np.random.default_rng(self.seed)
        d = self.input_dim
        e1 = rng.standard_normal((n_samples, d))
        e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
        noise = rng.standard_normal((n_samples, d))
        # Half the pairs correlated (e2 = e1 + 0.2*noise), half independent.
        corr = e1 + 0.2 * noise
        indep = rng.standard_normal((n_samples, d))
        e2 = np.where(rng.random((n_samples, 1)) < 0.5, corr, indep)
        e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
        x = e1 * e2                       # element-wise product features
        if self.similarity_type in ("cosine", "dot"):
            y = x.sum(axis=1)             # sum of products = cosine here
        else:                             # manhattan-style target
            y = 1.0 - np.abs(e1 - e2).sum(axis=1) / (2 * d)
        return x.astype(np.float64), y.astype(np.float64)

    def train(self, n_samples: int = 1000) -> Dict:
        t0 = time.time()
        x, y = self._prepare_training_data(n_samples)
        a = np.hstack([x, np.ones((len(x), 1))])
        sol, *_ = np.linalg.lstsq(a, y, rcond=None)
        self.coef_ = sol[:-1]
        self.intercept_ = float(sol[-1])
        pred = x @ self.coef_ + self.intercept_
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        self.metrics["train_time"] = time.time() - t0
        self.metrics["r2"] = 1.0 - ss_res / ss_tot if ss_tot else 1.0
        logger.info("trained: R²=%.6f in %.2fs", self.metrics["r2"],
                    self.metrics["train_time"])
        return {"r2": self.metrics["r2"]}

    # -- "compilation": quantizer calibration + runtime binding -------------
    def compile(self, x_sample: Optional[np.ndarray] = None,
                runtime: Optional[FheRuntime] = None, key_seed: int = 0,
                device: torch.device | str = "cuda") -> Dict:
        """Calibrate and bind `runtime`, or a new FheRuntime on `device`
        (the card by default) with keys from `key_seed`."""
        if self.coef_ is None:
            raise RuntimeError("train() before compile()")
        t0 = time.time()
        if x_sample is None:
            x_sample, _ = self._prepare_training_data(64)
        self.x_quant.calibrate(x_sample)
        self.w_quant.calibrate(self.coef_)
        self.runtime = runtime or FheRuntime(self.preset, device=device)
        self._key_seed = key_seed
        if self.runtime.keys is None:
            self.runtime.generate_keys(seed=key_seed)
        # Worst-case accumulator bit width of the circuit.
        qmax = (1 << (self.n_bits - 1))
        acc = self.input_dim * qmax * qmax
        self.metrics["circuit_max_bits"] = int(np.ceil(np.log2(acc))) + 1
        self.metrics["compile_time"] = time.time() - t0
        assert acc < self.runtime.ctx.t // 2, "accumulator overflows t"
        return {"compile_time": self.metrics["compile_time"],
                "circuit_max_bits": self.metrics["circuit_max_bits"]}

    @property
    def w_int(self) -> np.ndarray:
        return self.w_quant.quantize(self.coef_)

    # -- prediction --------------------------------------------------------
    def predict_clear(self, x: np.ndarray) -> np.ndarray:
        if self.coef_ is None:
            raise RuntimeError("model not trained")
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        return x @ self.coef_ + self.intercept_

    def predict_quantized_clear(self, x: np.ndarray) -> np.ndarray:
        """Integer-exact simulation of the encrypted computation."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        xq = self.x_quant.quantize(x).astype(np.int64)
        acc = xq @ self.w_int.astype(np.int64)
        return acc * (self.x_quant.step * self.w_quant.step) + self.intercept_

    def predict_encrypted(self, x: np.ndarray,
                          seed: Optional[int] = None) -> np.ndarray:
        """Encrypt inputs, evaluate w.x homomorphically, decrypt, dequantize.

        seed=None (the default) draws fresh randomness: two calls never
        share encryption randomness."""
        if self.runtime is None:
            raise RuntimeError("compile() before predict_encrypted()")
        rt = self.runtime
        x2 = np.atleast_2d(np.asarray(x, dtype=np.float64))
        xq = self.x_quant.quantize(x2)
        t0 = time.time()
        ct = rt.encrypt_vector(xq, seed=seed)            # batched over rows
        score_ct = rt.dot_ct_pt(ct, self.w_int)
        acc = rt.decrypt_dot(score_ct, self.input_dim).cpu().numpy().astype(np.int64)
        self.metrics["fhe_prediction_time"] = time.time() - t0
        out = acc * (self.x_quant.step * self.w_quant.step) + self.intercept_
        return out if np.asarray(x).ndim > 1 else out[:1]

    # -- persistence (config + coefficients; keys are the key manager's) ----
    def save(self, path) -> None:
        path = Path(path)
        np.savez(
            path.with_suffix(".npz"),
            coef=self.coef_ if self.coef_ is not None else np.zeros(0),
            intercept=self.intercept_,
        )
        cfg = {
            "input_dim": self.input_dim, "n_bits": self.n_bits,
            "similarity_type": self.similarity_type, "preset": self.preset,
            "seed": self.seed, "x_quant": self.x_quant.state(),
            "w_quant": self.w_quant.state(), "metrics": self.metrics,
        }
        path.with_suffix(".json").write_text(json.dumps(cfg, indent=2))

    @classmethod
    def load(cls, path, runtime: Optional[FheRuntime] = None
             ) -> "FHESimilarityModel":
        path = Path(path)
        cfg = json.loads(path.with_suffix(".json").read_text())
        m = cls(cfg["input_dim"], cfg["n_bits"], cfg["similarity_type"],
                cfg["preset"], cfg["seed"])
        z = np.load(path.with_suffix(".npz"))
        m.coef_ = z["coef"] if z["coef"].size else None
        m.intercept_ = float(z["intercept"])
        m.x_quant = SymmetricQuantizer.from_state(cfg["x_quant"])
        m.w_quant = SymmetricQuantizer.from_state(cfg["w_quant"])
        m.metrics = cfg.get("metrics", {})
        if runtime is not None:
            m.runtime = runtime
        return m
