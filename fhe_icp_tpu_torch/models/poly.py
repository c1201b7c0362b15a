"""FHEPolynomialSimilarity: degree-2 polynomial-kernel similarity fully
under encryption, the second model family.

    S   = <a, b>                (slotwise ct x ct + relinearize + prefix
                                 rotate-and-sum, ops/galois.py)
    out = (scale^2 + S)^2       (a plaintext shift, then a second ct x ct)

Coefficient packing (the linear model's encoding) does not survive a
second multiplication, so this family uses SIMD slot packing, where
squaring is slotwise and slot 0 stays clean.  Compiling picks that
encoding, checks the value range ((2*scale^2)^2 must fit t/2, which
prices the quantization scale) and that the preset's RNS chain has room
for depth 2 plus log2(d) rotations.

Dequantization: cos ~ S/scale^2, so sim = (scale^2 + S)^2 / (2*scale^2)^2.
The encrypted integer result equals the quantized-clear simulation
exactly, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import arith, galois
from ..ops.runtime import FheRuntime

logger = logging.getLogger(__name__)


class FHEPolynomialSimilarity:
    """sim(a, b) = ((1 + cos(a, b)) / 2) ** degree, degree fixed at 2.

    Higher degrees are rejected at construction: the result range
    (2*scale^2)^degree must fit the plaintext modulus, and at degree 3 the
    affordable scale (~20 at t ~ 2^30) quantizes cosine to ~0.25.  Degree
    2 at scale <= 104 fits t = T_MODULUS at full scale-90 precision.
    """

    def __init__(self, input_dim: int = 128, degree: int = 2,
                 preset: str = "mult-8192", scale: int = 90):
        if degree != 2:
            raise ValueError(
                "only degree=2 is supported: (2*scale^2)^degree must fit "
                "t/2 and degree>=3 forces scale<=20 (~0.25 cosine "
                "granularity); see module docstring")
        if input_dim & (input_dim - 1):
            raise ValueError("input_dim must be a power of two "
                             "(prefix rotate-and-sum)")
        self.input_dim = input_dim
        self.degree = degree
        self.preset = preset
        self.scale = scale
        self.runtime: Optional[FheRuntime] = None
        self.metrics: Dict = {}

    # -- compile: encoding choice + range/noise verification ---------------
    def compile(self, runtime: Optional[FheRuntime] = None,
                key_seed: int = 0, rotation_key_seed: int = 1,
                device: torch.device | str = "cuda") -> Dict:
        """Check range and depth, and make rotation keys, on `runtime` or a
        new FheRuntime on `device` (the card by default)."""
        t0 = time.time()
        self.runtime = runtime or FheRuntime(self.preset, device=device)
        if self.runtime.keys is None:
            self.runtime.generate_keys(seed=key_seed)
        ctx = self.runtime.ctx
        if self.input_dim > ctx.n // 2:
            raise ValueError(f"input_dim {self.input_dim} exceeds slot row "
                             f"length {ctx.n // 2}")
        # Value range: the final integer is (scale^2 + S)^2 with
        # |S| <= scale^2 (Cauchy-Schwarz on unit vectors), so the circuit's
        # max value is (2*scale^2)^2; every intermediate slot value is
        # bounded by it too (prefix windows are sub-sums).
        vmax = (2 * self.scale ** 2) ** 2
        self.metrics["circuit_max_bits"] = int(vmax).bit_length()
        if vmax >= ctx.t // 2:
            raise ValueError(
                f"(2*scale^2)^2 = {vmax} exceeds t/2 = {ctx.t // 2} for "
                f"preset {ctx.params.name}; lower scale to "
                f"<= {int((ctx.t // 2) ** 0.25 / np.sqrt(2))}")
        # Depth: 2 multiplications + log2(d) rotations need 5 RNS limbs at
        # t ~ 2^30 (at N=512, 3 limbs decrypt garbage and 4 are one bit
        # short); mult-8192 carries 6.
        if ctx.n_limbs < 5:
            raise ValueError(
                f"preset {ctx.params.name} has {ctx.n_limbs} limbs; the "
                f"depth-2 polynomial circuit needs >= 5 (use mult-8192)")
        # Coarse full-limb rotation digits: every >=5-limb chain has orders
        # of magnitude more budget than the circuit consumes.
        self.runtime.rotation_keys(seed=rotation_key_seed, digit_bits=0)
        self.metrics["compile_time"] = time.time() - t0
        self.metrics["rotations"] = int(np.log2(self.input_dim))
        return {"compile_time": self.metrics["compile_time"],
                "circuit_max_bits": self.metrics["circuit_max_bits"]}

    # -- quantization ------------------------------------------------------
    def _quantize(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, dtype=np.float64).ravel()
        n = np.linalg.norm(v)
        return np.round((v / n if n > 0 else v) * self.scale).astype(np.int32)

    def _dequantize(self, v_int: int) -> float:
        return float(v_int) / float((2 * self.scale ** 2) ** 2)

    # -- prediction paths --------------------------------------------------
    def predict_clear(self, a: np.ndarray, b: np.ndarray) -> float:
        a = np.asarray(a, np.float64).ravel()
        b = np.asarray(b, np.float64).ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        return ((1.0 + cos) / 2.0) ** self.degree

    def predict_quantized_clear(self, a: np.ndarray, b: np.ndarray) -> float:
        """Integer-exact simulation of the encrypted circuit."""
        qa = self._quantize(a).astype(np.int64)
        qb = self._quantize(b).astype(np.int64)
        s = int(qa @ qb)
        return self._dequantize((self.scale ** 2 + s) ** 2)

    def predict_encrypted(self, a: np.ndarray, b: np.ndarray,
                          seed: Optional[int] = None) -> float:
        """Full homomorphic evaluation; bit-exact vs quantized-clear."""
        if self.runtime is None:
            raise RuntimeError("compile() before predict_encrypted()")
        rt = self.runtime
        ctx = rt.ctx
        d, half = self.input_dim, ctx.n // 2
        qa, qb = self._quantize(a), self._quantize(b)
        va = np.zeros((2, half), np.int32)
        vb = np.zeros((2, half), np.int32)
        va[0, :d], vb[0, :d] = qa, qb
        t0 = time.time()
        ct_a = rt.encrypt_slots(va, seed=seed)
        ct_b = rt.encrypt_slots(vb, seed=None if seed is None else seed + 1)
        prod = rt.mul_ct(ct_a, ct_b)                 # slotwise, relinearized
        gk = rt._gkeys_for_level(prod.level)
        summed = galois.sum_slots_prefix(ctx, gk, prod, d)
        const = np.zeros((2, half), np.int32)
        const[0, 0] = self.scale ** 2
        pt = galois.encode_slots(ctx, torch.as_tensor(const, device=rt.device))
        shifted = arith.add_plain(ctx, summed, pt)
        sq = rt.mul_ct(shifted, shifted)             # second ct x ct
        v = int(rt.decrypt_slots(sq)[0, 0])
        self.metrics["fhe_prediction_time"] = time.time() - t0
        return self._dequantize(v)

    # -- persistence -------------------------------------------------------
    def save(self, path) -> None:
        Path(path).with_suffix(".json").write_text(json.dumps({
            "family": "polynomial", "input_dim": self.input_dim,
            "degree": self.degree, "preset": self.preset,
            "scale": self.scale, "metrics": self.metrics}, indent=2))

    @classmethod
    def load(cls, path, runtime: Optional[FheRuntime] = None
             ) -> "FHEPolynomialSimilarity":
        cfg = json.loads(Path(path).with_suffix(".json").read_text())
        m = cls(cfg["input_dim"], cfg["degree"], cfg["preset"], cfg["scale"])
        m.metrics = cfg.get("metrics", {})
        if runtime is not None:
            m.runtime = runtime
        return m
