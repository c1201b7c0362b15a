"""Seeded generators of the benchmark's inputs, read by every driver.

A traffic mix is a JSON file beside this one (`traffic/<name>.json`,
read by the harness), which names its driver; the driver passes its
parameters to these functions.  Every stream of inputs has a seed of its
own, derived from the run's `--seed` and the stream's name, so one seed
gives the same inputs in every run, and two streams never share draws.
Seeds of any size are taken (`np.random.SeedSequence`).
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of the run with `--seed seed`."""
    tag = int.from_bytes(hashlib.sha256(stream.encode()).digest()[:8], "little")
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), tag]).generate_state(2)
    return (int(state[0]) | int(state[1]) << 32) >> 1


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def torch_generator(seed: int, stream: str, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def quantized_unit(gen: torch.Generator, shape: Sequence[int], scale: float,
                   device: torch.device) -> torch.Tensor:
    """L2-normalized Gaussian vectors at `scale`, rounded to int32 (the store's
    quantization contract), drawn on `device` in one call."""
    v = torch.randn(tuple(shape), generator=gen, dtype=torch.float64, device=device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.round(v * scale).to(torch.int32)


def pairs(rng: np.random.Generator, pool: int, count: int) -> np.ndarray:
    """(count, 2) int64 pairs (i, j) drawn uniformly from range(pool)."""
    return rng.integers(0, pool, size=(count, 2))
