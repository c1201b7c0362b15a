"""Vector <-> polynomial encodings for encrypted dot products.

    A(X) = sum_i a_i X^i          (ascending encoding)
    B(X) = sum_i b_i X^(d-1-i)    (reversed encoding)
    =>  coefficient d-1 of A*B mod (X^N+1)  =  sum_i a_i b_i

since every contributing index pair satisfies i + (d-1-i) = d-1 < N.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def encode_fwd(vec: torch.Tensor, n: int) -> torch.Tensor:
    """(..., d) int -> (..., N) int32 poly with a_i at X^i."""
    d = vec.shape[-1]
    assert d <= n
    return F.pad(vec.to(torch.int32), (0, n - d))


def encode_rev(vec: torch.Tensor, n: int) -> torch.Tensor:
    """(..., d) int -> (..., N) int32 poly with b_i at X^(d-1-i)."""
    return encode_fwd(torch.flip(vec.to(torch.int32), dims=(-1,)), n)


def extract_dot(poly: torch.Tensor, d: int) -> torch.Tensor:
    """Read the inner product from coefficient d-1 of the product poly."""
    return poly[..., d - 1]
