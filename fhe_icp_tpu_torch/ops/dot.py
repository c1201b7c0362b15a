"""Encrypted dot products against clear vectors, and their decode.

* `dot_ct_pt`    — encrypted vector . clear vector (one NTT-domain product);
* `matvec_ct_pt` — a batch of encrypted documents against one clear query:
  the query is NTT-prepared once and broadcast over the batch;
* `decrypt_dot`  — decrypts only coefficient d-1, which carries the inner
  product (`encoding`), through the single-coefficient decode.

The counterparts of the JAX package's `ops/dot.py`, with the same integers.
"""

from __future__ import annotations

import torch

from . import arith
from .cipher import Ciphertext, SecretKey, decrypt_coeff
from .context import CryptoContext
from .encoding import encode_rev


def dot_ct_pt(ctx: CryptoContext, ct_a: Ciphertext, b_clear: torch.Tensor) -> Ciphertext:
    """Ciphertext holding sum_i a_i b_i at coefficient d-1.

    ct_a: encryption of encode_fwd(a); b_clear: (..., d) int32.
    """
    pt = arith.plain_to_eval(ctx, encode_rev(b_clear.to(ctx.device), ctx.n), ct_a.level)
    return arith.mul_plain(ctx, ct_a, pt)


def matvec_ct_pt(ctx: CryptoContext, cts: Ciphertext, query_clear: torch.Tensor) -> Ciphertext:
    """cts.data (B, k, L, N) encrypted docs x one clear (d,) int32 query."""
    pt = arith.plain_to_eval(ctx, encode_rev(query_clear.to(ctx.device), ctx.n), cts.level)
    return arith.mul_plain(ctx, cts, pt)


def decrypt_dot(ctx: CryptoContext, sk: SecretKey, ct: Ciphertext, d: int) -> torch.Tensor:
    """Decrypt only the inner-product coefficient d-1 -> (...,) int32."""
    return decrypt_coeff(ctx, sk, ct, d - 1)
