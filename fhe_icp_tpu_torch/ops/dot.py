"""Encrypted dot products, and their decode.

* `dot_ct_pt`      — encrypted vector . clear vector (one NTT-domain product);
* `dot_ct_ct`      — encrypted . encrypted (tensor product + relinearize);
* `dot_ct_ct_deg2` — the same without relinearization: a degree-2 result
  that decrypts to the same score (the CLI `compare` path);
* `matvec_ct_pt`   — a batch of encrypted documents against one clear query:
  the query is NTT-prepared once and broadcast over the batch;
* `decrypt_dot`    — decrypts only coefficient d-1, which carries the inner
  product (`encoding`), through the single-coefficient decode.

The counterparts of the JAX package's `ops/dot.py`, with the same integers.
"""

from __future__ import annotations

import torch

from . import arith
from .cipher import Ciphertext, SecretKey, decrypt_coeff, encrypt_sym
from .context import CryptoContext
from .encoding import encode_fwd, encode_rev


def encrypt_vector(ctx: CryptoContext, sk: SecretKey, gen: torch.Generator,
                   vec: torch.Tensor) -> Ciphertext:
    """Encrypt (..., d) int32 vectors in the ascending coefficient encoding."""
    return encrypt_sym(ctx, sk, gen, encode_fwd(vec.to(ctx.device), ctx.n))


def encrypt_vector_rev(ctx: CryptoContext, sk: SecretKey, gen: torch.Generator,
                       vec: torch.Tensor) -> Ciphertext:
    """Encrypt in the reversed encoding (right operand of a ct x ct dot)."""
    return encrypt_sym(ctx, sk, gen, encode_rev(vec.to(ctx.device), ctx.n))


def dot_ct_pt(ctx: CryptoContext, ct_a: Ciphertext, b_clear: torch.Tensor) -> Ciphertext:
    """Ciphertext holding sum_i a_i b_i at coefficient d-1.

    ct_a: encryption of encode_fwd(a); b_clear: (..., d) int32.
    """
    pt = arith.plain_to_eval(ctx, encode_rev(b_clear.to(ctx.device), ctx.n), ct_a.level)
    return arith.mul_plain(ctx, ct_a, pt)


def dot_ct_ct(ctx: CryptoContext, rlk_keys, ct_a: Ciphertext,
              ct_b_rev: Ciphertext) -> Ciphertext:
    """Fully encrypted inner product: the relinearized product ciphertext."""
    return arith.relinearize(ctx, rlk_keys, arith.mul_ct(ctx, ct_a, ct_b_rev))


def dot_ct_ct_deg2(ctx: CryptoContext, ct_a: Ciphertext, ct_b_rev: Ciphertext) -> Ciphertext:
    """Encrypted inner product without relinearization: a degree-2 result.

    Decryption handles c2*s^2 directly (`cipher._phase`), so a consumer that
    decrypts at once gets the same score without the keyswitch.
    """
    return arith.mul_ct(ctx, ct_a, ct_b_rev)


def matvec_ct_pt(ctx: CryptoContext, cts: Ciphertext, query_clear: torch.Tensor) -> Ciphertext:
    """cts.data (B, k, L, N) encrypted docs x one clear (d,) int32 query."""
    pt = arith.plain_to_eval(ctx, encode_rev(query_clear.to(ctx.device), ctx.n), cts.level)
    return arith.mul_plain(ctx, cts, pt)


def decrypt_dot(ctx: CryptoContext, sk: SecretKey, ct: Ciphertext, d: int) -> torch.Tensor:
    """Decrypt only the inner-product coefficient d-1 -> (...,) int32."""
    return decrypt_coeff(ctx, sk, ct, d - 1)
