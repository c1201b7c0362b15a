"""The hybrid keyswitch's digit-key inner product: CUDA kernel wrapper and its plain version.

    acc[b, c, i, x] = sum_j mont_mul(d[b, j, i, x], ksk[j, c, i, x]) mod p_i

over the digits d (B, n_dig, L, N) and the Montgomery key ksk (n_dig, 2, L,
N) of `arith.hybrid_keyswitch_apply`, L = l + 1 limbs of the extended chain;
the result (B, 2, L, N) is what `arith._div_special` takes.  It serves every
regime of the keyswitch: full-limb digits (n_dig = l) at any batch and
16-bit sub-digits (n_dig = 2l).

Replaces no Pallas kernel: the JAX package leaves this loop to XLA's
fusion.  The kernel (`csrc/keyswitch.cu`) is bound by bytes, each digit and
key word read once and each result word written once; its note gives the
design.  `inner_product` launches it for CUDA tensors and runs the plain
version `inner_product_ref` (the digit loop of `modmath.mont_mul` and
`add_mod` in int64) for CPU tensors; both give the same integers.
"""

from __future__ import annotations

import torch

from .. import kernels
from .modmath import add_mod, mont_mul


def _check(d: torch.Tensor, ksk: torch.Tensor, p: torch.Tensor,
           p_neg_inv: torch.Tensor) -> tuple:
    """(B, n_dig, L, N) of valid operands; raises on what the kernel does not take."""
    named = (("digits", d), ("key", ksk), ("primes", p), ("p_neg_inv", p_neg_inv))
    for name, x in named:
        if x.dtype != torch.uint32:
            raise TypeError(f"keyswitch inner product: {name} must be uint32, got {x.dtype}")
    if d.dim() != 4:
        raise ValueError(f"digits must be (B, n_dig, L, N), got {tuple(d.shape)}")
    b, n_dig, limbs, n = d.shape
    if tuple(ksk.shape) != (n_dig, 2, limbs, n):
        raise ValueError(f"key must be {(n_dig, 2, limbs, n)} for digits {tuple(d.shape)}, "
                         f"got {tuple(ksk.shape)}")
    if p.numel() != limbs or p_neg_inv.numel() != limbs:
        raise ValueError(f"{limbs} limbs but {p.numel()} primes and {p_neg_inv.numel()} "
                         "Montgomery constants")
    devices = {x.device for _, x in named}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"keyswitch inner product: {name} must be contiguous")
    return b, n_dig, limbs, n


def inner_product_ref(d: torch.Tensor, ksk: torch.Tensor, p: torch.Tensor,
                      p_neg_inv: torch.Tensor) -> torch.Tensor:
    """Plain version: the digit loop of Montgomery products and modular sums."""
    _, n_dig, limbs, _ = _check(d, ksk, p, p_neg_inv)
    p, p_neg_inv = p.reshape(limbs, 1), p_neg_inv.reshape(limbs, 1)
    acc0 = acc1 = None
    for j in range(n_dig):
        t0 = mont_mul(d[:, j], ksk[j, 0], p, p_neg_inv)
        t1 = mont_mul(d[:, j], ksk[j, 1], p, p_neg_inv)
        acc0 = t0 if acc0 is None else add_mod(acc0, t0, p)
        acc1 = t1 if acc1 is None else add_mod(acc1, t1, p)
    return torch.stack([acc0, acc1], dim=-3)


def _launch(d: torch.Tensor, ksk: torch.Tensor, p: torch.Tensor,
            p_neg_inv: torch.Tensor) -> torch.Tensor:
    b, n_dig, limbs, n = _check(d, ksk, p, p_neg_inv)
    if d.device.type != "cuda":
        raise ValueError(f"the keyswitch kernel needs CUDA tensors, got {d.device}")
    acc = torch.empty((b, 2, limbs, n), dtype=torch.uint32, device=d.device)
    if b == 0:
        return acc
    fn = kernels.load().fhe_keyswitch_inner
    with kernels.launch_on(d.device) as stream:
        err = fn(d.data_ptr(), ksk.data_ptr(), p.data_ptr(), p_neg_inv.data_ptr(),
                 acc.data_ptr(), b, n_dig, limbs, n, stream)
    kernels.check(err, "keyswitch_inner")
    kernels.launches["keyswitch_inner"] += 1
    return acc


def inner_product(d: torch.Tensor, ksk: torch.Tensor, p: torch.Tensor,
                  p_neg_inv: torch.Tensor) -> torch.Tensor:
    """(B, n_dig, L, N) digits x (n_dig, 2, L, N) key -> (B, 2, L, N) canonical sums.

    p, p_neg_inv: the extended chain's L primes and Montgomery constants
    (the (L, 1) columns of `HybridTables`).  Every operand uint32,
    contiguous, on one device; on the card the digits and the key also
    start on 16 bytes (the kernel moves 16-byte vectors; its C entry
    refuses others).
    """
    if d.device.type == "cpu":
        return inner_product_ref(d, ksk, p, p_neg_inv)
    return _launch(d, ksk, p, p_neg_inv)
