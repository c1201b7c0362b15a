"""fastdot's int8 digit product: CUDA kernel wrapper and its plain version.

    part[l, i, b, j] = sum_k docs[l, i, b, k] * query[l, j, k]

over the (L, 4, B, 2N) int8 digit planes of a `fastdot.DocOperand` and the
(L, 4, 2N) int8 digit planes of a `fastdot.QueryOperand`: the (L, 4, B, 4)
int32 partials that `fastdot.fold_decode` folds mod p.  Every partial is
bounded by 128*128*2N < 2^31, so both versions are exact and give the same
integers.

Replaces no Pallas kernel: the JAX package's `ops/fastdot.py` leaves this
product to XLA.  The kernel (`csrc/fastdot.cu`) streams the document digits
once through TMA into the int8 tensor cores, bound by device memory; its
note gives the design.  `digit_products` launches it for CUDA tensors and
runs the plain version `digit_products_ref` (an integer matmul,
`pack_cuda.int_matmul_ref`) for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from .fastdot import N_DIGITS
from .pack_cuda import K_TILE, int_matmul_ref


def _check(a: torch.Tensor, q: torch.Tensor) -> tuple:
    """(L, B, 2N) of valid operands; raises on what the kernel does not take."""
    if a.dtype != torch.int8 or q.dtype != torch.int8:
        raise TypeError(f"fastdot digit planes must be int8, got {a.dtype}, {q.dtype}")
    if a.dim() != 4 or q.dim() != 3:
        raise ValueError(f"digit planes must be (L, 4, B, 2N) and (L, 4, 2N), got "
                         f"{tuple(a.shape)}, {tuple(q.shape)}")
    l, nd, b, k = a.shape
    if nd != N_DIGITS or tuple(q.shape) != (l, N_DIGITS, k):
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(q.shape)} do not chain")
    if k == 0 or k % K_TILE:
        raise ValueError(f"2N must be a positive multiple of {K_TILE}, got {k}")
    if a.device != q.device:
        raise ValueError(f"operands on {a.device} and {q.device}")
    return l, b, k


def digit_products_ref(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version: one exact integer matmul a limb."""
    l, b, k = _check(a, q)
    part = int_matmul_ref(a.reshape(l, N_DIGITS * b, k), q.transpose(1, 2))
    return part.reshape(l, N_DIGITS, b, N_DIGITS)


def _launch(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    l, b, k = _check(a, q)
    if a.device.type != "cuda":
        raise ValueError(f"the fastdot kernel needs CUDA tensors, got {a.device}")
    if not (a.is_contiguous() and q.is_contiguous()):
        raise ValueError("fastdot digit planes must be contiguous")
    if a.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("fastdot digit planes must start on 16 bytes")
    part = torch.empty((l, N_DIGITS, b, N_DIGITS), dtype=torch.int32, device=a.device)
    if b == 0:
        return part
    fn = kernels.load().fhe_fastdot_product
    with kernels.launch_on(a.device) as stream:
        err = fn(a.data_ptr(), q.data_ptr(), part.data_ptr(), l, b, k, stream)
    kernels.check(err, "fastdot_product")
    kernels.launches["fastdot_product"] += 1
    return part


def digit_products(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(L, 4, B, 2N) x (L, 4, 2N) int8 digit planes -> (L, 4, B, 4) int32 partials.

    Both int8, on one device, 2N a multiple of 128; on the card also
    contiguous and starting on 16 bytes.  The launch does not wait for the
    card, so the shards of a sharded search run their products at once.
    """
    if a.device.type == "cpu":
        return digit_products_ref(a, q)
    return _launch(a, q)
