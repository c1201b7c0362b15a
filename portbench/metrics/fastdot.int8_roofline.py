"""Per cent of the fastdot int8 product's roofline: the least time of the
recorded products (their bytes or operations at the card's peaks) over the
device time of the operations that compute them.

A product is recorded as (L, M, K, C): per limb, M = 4B document digit rows
of K = 2N digits by the query's C = 4 digit columns (the real columns, not
cuBLASLt's padding).  Each input byte is read once and each output written
once: L*M*K int8 document digits, L*K*C int8 query digits, 4*L*M*C bytes of
int32 partials.  Operations: 2*L*M*K*C, two a multiply-add.

The device time is that of every operation whose name is cuBLASLt's int8
GEMM, as the card's trace prints it, or contains `fastdot`: a kernel of the
port's own with `fastdot` in its name is read as the same work.
"""

from __future__ import annotations

import re
from typing import Optional

from portbench import roofline

# cuBLASLt's integer GEMM kernels: a GEMM over 8-bit integer operands.
INT8_GEMM = re.compile(r"(?i)gemm.*(?:[is]8|imma|int8)|(?:[is]8|imma|int8).*gemm")


def product_bytes(l: int, m: int, k: int, c: int) -> int:
    return l * m * k + l * k * c + 4 * l * m * c


def product_ops(l: int, m: int, k: int, c: int) -> int:
    return 2 * l * m * k * c


def is_product(name: str) -> bool:
    """A device operation that computes the fastdot product."""
    return "fastdot" in name or bool(INT8_GEMM.search(name))


def read(run) -> Optional[float]:
    prof, pk = run.profile, roofline.peaks(run.card)
    shapes = (prof or {}).get("launches", {}).get("fastdot_mm")
    if not shapes or pk is None:
        return None
    seconds = sum(t for name, t in prof["device_ops"].items() if is_product(name))
    if seconds <= 0:
        return None
    least = sum(roofline.bound_s(product_bytes(*s), product_ops(*s), pk) for s in shapes)
    return 100.0 * least / seconds
