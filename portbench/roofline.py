"""The yardstick of the kernels: operations and bytes from shapes, and the card's peaks.

A roofline share is the least time the card could take for a launch, the
larger of its operations over the peak rate and its bytes over the peak
bandwidth, divided by the time the launch took on the device.  Each input
byte is counted once and each output byte once, whatever a kernel reads
again; scratch that a kernel writes and reads back is not counted.

K1 (`fhe_pack_score`) and K2 (`fhe_ntt_fwd`, `fhe_ntt_inv` and the cyclic
entries) are counted from the arguments of their C entry points, which the
harness records around each launch in a traced run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Peaks:
    hbm_bytes_per_s: float
    int8_ops_per_s: float


# NVIDIA's data sheet for the SXM part, dense rates, at the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(hbm_bytes_per_s=3.35e12, int8_ops_per_s=1979e12),
}


def peaks(card: str) -> Optional[Peaks]:
    """The data-sheet peaks of a card by `torch.cuda.get_device_name()`, or None."""
    return PEAKS.get(card)


def k1_ops(l: int, g: int, k: int, s: int) -> int:
    """Integer operations of one K1 launch: an int8 product per limb of the
    (4G, K) document digits by the (K, 4S) query digits, two per multiply-add."""
    return 2 * l * (4 * g) * k * (4 * s)


def k1_bytes(l: int, g: int, k: int, s: int) -> int:
    """Bytes one K1 launch must move: the int8 document digits (L, 4G, K) and
    query digits (L, K, 4S), the uint32 fold weights (L, 4, 4S) and limb
    tables (L, 8) read once, the uint32 residues (L, G, S) written once."""
    return l * 4 * g * k + l * k * 4 * s + 4 * (l * 4 * 4 * s + l * 8) + 4 * l * g * s


def k2_bytes(rows: int, l: int, n: int) -> int:
    """Bytes one K2 launch must move: `rows` uint32 rows of N coefficients
    read and written once, and for each of its L limbs the kernel table
    (4N words: twist and stage twiddles, each beside its Shoup companion)
    and the prime."""
    return 2 * 4 * rows * n + l * (4 * 4 * n + 4)


def bound_s(byts: float, ops: float, pk: Peaks) -> float:
    """The least time in seconds: bytes at the peak bandwidth or operations
    at the peak int8 rate, whichever is longer."""
    return max(byts / pk.hbm_bytes_per_s, ops / pk.int8_ops_per_s)
