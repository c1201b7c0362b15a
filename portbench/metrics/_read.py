"""What the metric readers share: percentiles, span medians, the device's
idle share and kernel roofline shares, each from one run's record.

A reader returns None where its run has nothing to read (no such span,
no profiled device activity, a card without a row in the table of
peaks); the harness then leaves the metric out of the line.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from portbench import roofline


def p95_ms(run) -> Optional[float]:
    """95th percentile of every request's latency in the window, in ms."""
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))


def rate(run, count: str) -> Optional[float]:
    """Work `count` done over the whole window, per second."""
    work = run.counts.get(count)
    return work / run.window_s if work and run.window_s > 0 else None


def span_median_ms(run, name: str) -> Optional[float]:
    spans = run.spans.get(name)
    return float(np.median(spans) * 1e3) if spans else None


def idle_share(run) -> Optional[float]:
    """Per cent of the profiled window in which no operation ran on the device."""
    prof = run.profile
    if not prof or prof["busy_s"] <= 0 or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def roofline_share(run, kind: str) -> Optional[float]:
    """Per cent: the least time of the kernel's profiled launches (their bytes
    or operations at the card's peaks) over their device time."""
    prof, pk = run.profile, roofline.peaks(run.card)
    if not prof or pk is None or prof["kernel_s"][kind] <= 0 or not prof["launches"][kind]:
        return None
    if kind == "k1":
        least = sum(roofline.bound_s(roofline.k1_bytes(*a), roofline.k1_ops(*a), pk)
                    for a in prof["launches"]["k1"])
    else:
        least = sum(roofline.bound_s(roofline.k2_bytes(*a), 0, pk)
                    for a in prof["launches"]["k2"])
    return 100.0 * least / prof["kernel_s"][kind]
