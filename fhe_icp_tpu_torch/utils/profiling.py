"""Profiling, roofline accounting, the card's data-sheet bounds and a metrics registry.

* `trace(dir)` — `torch.profiler` around a block, exported as a Chrome
  trace (Perfetto, chrome://tracing).
* `measure(fn, *args)` and `measure_chained(step_fn)` — host-clock times
  that synchronize the device the tensors live on.
* `measure_ondevice_loop(body)` — per-step time from the slope between two
  runs of back-to-back launches timed by CUDA events, which cancels the
  fixed cost around a run.
* `roofline(...)` — achieved bytes/s and ops/s against a declared footprint.
* `CARD_SPECS`, `card_spec()`, `hbm_spec_gbs()` — the published peaks of a
  card, by `torch.cuda.get_device_name`: the denominators of every bound
  `chip_smoke.py` prints.
* `Metrics` — an append-only registry with JSON export.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from ..devices import target


def _sync(*objs) -> None:
    """Wait for the cards that hold any tensor in objs (nested lists, tuples, dicts)."""
    devices = set()

    def walk(o):
        if isinstance(o, torch.Tensor):
            if o.device.type == "cuda":
                devices.add(o.device)
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
        elif isinstance(o, dict):
            for x in o.values():
                walk(x)
    walk(objs)
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler over the block (the card's activity too where there is
    one), written to `log_dir`/trace.json; yields the directory."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "fhe-trace")
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def measure(fn: Callable, *args, iters: int = 16, warmup: int = 1) -> Dict:
    """Steady-state host-clock time of fn(*args), each run's device work included."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(args, out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(args, out)
    dt = (time.perf_counter() - t0) / iters
    return {"ms": dt * 1e3, "s": dt}


def measure_chained(step_fn: Callable, c_short: int = 8, c_long: int = 64,
                    reps: int = 3, device: torch.device | str = "cuda") -> Dict:
    """Per-step time of a dependency chain, read back to the host.

    `step_fn(token) -> token` threads a small int32 token through each step
    so that steps serialize on the device; reading the last token back
    forces completion, and the slope between two chain lengths (the best of
    `reps` runs each) cancels the fixed round trip.
    """
    dev = target(device, "measure_chained")

    def chain(n: int) -> float:
        best = float("inf")
        for _ in range(reps):
            tok = torch.zeros((), dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            for _ in range(n):
                tok = step_fn(tok)
            int(tok)                                   # forces full completion
            best = min(best, time.perf_counter() - t0)
        return best

    chain(2)                                           # warm-up
    dt = (chain(c_long) - chain(c_short)) / (c_long - c_short)
    return {"ms": dt * 1e3, "s": dt}


def measure_ondevice_loop(body: Callable, k_short: int = 8, k_long: int = 40,
                          reps: int = 5, device: torch.device | str = "cuda") -> Dict:
    """Per-step time of `body(token) -> token` from the slope between k_short
    and k_long back-to-back steps.

    On the card each run of k steps is timed by CUDA events around it; the
    slope (median of `reps`) cancels the fixed cost before the first and
    after the last launch, so it is the device's time per step wherever the
    card, not the host's launches, sets the pace.  `spread` is the range of
    the reps' slopes over their median.  On the CPU the host clock times
    the runs (for tests of the plumbing; no device number).
    """
    dev = target(device, "measure_ondevice_loop")

    def run(k: int) -> float:
        tok = torch.zeros((), dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(k):
                tok = body(tok)
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / 1e3
        t0 = time.perf_counter()
        for _ in range(k):
            tok = body(tok)
        return time.perf_counter() - t0

    run(k_short)
    run(k_long)                                        # warm-up
    s = sorted((run(k_long) - run(k_short)) / (k_long - k_short) for _ in range(reps))
    dt = statistics.median(s)
    return {"ms": dt * 1e3, "s": dt, "spread": (s[-1] - s[0]) / dt if dt else 0.0}


def roofline(fn: Callable, *args, bytes_accessed: int, ops: int = 0,
             items: int = 0, iters: int = 16) -> Dict:
    """Measure fn and relate it to its declared memory and compute footprint."""
    m = measure(fn, *args, iters=iters)
    dt = m["s"]
    out = {"ms": m["ms"], "gb_per_s": bytes_accessed / dt / 1e9,
           "bytes_accessed": bytes_accessed}
    if ops:
        out["gops_per_s"] = ops / dt / 1e9
    if items:
        out["items_per_s"] = items / dt
    return out


def keyswitch_footprint(n: int, l: int, n_dig: int, batch: int = 1) -> Dict:
    """Cost model of one hybrid keyswitch: limb transforms and the least HBM.

    Per switched polynomial (`ops/arith.hybrid_keyswitch_apply`): one INTT
    over l limbs; forward digit NTTs — full-limb digits (n_dig == l) reuse
    the input slice for their own limb, so l transforms a digit (16-bit
    sub-digits need all l+1); then divide-by-P on the 2 accumulated polys
    = one single-limb special INTT + one l-limb delta forward NTT each.
    Each transform reads and writes its operand at least once.
    """
    per_digit = l if n_dig == l else l + 1
    lt = batch * (l + n_dig * per_digit + 2 * (1 + l))
    hbm = 4 * n * 2 * lt                   # u32 read + write per transform
    return {"limb_transforms": lt, "min_hbm_bytes": hbm}


@dataclass(frozen=True)
class CardSpec:
    """A card's published peaks (NVIDIA data sheets, dense, at the full
    power limit)."""

    hbm_gbs: float            # device memory, GB/s
    int8_tops: float          # int8 on the tensor cores, T operations/s
    int32_mul_tops: float     # 32-bit integer multiplies (IMAD), T/s
    nvlink_gbs: float         # NVLink to another card, GB/s each way


# 32-bit integer multiplies on the CUDA cores: 64 a clock per SM, a quarter
# of the float32 peak in operations (two a fused multiply-add): 67 / 4 T/s.
CARD_SPECS: Dict[str, CardSpec] = {
    "NVIDIA H100 80GB HBM3": CardSpec(3350.0, 1979.0, 67.0 / 4, 450.0),
}
# Device-memory bandwidth by card (GB/s): the roofline's denominator.
HBM_SPEC_GBS: Dict[str, float] = {name: s.hbm_gbs for name, s in CARD_SPECS.items()}


def card_spec() -> Optional[CardSpec]:
    """The published peaks of the first card; None on the CPU or an unknown card."""
    if not torch.cuda.is_available():
        return None
    return CARD_SPECS.get(torch.cuda.get_device_name(0))


def hbm_spec_gbs() -> Optional[float]:
    """Published device-memory bandwidth of the first card, if known."""
    spec = card_spec()
    return spec.hbm_gbs if spec else None


def attainable_read_bw(nbytes: int = 800_000_000, iters: int = 8,
                       device: torch.device | str = "cuda") -> float:
    """GB/s of a device-wide int8 read-reduce (a measured lower bound; the
    published `hbm_spec_gbs()` is the roofline)."""
    dev = target(device, "attainable_read_bw")
    cols = 131072
    rows = max(8, nbytes // cols)
    x = torch.zeros((rows, cols), dtype=torch.int8, device=dev)
    r = roofline(lambda a: a.sum(dtype=torch.int64), x, bytes_accessed=rows * cols,
                 iters=iters)
    return r["gb_per_s"]


@dataclass
class Metrics:
    """Append-only metrics registry with JSON export."""

    records: List[Dict] = field(default_factory=list)

    def log(self, name: str, value: Any, **attrs) -> None:
        self.records.append({"name": name, "value": value, "t": time.time(), **attrs})

    def latest(self, name: str) -> Optional[Any]:
        for rec in reversed(self.records):
            if rec["name"] == name:
                return rec["value"]
        return None

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.records, indent=2, default=str)
        if path:
            Path(path).write_text(s)
        return s


METRICS = Metrics()
