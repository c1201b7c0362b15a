"""Profiling, roofline accounting, the card's data-sheet bounds and the
program's own spans and counters.

* `span(name)`, `count(name, n)`, `request(i)` and `recording()` — the
  program's spans and counters at its layer boundaries, kept in memory
  while a `recording()` is open and free otherwise.  Times come from
  `time.time_ns()`, the clock `torch.profiler` stamps its events with, so a
  span lines up with the device's activity in the same profile.
* `trace(dir)` — `torch.profiler` around a block, exported as a Chrome
  trace (Perfetto, chrome://tracing), the program's spans beside the
  profiler's events.
* `measure(fn, *args)` and `measure_chained(step_fn)` — host-clock times
  that synchronize the device the tensors live on.
* `measure_ondevice_loop(body)` — per-step time from the slope between two
  runs of back-to-back launches timed by CUDA events, which cancels the
  fixed cost around a run.
* `roofline(...)` — achieved bytes/s and ops/s against a declared footprint.
* `CARD_SPECS`, `card_spec()`, `hbm_spec_gbs()` — the published peaks of a
  card, by `torch.cuda.get_device_name`: the denominators of every bound
  `chip_smoke.py` prints.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

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


# ---------------------------------------------------------------------------
# The program's spans and counters
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    """One recorded span; times in ns on `time.time_ns()`'s clock."""

    name: str
    request: Optional[int]      # set by the enclosing `request(i)`, else None
    parent: Optional[int]       # index of the enclosing span in `Recording.spans`
    start_ns: int
    end_ns: int


@dataclass
class Recording:
    """What one `recording()` recorded, filled in when its block ends: the
    spans in the order they opened, and the counters."""

    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)

    def self_ns(self) -> List[int]:
        """Each span's duration less the time its child spans cover (children
        run one after another on the recording's thread)."""
        out = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent is not None:
                out[s.parent] -= s.end_ns - s.start_ns
        return out


class _Recorder:
    """An open recording: spans as [name, request, parent, start, end] lists,
    the stack of open spans, the current request id and the counters."""

    __slots__ = ("thread", "spans", "stack", "request", "counters")

    def __init__(self):
        self.thread = threading.get_ident()
        self.spans: List[list] = []
        self.stack: List[int] = []
        self.request: Optional[int] = None
        self.counters: Dict[str, int] = {}


class _OpenSpan:
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.index = len(rec.spans)
        rec.spans.append([self.name, rec.request, rec.stack[-1] if rec.stack else None,
                          time.time_ns(), 0])
        rec.stack.append(self.index)
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec.spans[self.index][4] = time.time_ns()
        rec.stack.pop()
        return False


_NULL = contextlib.nullcontext()
# The open recording, if any.  Only `recording()` sets it; spans and counts
# from other threads than the one that opened it are not recorded.
_recorder: Optional[_Recorder] = None


def span(name: str):
    """Inside a `recording()`, a context manager that records its block as the
    span `name`; outside one, the shared null context."""
    rec = _recorder
    if rec is None or rec.thread != threading.get_ident():
        return _NULL
    return _OpenSpan(rec, name)


def count(name: str, n: int = 1) -> None:
    """Inside a `recording()`, add n to the counter `name`; outside one, nothing."""
    rec = _recorder
    if rec is not None and rec.thread == threading.get_ident():
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def request(i: int):
    """Inside a `recording()`: the spans opened in the block belong to request i."""
    rec = _recorder
    if rec is None:
        yield
        return
    before, rec.request = rec.request, i
    try:
        yield
    finally:
        rec.request = before


@contextlib.contextmanager
def recording():
    """Record the program's spans and counters over the block, from the thread
    that enters it; yields the `Recording`, filled in when the block ends.
    One recording at a time."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recording is already open")
    rec, out = _Recorder(), Recording()
    _recorder = rec
    try:
        yield out
    finally:
        _recorder = None
        out.spans = [Span(*s) for s in rec.spans]
        out.counters = dict(rec.counters)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler over the block (the card's activity too where there is
    one), written to `log_dir`/trace.json with the program's spans on the
    calling thread's track, above the operations they launched; yields the
    directory."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "fhe-trace")
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with recording() as rec, profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = Path(log_dir) / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    # The export's "ts" is in us after its base time (absolute where it names none).
    base, pid, tid = int(doc.get("baseTimeNanoseconds", 0)), os.getpid(), threading.get_native_id()
    doc["traceEvents"] += [
        {"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"request": s.request}} for s in rec.spans]
    path.write_text(json.dumps(doc))


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
