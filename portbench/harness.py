"""One run of one cell: set-up, the measured window, the check, the result line.

The harness is driven by data.  `BENCHMARK.json` names each cell's
configuration and traffic mix; the harness reads `configs/<config>.json`
and `traffic/<traffic>.json`, whose `driver` names the module
`drivers/<driver>.py` that sets up the program and serves one request,
and reads each metric with `metrics/<metric>.py`.  A new cell on an
existing driver is two data files and an entry in the manifest.

A driver module has:

* `setup(cell) -> state`: builds the system under test from the seed and
  warms up every shape the window uses;
* `request(state, i) -> req`: the i-th request's input, drawn from the seed;
* `serve(state, req, tracer) -> answer`: the timed call, whose answer
  reaches the host;
* `counts(state, answers) -> {name: work}`: the work done in the window;
* `release(state)`: frees the program's state once memory has been read;
* `check(state, answers) -> [Check]`: the plain reference's judgement;
* `control(state, req) -> answer`: the reference in the next lower
  precision, put in the program's place (`portbench.control`).

In a traced run (`--trace 1`) the drivers' spans end in a synchronize
through the window; then two stretches of `profile_s` seconds each of the
same traffic run under the profiler.  The first records the device's
activity alone, so that the host runs as served: the busy time, the
operations and the kernels' time, with the kernels' C entry points
recorded with their shapes.  The second adds the host's operations and
the spans as marks, which slow the host: only the idle gaps by span are
read from it.  In a run that is not traced, spans cost nothing.

A cell runs on the `chips` cards its entry in the manifest asks for,
`cuda:0` to `cuda:<chips-1>` (`Cell.devices`).  Every wait of the
harness (a span's end, the window's start and end, a profiled stretch)
waits for all of them, and the profile is read card by card: a card's
busy time is the union of its own operations, and the run's busy time is
the mean over the cell's cards.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib.util
import json
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
# Compared whole with each module's top-level name: the port's own name
# begins with the JAX package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fhe_icp_tpu")
K1_KERNELS = ("pack_score",)
K2_KERNELS = ("ntt_block_kernel", "ntt_warp_kernel")

@dataclass
class Check:
    """One number the comparison with the reference reads, and its limit.

    A run is correct when every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


Devices = Union[torch.device, Sequence[torch.device]]


def as_tuple(devices: Devices) -> Tuple[torch.device, ...]:
    return (devices,) if isinstance(devices, torch.device) else tuple(devices)


@dataclass
class Cell:
    """What a driver is given: the cell, its run's arguments and its data files."""

    name: str
    seed: int
    seconds: float
    trace: bool
    devices: Devices      # the cell's cards in card order; kept as a tuple
    config: dict
    mix: dict
    tracer: "Tracer"

    def __post_init__(self):
        self.devices = as_tuple(self.devices)

    @property
    def device(self) -> torch.device:
        """The first of the cell's cards."""
        return self.devices[0]


def sync(devices: Devices) -> None:
    """Wait for every card of `devices` (one device or several)."""
    for d in as_tuple(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Tracer:
    """Spans, kernel launch records and the profiler of a traced run."""

    def __init__(self, enabled: bool, devices: Devices):
        self.enabled = enabled
        self.devices = as_tuple(devices)
        self.spans: Dict[str, List[float]] = collections.defaultdict(list)
        self.profiling: Optional[str] = None     # the profiled stretch: "device" or "host"
        self.launches: Dict[str, list] = {"k1": [], "k2": []}
        self.profile: Optional[dict] = None

    @contextlib.contextmanager
    def span(self, name: str):
        """In a traced run's window: the block's host time, ending in a
        synchronize.  In the host stretch: only a mark on the profiler's
        timeline, with no synchronize; in the device stretch: nothing."""
        if self.profiling == "host":
            with torch.profiler.record_function(name):
                yield
            return
        if not self.enabled or self.profiling:
            yield
            return
        t0 = time.perf_counter()
        yield
        sync(self.devices)
        self.spans[name].append(time.perf_counter() - t0)

    def record_kernel_entries(self) -> None:
        """Record the shape arguments of every K1 and K2 launch made in the
        device stretch, at the kernels' C entry points."""
        from fhe_icp_tpu_torch import kernels
        lib = kernels.load()
        # fhe_pack_score(a, v, w, tab, out, work, L, G, K, S, splits, stream)
        self._wrap(lib, "fhe_pack_score", "k1", lambda a: (a[6], a[7], a[8], a[9]))
        # fhe_ntt_*(x, y, table, primes, rows, L, N, log N, R, C, threads, stream)
        for entry in ("fhe_ntt_fwd", "fhe_ntt_inv", "fhe_ntt_cyclic_fwd", "fhe_ntt_cyclic_inv"):
            self._wrap(lib, entry, "k2", lambda a: (a[4], a[5], a[6]))

    def _wrap(self, lib, entry: str, kind: str, shape) -> None:
        inner = getattr(lib, entry)

        def call(*args):
            if self.profiling == "device":
                self.launches[kind].append(tuple(int(x) for x in shape(args)))
            return inner(*args)
        setattr(lib, entry, call)

    def _profiler(self, host: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if any(d.type == "cuda" for d in self.devices) else []
        if host or not acts:
            acts.append(ProfilerActivity.CPU)
        return profile(activities=acts)

    def warm_profiler(self) -> None:
        """Start and stop each profiler once, with an operation on each card, so
        that its first start (CUPTI's set-up) falls outside the window."""
        for host in (False, True):
            with self._profiler(host):
                for d in self.devices:
                    torch.zeros(1, device=d).add_(1)
                sync(self.devices)

    def run_profiled(self, kind: str, drive) -> tuple:
        """`drive()` under the profiler as the `kind` stretch ("device" or
        "host"); returns (the profiler, the stretch's seconds, drive's result)."""
        sync(self.devices)
        prof = self._profiler(kind == "host")
        with prof:
            self.profiling = kind
            t0 = time.perf_counter()
            out = drive()
            sync(self.devices)
            seconds = time.perf_counter() - t0
            self.profiling = None
        return prof, seconds, out


def _union(spans: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def card_indices(devices: Devices) -> List[int]:
    """The profiler's device index of each card, in card order; a device
    without an index (the CPU) counts by its place."""
    return [i if d.index is None else d.index for i, d in enumerate(as_tuple(devices))]


def read_profile(prof, window_s: float, span_names: set, launches: dict,
                 cards: Sequence[int]) -> dict:
    """Busy time, device time by operation and kernel, and idle gaps by the
    harness span the host was in, from the profiled stretch after the window.

    `cards` are the device indices of the cell's cards.  Each card's busy
    time is the union of its own operations' intervals (0 for a card with
    none); `busy_s` is their mean over the cards, `busy_s_by_card` each in
    card order.  Idle gaps are found on each card's own timeline and summed
    over the cards.  Operations and kernel times sum over every card."""
    by_card: Dict[int, list] = collections.defaultdict(list)
    host = []
    for e in prof.events():
        if e.name in span_names:
            # A span's own range; its copy on the device's timeline is an
            # annotation, not an operation.
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            by_card[e.device_index].append((e.name, e.time_range.start, e.time_range.end))
    busy_iv = [_union([(s, e) for _, s, e in by_card.get(c, ())]) for c in cards]
    busy_us = [sum(e - s for s, e in iv) for iv in busy_iv]
    by_op: Dict[str, float] = collections.defaultdict(float)
    kernel_us = {"k1": 0.0, "k2": 0.0}
    for name, s, e in (op for ops in by_card.values() for op in ops):
        by_op[name] += e - s
        if any(k in name for k in K1_KERNELS):
            kernel_us["k1"] += e - s
        elif any(k in name for k in K2_KERNELS):
            kernel_us["k2"] += e - s
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = collections.defaultdict(float)
    for iv in busy_iv:
        for (_, e0), (s1, _) in zip(iv, iv[1:]):
            mid, label, best = (e0 + s1) / 2, "between spans", None
            i = bisect.bisect_right(starts, mid)
            for s, e, name in host[max(0, i - 8): i]:
                if s <= mid <= e and (best is None or e - s < best):
                    label, best = name, e - s
            idle[label] += s1 - e0
    return {
        "window_s": window_s,
        "busy_s": sum(busy_us) / len(cards) / 1e6,
        "busy_s_by_card": [b / 1e6 for b in busy_us],
        "device_ops": {k: v / 1e6 for k, v in by_op.items()},
        "idle_by_span": {k: v / 1e6 for k, v in idle.items()},
        "kernel_s": {k: v / 1e6 for k, v in kernel_us.items()},
        "launches": {k: list(v) for k, v in launches.items()},
    }


@dataclass
class Run:
    """What a metric reader reads: one run's window, spans, counters and trace."""

    cell: str
    card: str
    setup_s: float
    window_s: float
    latencies_s: List[float]
    attempted: int
    failed: int
    counts: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)   # program counter, window
    spans: Dict[str, List[float]] = field(default_factory=dict)
    profile: Optional[dict] = None


def manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in {MANIFEST.name}")


def load_json(*parts: str) -> dict:
    return json.loads(HERE.joinpath(*parts).read_text())


def load_module(kind: str, name: str):
    """`portbench/<kind>/<name>.py` as a module (names may hold dots and dashes)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or in a
    traced run its per-layer metrics whose moved metric the cell reports."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if m["moves"] in names and cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def closed_loop(cell: Cell, request, serve, state, seconds: float, first: int = 0) -> tuple:
    """Requests one after another for `seconds`, request `first` first:
    `serve(state, request(state, i), tracer)`, whose answer reaches the host.
    Returns (answers, latencies, failed, window_s, start time, the program's
    kernel launches in the window)."""
    from fhe_icp_tpu_torch import kernels
    answers, lat, failed = [], [], 0
    before = collections.Counter(kernels.launches)
    sync(cell.devices)
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = first
    while time.perf_counter() < deadline:
        req = request(state, i)
        t0 = time.perf_counter()
        try:
            ans = serve(state, req, cell.tracer)
        except Exception:                     # a failed request counts, the loop goes on
            traceback.print_exc(file=sys.stderr)
            failed, ans = failed + 1, None
        lat.append(time.perf_counter() - t0)
        answers.append((req, ans))
        i += 1
    window_s = time.perf_counter() - t_start
    launches = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v - before.get(k, 0)}
    return answers, lat, failed, window_s, t_start, launches


def profiled_stretch(cell: Cell, request, serve, state, first: int) -> tuple:
    """A traced run's profiled stretches after its window, `profile_s` seconds
    of the same traffic each: the device stretch, from which the profile's
    busy time, operations, kernel times and launches come, then the host
    stretch, from which only its idle gaps by span come.  Returns (answers,
    failed)."""
    tracer, seconds = cell.tracer, float(cell.mix["profile_s"])
    answers, failed, read = [], 0, {}
    for kind in ("device", "host"):
        prof, stretch_s, (more, _, bad, _, _, _) = tracer.run_profiled(
            kind, lambda: closed_loop(cell, request, serve, state, seconds, first + len(answers)))
        read[kind] = read_profile(prof, stretch_s, set(tracer.spans), tracer.launches,
                                  card_indices(tracer.devices))
        print(f"[portbench] {kind} stretch: {len(more)} requests in {stretch_s:.4f} s, "
              f"{1e3 * stretch_s / max(len(more), 1):.4f} ms a request, device busy "
              f"{read[kind]['busy_s']:.6f} s", file=sys.stderr)
        answers, failed = answers + more, failed + bad
    tracer.profile = dict(read["device"], idle_by_span=read["host"]["idle_by_span"])
    return answers, failed


def breakdown(profile: dict) -> dict:
    top = sorted(profile["device_ops"].items(), key=lambda kv: -kv[1])[:10]
    top = [(k[:160], v) for k, v in top]
    gaps = sorted(profile["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def describe_latency(lat_s: List[float]) -> str:
    if not lat_s:
        return "n=0"
    ms = np.asarray(lat_s) * 1e3
    return (f"n={len(ms)} median={np.median(ms):.4f} ms p95={np.percentile(ms, 95):.4f} ms "
            f"max={ms.max():.4f} ms")
