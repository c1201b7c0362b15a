"""The program's own spans and counters in a traced run of a cell.

The port records spans and counters at its layer boundaries while a
`fhe_icp_tpu_torch.utils.profiling.recording()` is open.  This module
reads them as the per-layer metrics below, and runs one cell with them:

    python3 -m portbench.program_spans --workload <cell> --seed <n> --seconds <s>

It sets the cell up as a run does, then drives the window with the
harness's spans on (as in a traced run) and the program's recording on,
each request marked with `request(i)`; then the host stretch of
`profile_s` seconds under the profiler twice, with the program's recording
off and then on.  It prints one JSON line: the per-layer metrics; each
harness span's median beside the median of its child program spans; the
device's idle gaps labelled by the innermost program span or harness span
the host was in; the device operations launched a request; both host
stretches' pace; and the cell's checks.  The harness spans are made
program spans too (`ProgramTracer`), so the program's spans inside one
are its children.  `python3 -m portbench.run` does not run this.
"""

from __future__ import annotations

# First: sets the host's thread counts before torch is imported, as a run does.
from portbench import run as bench  # noqa: I001

import argparse
import collections
import contextlib
import json
import re
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench import harness

from fhe_icp_tpu_torch.utils import profiling

# Metric: the span whose self time it reads, the median over the window's
# requests of the span's self time in a request, in ms.
PER_REQUEST = {
    "search.score_ms": "search.score",
    "search.topk_device_ms": "search.topk_device",
    "search.to_host_ms": "search.to_host",
    "search.rank_ms": "search.rank",
    "compare.tensor_ms": "ct.tensor",
    "compare.ks_digits_ms": "ks.digits",
    "compare.ks_inner_ms": "ks.inner",
    "compare.ks_div_ms": "ks.div_special",
    "compare.mod_switch_ms": "ct.mod_switch",
}
# Metric of device operations launched a request, by the count of the
# cell's requests it is read in.
LAUNCHES = {"queries": "search.launches_per_query", "compares": "compare.launches_per_compare"}


class ProgramTracer(harness.Tracer):
    """The harness's tracer, whose spans are program spans as well, so that in
    a recording the program's spans inside a harness span are its children."""

    @contextlib.contextmanager
    def span(self, name: str):
        with super().span(name), profiling.span(name):
            yield


def self_ms_by_request(rec: profiling.Recording) -> Dict[int, Dict[str, float]]:
    """{request: {span name: self time in ms}} over the spans of each request."""
    out: Dict[int, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for s, own in zip(rec.spans, rec.self_ns()):
        if s.request is not None:
            out[s.request][s.name] += own / 1e6
    return out


def span_metrics(rec: profiling.Recording) -> Dict[str, float]:
    """The per-layer metrics the recording has something for."""
    out: Dict[str, float] = {}
    by_req = self_ms_by_request(rec)
    present = {s.name for s in rec.spans}
    for metric, name in PER_REQUEST.items():
        if name in present and by_req:
            out[metric] = float(np.median([r.get(name, 0.0) for r in by_req.values()]))
    return out


def coverage(rec: profiling.Recording, harness_ms: Dict[str, List[float]]) -> Dict[str, dict]:
    """For each harness span: its median (ending in a synchronize), the median
    over requests of the time its child program spans take, and their ratio."""
    kids: Dict[tuple, float] = collections.defaultdict(float)
    for s in rec.spans:
        if s.parent is not None and rec.spans[s.parent].name in harness_ms:
            kids[(rec.spans[s.parent].name, s.request)] += (s.end_ns - s.start_ns) / 1e6
    out = {}
    for name, ms in harness_ms.items():
        reqs = sorted({s.request for s in rec.spans if s.name == name})
        if not ms or not reqs:
            continue
        h = float(np.median(ms) * 1e3)
        c = float(np.median([kids[(name, r)] for r in reqs]))
        out[name] = {"median_ms": h, "children_median_ms": c, "share": c / h if h else None,
                     "children": sorted({s.name for s in rec.spans if s.parent is not None
                                         and rec.spans[s.parent].name == name})}
    return out


def _raw_events(prof) -> list:
    """The profiler's events, stamped in ns on `time.time_ns()`'s clock."""
    return list(prof.profiler.kineto_results.events())


def _is_device_op(e, labels: set) -> bool:
    """A kernel, copy or set on the card: not a span's mark on its timeline."""
    return e.device_type() == torch.autograd.DeviceType.CUDA and e.name() not in labels


def _busy(events: list, labels: set) -> Dict[int, List[list]]:
    """Each card's union of its device operations' intervals, in ns, by the
    card's device index."""
    out: Dict[int, List[list]] = collections.defaultdict(list)
    for c, s, e in sorted((ev.device_index(), ev.start_ns(), ev.end_ns())
                          for ev in events if _is_device_op(ev, labels)):
        iv = out[c]
        if iv and s <= iv[-1][1]:
            iv[-1][1] = max(iv[-1][1], e)
        else:
            iv.append([s, e])
    return dict(out)


def _innermost(rec: profiling.Recording, times: List[float]) -> List[Optional[int]]:
    """For each of the increasing `times`, the index of the innermost span
    open then, or None.  The spans of one thread nest, so the open ones
    form a stack."""
    order = sorted(range(len(rec.spans)), key=lambda i: (rec.spans[i].start_ns, i))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(order) and rec.spans[order[j]].start_ns <= t:
            i = order[j]
            while stack and rec.spans[stack[-1]].end_ns < rec.spans[i].start_ns:
                stack.pop()
            stack.append(i)
            j += 1
        while stack and rec.spans[stack[-1]].end_ns < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _harness_ancestor(rec: profiling.Recording, i: int, harness_names: set) -> Optional[int]:
    while i is not None and rec.spans[i].name not in harness_names:
        i = rec.spans[i].parent
    return i


def idle_gaps(prof, rec: profiling.Recording, harness_names: set) -> dict:
    """Seconds of device idle time by the innermost span the host was in at
    each gap's midpoint ("between spans" outside every span), the same with
    the harness spans alone as labels, and for each harness span the share
    of the gaps inside it that no program span inside it labels.  Gaps are
    found on each card's own timeline and summed over the cards.  None
    without two stretches of device activity on some card."""
    busy = _busy(_raw_events(prof), {s.name for s in rec.spans})
    gaps = sorted(((e0 + s1) / 2, (s1 - e0) / 1e9) for iv in busy.values()
                  for (_, e0), (s1, _) in zip(iv, iv[1:]))
    if not gaps:
        return None
    by_span: Dict[str, float] = collections.defaultdict(float)
    by_harness: Dict[str, float] = collections.defaultdict(float)
    left: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0.0])
    for (_, gap), best in zip(gaps, _innermost(rec, [m for m, _ in gaps])):
        top = None if best is None else _harness_ancestor(rec, best, harness_names)
        by_span["between spans" if best is None else rec.spans[best].name] += gap
        h = "between spans" if top is None else rec.spans[top].name
        by_harness[h] += gap
        if top is not None:
            left[h][0] += gap
            left[h][1] += gap if best == top else 0.0
    return {"by_span": dict(by_span), "by_harness_span": dict(by_harness),
            "left_to_harness_share": {h: v[1] / v[0] for h, v in left.items() if v[0]}}


def launches(prof, rec: profiling.Recording, harness_names: set) -> Optional[dict]:
    """Device operations (kernels, copies, sets) a request, counted where the
    host launched them (the profiler's correlation of each operation with
    its launch call): inside the request's program spans, and among them the
    port's own kernels by name; and inside its harness spans (the whole
    served request).  Medians over the requests; None without device
    operations or requests."""
    events = _raw_events(prof)
    launch_ns = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() == torch.autograd.DeviceType.CPU and e.correlation_id()
                 and e.name().startswith("cu")}
    ops = [e for e in events if _is_device_op(e, {s.name for s in rec.spans})]
    matched = sorted((launch_ns[e.correlation_id()], e.name()) for e in ops
                     if e.correlation_id() in launch_ns)
    reqs = sorted({s.request for s in rec.spans if s.request is not None})
    if not matched or not reqs:
        return None
    ours = re.compile(r"\w*(?:%s)\w*" % "|".join(harness.K1_KERNELS + harness.K2_KERNELS))
    program = {r: collections.Counter() for r in reqs}
    whole = collections.Counter()
    for (_, name), i in zip(matched, _innermost(rec, [t for t, _ in matched])):
        if i is None or rec.spans[i].request is None:
            continue
        r, top = rec.spans[i].request, _harness_ancestor(rec, i, harness_names)
        whole[r] += top is not None
        if i != top:
            kernel = ours.search(name)
            program[r][kernel.group(0) if kernel else "other"] += 1
    kernels = sorted({k for c in program.values() for k in c} - {"other"})
    return {"per_request": float(np.median([sum(program[r].values()) for r in reqs])),
            "kernels_per_request": {k: float(np.median([program[r][k] for r in reqs]))
                                    for k in kernels},
            "in_whole_request": float(np.median([whole[r] for r in reqs])),
            "requests": len(reqs), "device_ops": len(ops), "unmatched": len(ops) - len(matched)}


def run_cell(cell_name: str, seed: int, seconds: float, device: torch.device,
             config: Optional[dict] = None, mix: Optional[dict] = None,
             devices: Optional[Sequence[torch.device]] = None) -> dict:
    """One run of `cell_name` with the program's spans; returns the result
    object (`config` and `mix` replace the cell's data files; `devices` are
    the cell's cards, `device` first, by default `device` alone)."""
    t_process = time.perf_counter()
    devices = tuple(devices) if devices else (device,)
    man = harness.manifest()
    entry = harness.find(man["workloads"], cell_name, "workload")
    config = config or harness.load_json("configs", f"{entry['config']}.json")
    mix = mix or harness.load_json("traffic", f"{entry['traffic']}.json")
    driver = harness.load_module("drivers", mix["driver"])
    tracer = ProgramTracer(True, devices)
    cell = harness.Cell(cell_name, seed, seconds, True, devices, config, mix, tracer)
    state = driver.setup(cell)
    tracer.warm_profiler()
    setup_s = time.perf_counter() - t_process

    current = [0]

    def request(st, i):
        current[0] = i
        return driver.request(st, i)

    def serve(st, req, tr):
        with profiling.request(current[0]):
            return driver.serve(st, req, tr)

    with profiling.recording() as rec:
        answers, lat, failed, window_s, _, window_launches = harness.closed_loop(
            cell, request, serve, state, seconds)
    counts = driver.counts(state, answers)
    harness_ms = {k: list(v) for k, v in tracer.spans.items()}
    harness_names = set(harness_ms)

    stretch = {}
    gaps = launched = None
    for on in (False, True):
        with profiling.recording() if on else contextlib.nullcontext() as hrec:
            prof, stretch_s, (more, _, bad, _, _, _) = tracer.run_profiled(
                "host", lambda: harness.closed_loop(cell, request, serve, state,
                                                    float(mix["profile_s"]), len(answers)))
        stretch["on" if on else "off"] = {"requests": len(more), "seconds": stretch_s,
                                          "ms_a_request": 1e3 * stretch_s / max(len(more), 1)}
        answers, failed = answers + more, failed + bad
        if on:
            gaps = idle_gaps(prof, hrec, harness_names)
            launched = launches(prof, hrec, harness_names)

    driver.release(state)
    checks = driver.check(state, answers)
    metrics = span_metrics(rec)
    kind = next((k for k in LAUNCHES if counts.get(k)), None)
    if launched is not None and kind:
        metrics[LAUNCHES[kind]] = launched["per_request"]
    by_req = self_ms_by_request(rec)
    ms = np.asarray(lat) * 1e3
    return {
        "workload": cell_name, "seed": seed, "card": bench.card_line() if device.type == "cuda"
        else "cpu", "setup_s": setup_s, "window_s": window_s, "attempted": len(lat),
        "failed": failed, "correct": bool(answers) and failed == 0 and bool(checks)
        and all(c.ok for c in checks),
        "latency_ms": {"median": float(np.median(ms)), "p95": float(np.percentile(ms, 95))},
        "metrics": metrics,
        "program_spans": {name: float(np.median([r.get(name, 0.0) for r in by_req.values()]))
                          for name in sorted({s.name for s in rec.spans}) if by_req},
        "coverage": coverage(rec, harness_ms),
        "kernels_launches_per_request": {k: v / max(len(lat), 1) for k, v in
                                         window_launches.items()},
        "host_stretch": stretch, "idle_gaps": gaps, "launches": launched,
        "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    args = ap.parse_args(argv)
    devices = bench.cell_cards(args.workload)
    if devices is None:
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, devices[0], devices=devices)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
