"""Run one cell of the benchmark of the PyTorch and CUDA port on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device`, in a traced run
`breakdown`, and last `checks`: each number compared with the plain
reference beside its limit (also the last lines of standard error).
The cell runs on the `chips` cards it asks for, `cuda:0` onwards.
Without a CUDA card, with fewer cards than the cell asks for or cards of
different names, or if JAX or the JAX package was loaded, it exits with
another code than 0 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402

# Few threads for steady host timings; no library may pull in JAX or Flax.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "4")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional, Sequence  # noqa: E402

import torch  # noqa: E402

# The checkout's root, so that the port imports from it however this is started.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def card_line() -> str:
    """Each visible card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not read"
    return " | ".join(out.stdout.strip().splitlines()) or "nvidia-smi: not read"


def cell_cards(workload: str) -> Optional[List[torch.device]]:
    """The cards a run of `workload` uses, `cuda:0` to `cuda:<chips-1>`; None,
    with the reason on standard error, without as many cards of one name."""
    chips = harness.find(harness.manifest()["workloads"], workload, "workload")["chips"]
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < chips:
        print(f"portbench: {workload} needs {chips} CUDA card(s); {visible} visible",
              file=sys.stderr)
        return None
    devices = [torch.device("cuda", i) for i in range(chips)]
    names = [torch.cuda.get_device_name(d) for d in devices]
    if len(set(names)) > 1:
        # The table of peaks is read for one card's name (`roofline.peaks`).
        print(f"portbench: {workload}'s cards differ: {names}", file=sys.stderr)
        return None
    return devices


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, config: Optional[dict] = None,
             mix: Optional[dict] = None, serve=None, t_process: Optional[float] = None,
             devices: Optional[Sequence[torch.device]] = None) -> dict:
    """One run of `cell_name`; returns the result object (printed by `main`).

    `config` and `mix` replace the cell's data files (the tests' small
    sizes); `serve` replaces the driver's timed call (the control).
    `devices` are the cell's cards, `device` first (by default `device`
    alone).
    """
    t_process = T_PROCESS if t_process is None else t_process
    devices = tuple(devices) if devices else (device,)
    if devices[0] != device:
        raise ValueError(f"the cell's first card {devices[0]} is not {device}")
    man = harness.manifest()
    entry = harness.find(man["workloads"], cell_name, "workload")
    config = config or harness.load_json("configs", f"{entry['config']}.json")
    mix = mix or harness.load_json("traffic", f"{entry['traffic']}.json")
    driver = harness.load_module("drivers", mix["driver"])
    tracer = harness.Tracer(trace, devices)
    cell = harness.Cell(cell_name, seed, seconds, trace, devices, config, mix, tracer)

    state = driver.setup(cell)
    if trace:
        tracer.warm_profiler()
        if device.type == "cuda":
            tracer.record_kernel_entries()
    serve = serve or driver.serve
    answers, lat, failed, window_s, t_start, launches = harness.closed_loop(
        cell, driver.request, serve, state, seconds)
    counts = driver.counts(state, answers)
    if trace:
        more, more_failed = harness.profiled_stretch(cell, driver.request, serve, state,
                                                     len(answers))
        answers, failed = answers + more, failed + more_failed
    peaks = [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0 for d in devices]
    run = harness.Run(cell_name, torch.cuda.get_device_name(device) if device.type == "cuda"
                      else "cpu", t_start - t_process, window_s, lat, len(answers), failed,
                      counts, launches, dict(tracer.spans), tracer.profile)

    driver.release(state)
    gc.collect()
    for d in devices:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    checks = driver.check(state, answers)

    metrics = {}
    for m in harness.cell_metrics(man, cell_name, trace):
        value = harness.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": run.card,
           "count": len(devices), "memory_peak_bytes": int(max(peaks))}
    result = {"correct": run.attempted > 0 and failed == 0 and bool(checks)
                         and all(c.ok for c in checks),
              "attempted": run.attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = harness.breakdown(run.profile)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}

    print(f"[portbench] {cell_name} seed {seed}: set-up {run.setup_s:.4f} s, window "
          f"{window_s:.4f} s, {run.attempted} requests ({failed} failed), latency "
          f"{harness.describe_latency(lat)}; work {counts}; launches {launches}",
          file=sys.stderr)
    for d, peak in zip(devices, peaks):
        print(f"[portbench] memory peak {d}: {peak} B", file=sys.stderr)
    for name, spans in sorted(run.spans.items()):
        print(f"[portbench] span {name}: {harness.describe_latency(spans)}", file=sys.stderr)
    for c in checks:
        print(f"[portbench] check {c.name}: {c.value} (limit {c.limit}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    return result


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse(argv)
    devices = cell_cards(args.workload)
    if devices is None:
        return 2
    print(f"[portbench] card: {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      devices[0], devices=devices)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
