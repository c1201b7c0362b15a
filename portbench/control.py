"""The control of a cell: its plain reference in the next lower precision,
put in the program's place, judged by the cell's own comparison.

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Each seed sets the cell up as a run does, drives a window of `--seconds`
at the cell's own load with every answer computed by the driver's
`control`, and prints one JSON line of the numbers the comparison reads.
A sound comparison reads the control as not correct on every seed: these
readings are the upper ends that the limits are set below.  The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    devices = run.cell_cards(args.workload)
    if devices is None:
        return 2
    entry = harness.find(harness.manifest()["workloads"], args.workload, "workload")
    driver = harness.load_module(
        "drivers", harness.load_json("traffic", f"{entry['traffic']}.json")["driver"])
    for seed in args.seeds:
        res = run.run_cell(args.workload, seed, args.seconds, False, devices[0],
                           serve=lambda st, req, tracer: driver.control(st, req),
                           t_process=time.perf_counter(), devices=devices)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
