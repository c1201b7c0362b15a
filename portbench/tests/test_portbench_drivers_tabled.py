"""The tests of `test_portbench_drivers.py`, collected over the cells its
fault table names.

That file parametrizes its fault test, at collection, over every cell of
the manifest and looks each up in its table `CAN_HAVE`, which names the
first two cells alone: a manifest with a later cell stops the whole file at
collection, and with it the small runs, controls and planted faults of the
cells it does name.  Here the same module is loaded with the manifest cut
to those cells while it is collected, and its tests run unchanged.  A later
cell has a test file of its own (`test_portbench_fastdot.py`)."""

import importlib.util
from pathlib import Path

from portbench import harness

TABLED = ("search-100k", "compare-ring16384")


def _load_tabled():
    full = harness.manifest

    def tabled():
        man = full()
        man["workloads"] = [w for w in man["workloads"] if w["name"] in TABLED]
        return man

    harness.manifest = tabled
    try:
        spec = importlib.util.spec_from_file_location(
            "portbench_drivers_tabled", Path(__file__).with_name("test_portbench_drivers.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        harness.manifest = full
    return module


globals().update({k: v for k, v in vars(_load_tabled()).items() if k.startswith("test_")})
