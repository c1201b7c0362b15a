"""Per cent of the profiled search window with the device idle."""

from portbench.metrics import _read


def read(run):
    return _read.idle_share(run)
