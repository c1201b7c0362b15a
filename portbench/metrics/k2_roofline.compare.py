"""Per cent of K2's roofline in the compare cell: least time over device time."""

from portbench.metrics import _read


def read(run):
    return _read.roofline_share(run, "k2")
