"""Per cent of K1's roofline: its launches' least time over their device time."""

from portbench.metrics import _read


def read(run):
    return _read.roofline_share(run, "k1")
