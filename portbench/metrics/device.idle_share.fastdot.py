"""Per cent of the profiled window in which the mean card ran no operation."""

from portbench.metrics import _read


def read(run):
    return _read.idle_share(run)
