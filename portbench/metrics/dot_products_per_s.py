"""Documents scored per second: queries completed x documents in the store / window."""

from portbench.metrics import _read


def read(run):
    return _read.rate(run, "dot_products")
