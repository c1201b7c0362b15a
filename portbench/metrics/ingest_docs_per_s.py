"""Documents embedded, reduced, quantized, encrypted and stored per second over the window."""

from portbench.metrics import _read


def read(run):
    return _read.rate(run, "docs_stored")
