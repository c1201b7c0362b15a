"""95th percentile of the compare requests' latency in the window, ms."""

from portbench.metrics import _read


def read(run):
    return _read.p95_ms(run)
