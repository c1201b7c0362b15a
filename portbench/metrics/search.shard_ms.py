"""Median host time of the host-shard search (multihost.search_host_shard), ms."""

from portbench.metrics import _read


def read(run):
    return _read.span_median_ms(run, "search.shard")
