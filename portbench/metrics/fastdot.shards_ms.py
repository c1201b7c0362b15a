"""Median host time of the sharded fastdot step: every card's shard scored, the
scores gathered and ranked on the first card, the top-k copied to the host, ms."""

from portbench.metrics import _read


def read(run):
    return _read.span_median_ms(run, "fastdot.shards")
