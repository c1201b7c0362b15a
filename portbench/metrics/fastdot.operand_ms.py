"""Median host time of the fastdot query operand (fastdot.make_query_operand), ms."""

from portbench.metrics import _read


def read(run):
    return _read.span_median_ms(run, "fastdot.operand")
