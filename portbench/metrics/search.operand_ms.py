"""Median host time of the query operand (pack.make_packed_query_operand), ms."""

from portbench.metrics import _read


def read(run):
    return _read.span_median_ms(run, "search.operand")
