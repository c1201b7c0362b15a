"""Median host time of the relinearized ct x ct product (FheRuntime.mul_ct), ms."""

from portbench.metrics import _read


def read(run):
    return _read.span_median_ms(run, "compare.mul_relin")
