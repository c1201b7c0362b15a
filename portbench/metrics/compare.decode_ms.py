"""Median host time of the modulus switch and decode (mod_switch, decrypt_dot), ms."""

from portbench.metrics import _read


def read(run):
    return _read.span_median_ms(run, "compare.decode")
