"""Percent of its roofline that phase 1 (K1) reaches."""

from perfbench.readers import phase1_roofline


def read(run):
    return phase1_roofline(run)
