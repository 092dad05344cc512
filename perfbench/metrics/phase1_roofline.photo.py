"""Percent of its roofline that phase 1 (K1) reaches, counted at the
sample width its kernel reads and at the cell's subsampling
(perfbench/wide_roofline.py)."""

from perfbench.wide_roofline import phase1_roofline


def read(run):
    return phase1_roofline(run)
