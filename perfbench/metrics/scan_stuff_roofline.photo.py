"""Percent of its roofline that the byte stuffing (K13, stuff_kernel)
reaches: the packed stream read once and the stuffed stream written once
(perfbench/wide_roofline.py)."""

from perfbench.wide_roofline import scan_stuff_roofline


def read(run):
    return scan_stuff_roofline(run)
