"""Percent of its roofline that the scan pack (K3) reaches."""

from perfbench.readers import scan_pack_roofline


def read(run):
    return scan_pack_roofline(run)
