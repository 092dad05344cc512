"""Percent of the traced stretch in which no kernel runs on the card."""

from perfbench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
