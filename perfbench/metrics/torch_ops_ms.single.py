"""Device milliseconds per request of the replayed kernels that are not the
port's csrc kernels: the device table build and the torch glue."""

from perfbench.readers import torch_ops_ms


def read(run):
    return torch_ops_ms(run)
