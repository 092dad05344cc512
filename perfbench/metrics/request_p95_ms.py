"""95th percentile of the requests' latencies (call to bytes returned)."""

from perfbench.readers import p95_ms


def read(run):
    return p95_ms(run)
