"""Device milliseconds per request of its CUDA graph replays."""

from perfbench.readers import replay_device_ms


def read(run):
    return replay_device_ms(run)
