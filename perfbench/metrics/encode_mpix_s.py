"""Megapixels per second of every request completed correctly in the window."""


def read(run):
    return run.pixels_ok / run.window_s / 1e6 if run.window_s > 0 else None
