"""MiB of graph memory the program's captured instances hold at the end of
the window (onedispatch.graph_bytes)."""


def read(run):
    t = run.trace
    return t.graph_bytes / 2**20 if t is not None and t.graph_bytes else None
