"""Host milliseconds per request in encoder._upload: the copies into the
pinned staging ring and the upload's enqueue."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "upload")
