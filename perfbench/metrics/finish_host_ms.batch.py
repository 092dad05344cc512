"""Host milliseconds per request in finish_one_dispatch and _jpeg: the bit
count's wait, the word fetch, stuffing and the JFIF container."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "finish", "jpeg")
