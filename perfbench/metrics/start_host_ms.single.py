"""Host milliseconds per request in start_one_dispatch: the pageable upload
into the program's input and the graph replay's launch."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "start")
