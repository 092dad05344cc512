"""Host milliseconds per request in the program's dmmt.fill spans: the
pageable copy of the frame into the program's input (onedispatch.copy_in)."""

from perfbench.program_spans import program_span_ms


def read(run):
    return program_span_ms(run, "dmmt.fill")
