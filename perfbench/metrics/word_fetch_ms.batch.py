"""Host milliseconds per request in the program's dmmt.word_fetch spans:
the scan's words copied to pinned host memory and waited for."""

from perfbench.program_spans import program_span_ms


def read(run):
    return program_span_ms(run, "dmmt.word_fetch")
