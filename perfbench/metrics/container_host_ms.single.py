"""Host milliseconds per request in the program's dmmt.container spans:
the JFIF container around each scan (assemble_jpeg)."""

from perfbench.program_spans import program_span_ms


def read(run):
    return program_span_ms(run, "dmmt.container")
