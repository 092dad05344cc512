"""Host milliseconds per request in the program's dmmt.bits_wait spans:
finish_one_dispatch waiting for the copy of the bit count and table spec."""

from perfbench.program_spans import program_span_ms


def read(run):
    return program_span_ms(run, "dmmt.bits_wait")
