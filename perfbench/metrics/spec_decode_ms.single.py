"""Host milliseconds per request in the program's dmmt.spec_decode spans:
the device table spec decoded into host Huffman tables (tables_from_spec)."""

from perfbench.program_spans import program_span_ms


def read(run):
    return program_span_ms(run, "dmmt.spec_decode")
