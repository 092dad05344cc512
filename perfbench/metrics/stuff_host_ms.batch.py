"""Host milliseconds per request in the program's dmmt.stuff spans: the
scan trimmed, padded and byte-stuffed (finalize_scan_bytes)."""

from perfbench.program_spans import program_span_ms


def read(run):
    return program_span_ms(run, "dmmt.stuff")
