"""Host milliseconds per request in the program's dmmt.host_tables spans:
the two-dispatch encode's package-merge tables, their canonical codes and
the stream's exact length (encoder.HuffmanTables.from_histograms). Nothing
where the traced stretch holds none (a program without this span)."""

from perfbench.program_spans import program_span_ms, span_count


def read(run):
    return program_span_ms(run, "dmmt.host_tables") if span_count(run, "dmmt.host_tables") else None
