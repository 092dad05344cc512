"""Host milliseconds per request in the program's dmmt.hist_wait spans: the
two-dispatch encode's wait for its first half and the histograms' one copy
(encoder._materialize_histograms). Nothing where the traced stretch holds
none (a program without this span)."""

from perfbench.program_spans import program_span_ms, span_count


def read(run):
    return program_span_ms(run, "dmmt.hist_wait") if span_count(run, "dmmt.hist_wait") else None
