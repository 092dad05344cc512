"""Host milliseconds per request in the program's dmmt.fetch_wait spans:
inside dmmt.word_fetch, the host's wait for the scan's device-to-host
copy, which grows with the scan. Nothing where the traced stretch holds
none (a program without this span)."""

from perfbench.program_spans import program_span_ms, span_count


def read(run):
    return program_span_ms(run, "dmmt.fetch_wait") if span_count(run, "dmmt.fetch_wait") else None
