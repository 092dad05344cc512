"""Host milliseconds per request in the program's dmmt.pack_wait spans: the
two-dispatch encode's wait for its pack replay, before the word fetch
(bitstream/device_pack._checked_bytes). Nothing where the traced stretch
holds none (a program without this span)."""

from perfbench.program_spans import program_span_ms, span_count


def read(run):
    return program_span_ms(run, "dmmt.pack_wait") if span_count(run, "dmmt.pack_wait") else None
