"""Host milliseconds per request in the program's dmmt.word_fetch spans: in
the two-dispatch encode, the copy of the scan's words to host memory once
the pack is done (bitstream/device_pack._checked_bytes). Nothing where the
traced stretch holds none (a program without this span)."""

from perfbench.program_spans import program_span_ms, span_count


def read(run):
    return program_span_ms(run, "dmmt.word_fetch") if span_count(run, "dmmt.word_fetch") else None
