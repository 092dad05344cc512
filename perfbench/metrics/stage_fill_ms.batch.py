"""Host milliseconds per request in the program's dmmt.stage_fill spans:
the frames copied into the pinned staging buffer (encoder._upload)."""

from perfbench.program_spans import program_span_ms


def read(run):
    return program_span_ms(run, "dmmt.stage_fill")
