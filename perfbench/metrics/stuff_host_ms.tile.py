"""Host milliseconds per request in the program's dmmt.stuff spans: the scan
trimmed, padded and byte-stuffed (finalize_scan_bytes), here for the
two-dispatch encode's pack (bitstream/device_pack._checked_bytes). Nothing
where the traced stretch holds none (a program without this span)."""

from perfbench.program_spans import program_span_ms, span_count


def read(run):
    return program_span_ms(run, "dmmt.stuff") if span_count(run, "dmmt.stuff") else None
