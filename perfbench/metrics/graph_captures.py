"""Program instances captured in the traced stretch: the program's
dmmt.capture spans there (0 where it holds program spans but no capture)."""

from perfbench.program_spans import span_count


def read(run):
    return span_count(run, "dmmt.capture")
