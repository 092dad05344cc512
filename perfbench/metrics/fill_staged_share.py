"""Share of the program's dmmt.fill spans in the traced stretch in which
the card's pinned ring carried a host array (a dmmt.fill_staged span): 1
where every fill uploads a host frame through the ring, 0 where no fill
does (a device tensor filled, or a program without the ring). Nothing
where the stretch holds no dmmt.fill span."""

from perfbench.program_spans import span_count


def read(run):
    fills = span_count(run, "dmmt.fill")
    if not fills:
        return None
    return span_count(run, "dmmt.fill_staged") / fills
