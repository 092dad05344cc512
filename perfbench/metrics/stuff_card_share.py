"""Share of the program's dmmt.stuff spans in the traced stretch whose scan
came stuffed from the card (a dmmt.stuff_card span): 1 where every finish
copies the card's stuffed bytes, 0 where the host stuffs every scan (a
program without the card's stuffing). Nothing where the stretch holds no
dmmt.stuff span."""

from perfbench.program_spans import span_count


def read(run):
    stuff = span_count(run, "dmmt.stuff")
    if not stuff:
        return None
    return span_count(run, "dmmt.stuff_card") / stuff
