"""Per cent of the decode launches' row-step slots that a row needed: the
program's ``decode_row_steps`` (each greedy row through its first EOS, each
image's beams until its last one finished) over ``decode_row_slots`` (the
steps each launch ran, the most any of its rows needed, x its rows). The
rest is the tail that rows still decoding keep the grid stepping for."""

from harness import program


def read(run):
    c = program.counters()
    if not c or not c.get("decode_row_slots"):
        return None
    return c["decode_row_steps"] / c["decode_row_slots"] * 100.0
