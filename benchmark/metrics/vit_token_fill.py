"""Per cent of the ViT's token rows that were glyphs: the traced calls'
glyph rows x (positions + 1, the CLS token) over the program's
``encoder_tokens`` (the rows of each ViT batch, pad rows included, x its
tokens). 100 while the ViT runs the real rows alone; it falls where its
batch is padded or bucketed."""

import encoders
from harness import program


def read(run):
    c = program.counters()
    if not c or not c.get("encoder_tokens"):
        return None
    s = run.config["strokes"]
    tokens = encoders.family(s["encoder_arch"]).positions(s) + 1
    return sum(x["rows"] for x in run.calls) * tokens / c["encoder_tokens"] * 100.0
