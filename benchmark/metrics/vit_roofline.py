"""The ViT's share of its roofline: the operations the traced calls' glyph
crops needed through the encoder (``encoders/vit.py:flops`` x the calls'
``rows``) over the bf16 peak, divided by the encoder's device time, read as
``encoder_busy_ms_per_img`` reads it (the card's busy time inside the
``process_images`` calls less the decode kernel's). The operations bound
is the roofline: a page's bytes (the 0.6 GB of bf16 weights read once, the
crops and the features) take over 100x less time at the HBM bandwidth than
its operations at the peak (0.3 against 60 ms). The crop gather, the
normalization, the projection and the copies are in the denominator too,
so the share is a floor of the ViT's own."""

import counts
import encoders
from harness.cell import metric_reader


def read(run):
    s = run.config["strokes"]
    fam = encoders.family(s["encoder_arch"])
    rows = sum(c["rows"] for c in run.calls)
    busy_ms = metric_reader("encoder_busy_ms_per_img")(run)
    if not rows or not busy_ms:
        return None
    bound_s = rows * fam.flops(s) / counts.PEAK_FLOPS["bfloat16"]
    return bound_s / (busy_ms * run.lines / 1e3) * 100.0
