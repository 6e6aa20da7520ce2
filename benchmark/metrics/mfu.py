"""The whole step's share of the card's bf16 peak: the model operations the
traced calls' inputs needed (the UNet over their tiles, the encoder and
the projection over their glyph crops, the decoder for the steps each row
or beam ran) over the traced window x 989 TFLOP/s."""

import counts
import encoders


def read(run):
    b, s = run.config["binarizer"], run.config["strokes"]
    k = run.traffic["beam_size"] if run.traffic["decode"] == "beam" else 1
    encoder = encoders.family(s["encoder_arch"])
    p = encoder.positions(s)
    width = encoder.width(s)
    e = s["projection_dim"] or width
    unet = counts.unet_flops(b["features"], b["bottleneck"], b["channels"], b["height"], b["width"])
    row = (encoder.flops(s)
           + (counts.projection_flops(p, width, e) if s["projection_dim"] else 0)
           + counts.decoder_row_flops(p, e, s["attention_dim"], s["decoder_dim"]))
    step = counts.decoder_step_flops(p, e, s["attention_dim"], s["decoder_dim"], s["embed_dim"],
                                     3 + 2 * s["image_size"])
    flops = sum(c["tiles"] * unet + c["rows"] * row + k * sum(c["steps"]) * step
                for c in run.calls)
    return flops / (run.window_s * counts.PEAK_FLOPS["bfloat16"]) * 100.0
