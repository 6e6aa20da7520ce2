"""Host milliseconds per line inside the ``binarize_images`` calls (resize,
tiling, UNet, stitch), from the benchmark's spans around them."""


def read(run):
    return run.span_s("binarize") * 1e3 / run.lines if run.lines else None
