"""The card's busy milliseconds per line inside the ``binarize_images``
calls: the UNet's convolutions, the device cut and stitch, the copies."""


def read(run):
    return run.busy_in("binarize") * 1e3 / run.lines if run.lines else None
