"""The card's busy milliseconds per line inside the ``process_images``
calls less the decode kernel's: the crop gather, the encoder, the
projection and the copies."""

DECODE_KERNELS = ("greedy_decode_kernel", "beam_decode_kernel")


def read(run):
    if not run.lines:
        return None
    decode = sum(run.kernel_s(k, within="strokes") for k in DECODE_KERNELS)
    return (run.busy_in("strokes") - decode) * 1e3 / run.lines
