"""K2's share of its roofline: as ``k1_roofline``, for the beam decodes,
each image's beams counted for the steps until its last beam finished."""

import counts

KERNEL = "beam_decode_kernel"


def read(run):
    if run.traffic["decode"] != "beam" or not run.has_kernel(KERNEL):
        return None
    k = run.traffic["beam_size"]
    return counts.decode_bound_s(run.calls, run.config["strokes"], k) / run.kernel_s(KERNEL) * 100.0
