"""K1's share of its roofline: the least time the card could take for the
traced calls' greedy decodes (the larger of their bytes read and written
once over the HBM bandwidth, and their operations for the steps each row
ran over the bf16 peak; ``counts.decode_cost``) over K1's device time in
the trace. None where the trace holds no K1 launch."""

import counts

KERNEL = "greedy_decode_kernel"


def read(run):
    if run.traffic["decode"] != "greedy" or not run.has_kernel(KERNEL):
        return None
    return counts.decode_bound_s(run.calls, run.config["strokes"], 1) / run.kernel_s(KERNEL) * 100.0
