"""Per cent of the sums the tensor-core decode path rounds that it
recomputed in float64 because its error bound straddled a rounding: the
program's ``decode_fixed_elements`` (the launches' ``fixstat``) over
``decode_fix_checked`` (every element whose rounding the bound decides).
None where no launch ran on the tensor cores."""

from harness import program


def read(run):
    c = program.counters()
    if not c or not c.get("decode_fix_checked"):
        return None
    return c["decode_fixed_elements"] / c["decode_fix_checked"] * 100.0
