"""``wire_kernel_roofline``: the wire kernels' share of their bound: the
least time of every ``quantize`` and ``dequant_aggregate`` launch of the
window (its bytes, inputs read once and outputs written once, counted by
the benchmark as the program calls them, at 3.35 TB/s) over their device
time.  The launches are matched to the trace's kernels in launch order; a
window whose counts disagree reads nothing."""

import re

from portbench.flops import bound_s

NAMES = {k: re.compile(r"(^|[^a-z_])%s_kernel\b" % k)
         for k in ("quantize", "dequant_aggregate")}


def read(ctx):
    calls = ctx.trace.wire
    if not calls:
        return None
    bound = measured = 0.0
    for kind, pat in NAMES.items():
        seen = [d for name, _, d, _ in sorted(ctx.trace.in_window(),
                                               key=lambda o: o[1])
                if pat.search(name)]
        want = [c["bytes"] for c in calls if c["kernel"] == kind]
        if len(seen) != len(want) or not seen:
            return None
        bound += sum(bound_s(b) for b in want)
        measured += sum(seen)
    return 100.0 * bound / measured
