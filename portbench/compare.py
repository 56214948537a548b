"""The comparison that decides ``correct``.

Five numbers, each with a limit of its own in the cell's file under
``portbench/workloads/`` (a number without one there is not compared):

* ``route``: the widest gap by which an expert that the program routed a
  token to lies, in the reference's router probabilities, below the
  reference's k-th best for that token, over the first updates.  The
  reference then follows the program's routes: a free-running comparison
  of two precisions of a mixture of experts measures which tokens flipped
  expert, not the arithmetic.
* ``route_first``: the same, in the first MoE layer alone: its router reads
  an input that has not yet passed through the other layers' rounding, so
  it separates a sound run from a wrong route where the widest gap over
  many layers does not.
* ``loss``: the largest gap, over the first updates, between the program's
  cross entropy and the reference's, over the reference's.
* ``grad``: the worst leaf's gap between the norm of its first gradient as
  the update rule got it and the reference's, over the larger of the
  reference's norm of that leaf and the median leaf's.
* ``change``: the same for each leaf's change over the first updates.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's are left out of ``grad`` and ``change``: they move by
round-off alone.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NUMBERS = ("route", "route_first", "loss", "grad", "change")
QUIET = 1e-3


def _leaf_gaps(prog: List[float], ref: List[float], keep: List[bool]
               ) -> Tuple[float, int]:
    med = statistics.median(r for r, k in zip(ref, keep) if k)
    worst, at = 0.0, -1
    for i, (p, r, k) in enumerate(zip(prog, ref, keep)):
        if not k:
            continue
        gap = abs(p - r) / max(r, med, 1e-30)
        if not math.isfinite(gap) or gap > worst:
            worst, at = gap if math.isfinite(gap) else math.inf, i
    return worst, at


def readings(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """{number: {"value", "where"}} of the program's readings ``prog``
    against the reference's ``ref`` (both as ``reference.train.follow``
    returns them; ``ref`` followed the program's routes)."""
    lp, lr = prog["losses"], ref["losses"]
    loss = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
               for a, b in zip(lp, lr))
    med = statistics.median(ref["first_grad"])
    keep = [g >= QUIET * med for g in ref["first_grad"]]
    out = {"route": {"value": ref["route_gap"], "where": ""},
           "route_first": {"value": ref["route_gaps"][0], "where": ""},
           "loss": {"value": loss, "where": "updates 1-%d" % len(lr)}}
    for name, key in (("grad", "first_grad"), ("change", "change")):
        v, i = _leaf_gaps(prog[key], ref[key], keep)
        out[name] = {"value": v, "where": ref["leaves"][i] if i >= 0 else ""}
    out["_left_out"] = [n for n, k in zip(ref["leaves"], keep) if not k]
    return out


def decide(read: Dict[str, Dict], limits: Dict[str, float]
           ) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {number: {"value", "limit"}}): every number the cell's
    file gives a limit at or under it (a number that is not finite
    fails).  A number without a limit there is not compared."""
    checks = {}
    ok = True
    for name in NUMBERS:
        if name not in limits:
            continue
        v, lim = read[name]["value"], limits[name]
        ok = ok and math.isfinite(v) and v <= lim
        checks[name] = {"value": v, "limit": lim}
    return ok, checks
