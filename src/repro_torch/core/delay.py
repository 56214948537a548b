"""Delay management (paper §3.1, §10.4).

Asynchronous SGD applies update ``u`` computed from model version ``v(u)`` to
model version ``v_now``; the *delay* is ``tau = v_now - v(u)``.  The paper's
convergence result (eq. 4): with delay ~ Uniform[tau_bar - eps, tau_bar + eps]
and a delay-adaptive step size, the expected optimality gap shrinks as
``O(eps * sqrt(t + tau_bar - eps) / t)`` — so *narrowing* the delay
distribution (small eps) gives a constant-factor convergence speed-up, which
is what network-based ordering buys.

This module provides: the delay-adaptive learning-rate rules, a tracker for
empirical delay distributions, and the theoretical-bound helpers used by the
tests (property: smaller eps => smaller bound, eq. 4 monotonicity).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


def adadelay_lr(base_lr: float, t: int, tau: int, c: float = 1.0) -> float:
    """AdaDelay [31] step size: ``eta_t = C / (c * sqrt(t + tau))``.

    Each update's step size shrinks with *its own* observed delay, so stale
    updates take smaller steps.
    """
    return base_lr / (c * math.sqrt(max(t + tau, 1)))


def bounded_delay_lr(base_lr: float, t: int, tau_max: int, c: float = 1.0) -> float:
    """[7]-style conservative rule ``eta = C / sqrt(tau_max * t)``: the step
    size is set from the *worst-case* delay — the baseline MLfabric improves
    on by shrinking the worst case itself."""
    return base_lr / (c * math.sqrt(max(tau_max * t, 1)))


def convergence_bound(t: int, tau_bar: float, eps: float, scale: float = 1.0) -> float:
    """Eq. 4: ``O(eps * sqrt(t + tau_bar - eps) / t)`` (+ the eps-free
    constant term folded into ``scale``).  Used in tests/benchmarks to check
    the smaller-eps-is-better monotonicity the scheduler exploits."""
    if t <= 0:
        return float("inf")
    return scale * (1.0 + eps * math.sqrt(max(t + tau_bar - eps, 1.0))) / t


@dataclass
class DelayTracker:
    """Empirical delay distribution at the server (per-update taus)."""

    taus: List[int] = field(default_factory=list)

    def record(self, tau: int) -> None:
        self.taus.append(tau)

    @property
    def count(self) -> int:
        return len(self.taus)

    @property
    def mean(self) -> float:
        return sum(self.taus) / len(self.taus) if self.taus else 0.0

    @property
    def max(self) -> int:
        return max(self.taus) if self.taus else 0

    @property
    def variance(self) -> float:
        if not self.taus:
            return 0.0
        m = self.mean
        return sum((t - m) ** 2 for t in self.taus) / len(self.taus)

    @property
    def half_width(self) -> float:
        """Empirical ``eps``: half the spread of the delay distribution."""
        if not self.taus:
            return 0.0
        return (max(self.taus) - min(self.taus)) / 2.0

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean, "max": float(self.max),
                "variance": self.variance, "eps": self.half_width}
