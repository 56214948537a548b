"""Phase-aware policy of the bounded-loss transport tier (DESIGN.md §12).

``PhaseLossPolicy`` and ``PhaseLossCallback`` are copied from
``repro/dist/policy.py``, which imports JAX at the top.  That module's
``sharding_policy`` context and ``constrain`` hook, which the model forward
passes call for tensor parallelism, come with the sharding slice (ROADMAP
A15).
"""

from __future__ import annotations

__all__ = ["PhaseLossCallback", "PhaseLossPolicy"]


class PhaseLossPolicy:
    """Training-phase-aware schedule for the bounded-loss transport tier.

    Early in training gradients are large and redundant, so the transport
    may accept loss and compress hard; as the loss curve flattens each
    surviving coordinate matters more, so the policy tightens the allowed
    transport loss, the top-k keep fraction, and the error-feedback
    residual bound — the same shape as §5.3's ``Div_max`` enforcement,
    applied to the data plane instead of replica divergence.

    ``phase()`` maps the recent *relative per-step improvement* of the
    observed loss into [0, 1]: 1 = steep descent (early), 0 = flat
    (converged).  With fewer than two observations the policy assumes
    early training (phase 1), i.e. it starts permissive.
    """

    def __init__(self, *, max_loss: float = 0.3, min_loss: float = 0.0,
                 max_keep: float = 1.0, min_keep: float = 0.05,
                 window: int = 8, ref_improvement: float = 0.05,
                 max_bound: float = 1.0, min_bound: float = 0.1):
        if not (0.0 <= min_loss <= max_loss < 1.0):
            raise ValueError(f"need 0 <= min_loss <= max_loss < 1: "
                             f"{min_loss}, {max_loss}")
        if not (0.0 < min_keep <= max_keep <= 1.0):
            raise ValueError(f"need 0 < min_keep <= max_keep <= 1: "
                             f"{min_keep}, {max_keep}")
        if window < 2 or ref_improvement <= 0.0:
            raise ValueError(f"bad window/ref_improvement: "
                             f"{window}, {ref_improvement}")
        self.max_loss, self.min_loss = max_loss, min_loss
        self.max_keep, self.min_keep = max_keep, min_keep
        self.window = int(window)
        self.ref_improvement = ref_improvement
        self.max_bound, self.min_bound = max_bound, min_bound
        self._history: list = []

    def observe(self, value: float) -> None:
        """Feed one loss-curve sample (call once per committed step)."""
        self._history.append(float(value))
        if len(self._history) > self.window:
            del self._history[:-self.window]

    def phase(self) -> float:
        h = self._history
        if len(h) < 2:
            return 1.0
        per_step = (h[0] - h[-1]) / (len(h) - 1)
        rel = per_step / max(abs(h[0]), 1e-12)
        return min(1.0, max(0.0, rel / self.ref_improvement))

    def allowed_loss(self) -> float:
        """Transport byte-loss fraction the trainer currently tolerates
        (what ``TransportConfig.phase_policy`` queries)."""
        p = self.phase()
        return self.min_loss + p * (self.max_loss - self.min_loss)

    def topk_keep(self) -> float:
        """Top-k keep fraction: aggressive early, near-dense when flat."""
        p = self.phase()
        return self.max_keep - p * (self.max_keep - self.min_keep)

    def residual_bound(self, ref_norm: float) -> float:
        """Error-feedback residual-norm ceiling, scaled to ``ref_norm``
        (typically the current gradient norm)."""
        p = self.phase()
        return ref_norm * (self.min_bound
                           + p * (self.max_bound - self.min_bound))


class PhaseLossCallback:
    """Trainer hook adapter: feeds batch-end loss into a PhaseLossPolicy.

    Duck-typed against ``core.harness.HookBus`` (like ``PhaseProfiler``):
    attach to any trainer's ``hooks=`` and the policy tracks the live loss
    curve without the transport tier knowing about the trainer.
    """

    def __init__(self, policy: PhaseLossPolicy, metric: str = "loss"):
        self.policy = policy
        self.metric = metric

    def on_batch_end(self, source, step: int, metrics=None) -> None:
        if metrics and self.metric in metrics:
            self.policy.observe(float(metrics[self.metric]))
