"""Phase-aware policy of the bounded-loss transport tier (DESIGN.md §12),
and the activation-layout policy the model code queries.

``PhaseLossPolicy`` and ``PhaseLossCallback`` are copied from
``repro/dist/policy.py``, which imports JAX at the top.

Model forward passes are written once and call ``constrain(x, "residual")``
at layout-critical points; *which* layout that means is decided per
(mesh x shape) cell by ``dist.sharding.activation_policy`` and bound with
the ``sharding_policy`` context manager in the step builders.  With no
policy bound, or on a plain tensor, ``constrain`` is the identity, so model
code never depends on a mesh being present.  Where a policy is bound and
``x`` is a DTensor, ``constrain`` redistributes it to the fitted spec's
placements: the port's counterpart of ``with_sharding_constraint``.  A
layout that cannot be applied raises; nothing falls back to the
unconstrained value.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

import torch

__all__ = ["PartitionSpec", "PhaseLossCallback", "PhaseLossPolicy",
           "constrain", "current_policy", "sharding_policy"]

_STACK = threading.local()


class PartitionSpec:
    """One entry per tensor dim: a mesh axis name, a tuple of names (the
    dim split over several axes, the first one major), or None
    (replicated): ``jax.sharding.PartitionSpec``'s meaning.  It iterates
    and compares like the tuple of its entries, but is not a tuple, so the
    port's tree functions (``repro_torch/tree.py``) keep it as one leaf, as
    ``jax.tree_util`` keeps a ``PartitionSpec``."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


def _stack() -> list:
    if not hasattr(_STACK, "policies"):
        _STACK.policies = []
    return _STACK.policies


@contextmanager
def sharding_policy(mesh, act: Dict[str, PartitionSpec]) -> Iterator[None]:
    """Bind an activation policy ``{name: PartitionSpec}`` for ``mesh``.

    Nestable; the innermost binding wins.  The specs are *hints*: at
    ``constrain`` time any axis that does not evenly divide the matching
    tensor dimension is dropped rather than erroring, so one policy dict
    serves train / prefill / decode shapes alike.
    """
    _stack().append((mesh, dict(act)))
    try:
        yield
    finally:
        _stack().pop()


def current_policy() -> Optional[Tuple[object, Dict[str, PartitionSpec]]]:
    s = _stack()
    return s[-1] if s else None


def _axis_size(mesh, entry) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for name in names:
        n *= mesh.shape[name]
    return n


def _fit_spec(mesh, spec: PartitionSpec, shape: Tuple[int, ...]
              ) -> PartitionSpec:
    """Rank-adjust ``spec`` to ``shape`` and drop non-dividing axes."""
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    entries = entries[:len(shape)]
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None or dim % _axis_size(mesh, entry) != 0:
            out.append(None)
        else:
            out.append(entry)
    return PartitionSpec(*out)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """Apply the active policy's layout for ``name`` to a DTensor ``x``:
    ``x`` redistributed to the fitted spec's placements over its own
    mesh.  The identity for a plain tensor, with no policy bound, when the
    policy has no entry for ``name``, or when no axis of the spec fits
    (as the reference skips an all-None constraint)."""
    pol = current_policy()
    if pol is None:
        return x
    mesh, act = pol
    spec = act.get(name)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from .sharding import mesh_view, on_axes, placements
    # fitted against the mesh x lives on: the full mesh's axes above 1, or
    # the model submesh of the MLfabric step's forward
    dm = mesh_view(x.device_mesh)
    fitted = _fit_spec(dm, on_axes(spec, dm.axis_names), tuple(x.shape))
    if all(e is None for e in fitted):
        return x
    return x.redistribute(x.device_mesh, placements(dm, fitted))


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
