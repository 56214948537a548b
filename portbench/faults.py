"""Faults planted in the program's timed path, for the benchmark's own
test (each must turn ``correct`` false) and for the readings that set the
limits' upper ends (``calibrate.py``).  The benchmark's runs never plant
one.

Each fault replaces a name of the port's where its caller looks it up, and
``planted`` puts every name back on leaving:

* ``"stale"``: the update rule returns its state unchanged (the step's
  ``momentum_sgd_update_``; MLfabric-A's ``ParameterServer.push`` only
  counts the version).
* ``"half_batch"``: the gradient is taken over the first half of each
  batch's rows, the mean over those alone (``value_and_grad`` where the
  step and MLfabric-A's worker call it).
* ``"altered"``: the largest leaf's gradient is scaled by 1.5 where it
  leaves the wire (the step's ``unpack_reduced``; MLfabric-A's
  ``flat_compress_roundtrip``).
* ``"route"``: every expert the router picks is replaced by the next one,
  ``(id + 1) % E`` (``models/moe.py:router_topk``), the gates kept.

Plant a fault before the runner is built: the traced runs' ranges and the
route log then wrap the planted names.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

FAULTS = ("stale", "half_batch", "altered", "route")


def _half(fn):
    def value_and_grad(loss_fn, params, batch, **kw):
        batch = {k: v[:max(v.shape[0] // 2, 1)] for k, v in batch.items()}
        return fn(loss_fn, params, batch, **kw)
    return value_and_grad


def _scale_largest(tree):
    from repro_torch.tree import tree_leaves
    max(tree_leaves(tree), key=lambda x: x.numel()).mul_(1.5)
    return tree


def _patches(name: str):
    """(owner, attribute, replacement) of the fault ``name``."""
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.ps import async_trainer, server, worker
    if name == "stale":
        def push(self, update, version_used):
            self.version += 1
            return self.version
        return [(steps, "momentum_sgd_update_",
                 lambda p, g, st, **kw: (p, st)),
                (server.ParameterServer, "push", push)]
    if name == "half_batch":
        return [(steps, "value_and_grad", _half(steps.value_and_grad)),
                (worker, "value_and_grad", _half(worker.value_and_grad))]
    if name == "altered":
        unpack = steps.unpack_reduced
        roundtrip = async_trainer.flat_compress_roundtrip

        def altered(tree):
            out, norm = roundtrip(tree)
            return _scale_largest(out), norm
        return [(steps, "unpack_reduced",
                 lambda *a, **k: _scale_largest(unpack(*a, **k))),
                (async_trainer, "flat_compress_roundtrip", altered)]
    if name == "route":
        topk = moe.router_topk

        def router_topk(probs, k):
            vals, idx = topk(probs, k)
            return vals, (idx + 1) % probs.shape[-1]
        return [(moe, "router_topk", router_topk)]
    raise ValueError(f"no fault {name!r}; the faults are {FAULTS}")


@contextlib.contextmanager
def planted(name: Optional[str]) -> Iterator[None]:
    """The program with the fault ``name`` planted (none for ``None``)."""
    if name is None:
        yield
        return
    undo = []
    try:
        for owner, attr, fn in _patches(name):
            undo.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, fn)
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)
