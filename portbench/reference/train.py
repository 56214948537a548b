"""The reference's training: the first steps or commits of a cell, from the
run's seed, in float32 with TF32 off.

Each update is the gradient of the reference loss (``model.loss``) through
the int8 wire (``wire.tree_roundtrip``) and the eq.-2 rule ``h = -lr * g +
gamma * h``, ``p = p + h``.  The parameters are kept as the configuration
stores them, in bfloat16: each new ``p`` is rounded to it, as a bfloat16
model's step stores its sum (arithmetic stays float32).  MLfabric-A
computes each committed update against the version it was pulled at, and
commits them in the order given (the control plane's schedule, which the
reference does not work out: see ``portbench/harness.py``).

It returns what the comparison reads: each update's cross entropy, the
norm of each leaf's first gradient as the update rule gets it, and the
norm of each leaf's change over all the updates.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..weights import leaf_specs, make_leaf
from . import model, wire

PIECE = 2 ** 26


def _tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _store_(p: torch.Tensor, h: torch.Tensor, dtype: torch.dtype) -> None:
    """p <- p + h as ``dtype`` stores it, a piece at a time."""
    pf, hf = p.view(-1), h.view(-1)
    for i in range(0, pf.numel(), PIECE):
        pf[i:i + PIECE] = (pf[i:i + PIECE] + hf[i:i + PIECE]).to(
            dtype).to(torch.float32)


def _grads(params: Dict, order: Sequence, batch, s, precision: str,
           given) -> Tuple[List[torch.Tensor], Dict]:
    live = {k: params[k].detach().requires_grad_(True) for k in order}
    out = model.loss(live, batch, s, precision, given)
    grads = list(torch.autograd.grad(out.pop("total"),
                                     [live[k] for k in order]))
    return grads, out


def distance(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| in f32, a piece at a time."""
    af, bf = a.reshape(-1), b.reshape(-1)
    sq = torch.zeros((), dtype=torch.float64, device=a.device)
    for i in range(0, af.numel(), PIECE):
        d = af[i:i + PIECE].float() - bf[i:i + PIECE].float()
        sq += torch.sum(d * d, dtype=torch.float64)
    return float(torch.sqrt(sq))


def _change_norms(params: Dict, order: Sequence, s, seed: int, device
                  ) -> List[float]:
    out = []
    for i, spec in enumerate(leaf_specs(s)):
        p0 = make_leaf(spec, i, seed, device)
        out.append(distance(params[spec.path], p0))
        del p0
    return out


def follow(s: Dict, seed: int, device, *, batch_fn: Callable[[int], Dict],
           lr: float, gamma: float, layout: str,
           versions: Optional[Sequence[int]] = None, n: int = 3,
           precision: str = "f32", store: torch.dtype = torch.bfloat16,
           routes: Optional[Sequence] = None) -> Dict:
    """The first ``n`` updates.  ``batch_fn(i)`` gives update i's batch
    (i = 0 ..); ``versions[i]`` the version update i was computed against
    (default: the one before it, as in a synchronous step).  ``store`` is
    the type the parameters are kept in (the router's leaf is f32 in any
    case).  ``routes[i]``, where given, holds update i's routes, one entry
    a layer, which the reference judges and follows (``model.routes``);
    the result's ``routes`` are those it took, ``route_gaps`` each layer's
    widest gap of a followed route over the updates, and ``route_gap``
    the widest of those."""
    _tf32_off()
    specs = leaf_specs(s)
    order = [spec.path for spec in specs]
    params = {spec.path: make_leaf(spec, i, seed, device, torch.float32)
              for i, spec in enumerate(specs)}
    kept_as = {spec.path: store if spec.dtype == torch.bfloat16
               else spec.dtype for spec in specs}
    versions = list(range(n)) if versions is None else list(versions)[:n]
    # versions an update is computed against after later ones exist
    keep = {v: None for i, v in enumerate(versions) if v < i}
    hist = {k: torch.zeros_like(params[k]) for k in order}
    losses, first, taken = [], None, []
    gaps = [0.0] * s["n_layers"]
    for i in range(n):
        if i in keep:
            keep[i] = {k: t.clone() for k, t in params.items()}
        at = params if versions[i] == i else keep[versions[i]]
        grads, out = _grads(at, order, batch_fn(i), s, precision,
                            None if routes is None else routes[i])
        losses.append(float(out["ce"]))
        taken.append(out["routes"])
        gaps = [max(a, float(b)) for a, b in zip(gaps, out["route_gaps"])]
        grads = wire.tree_roundtrip(grads, layout)
        if first is None:
            first = [float(torch.linalg.vector_norm(g)) for g in grads]
        with torch.no_grad():
            for k, g in zip(order, grads):
                hist[k].mul_(gamma).add_(g, alpha=-lr)
                _store_(params[k], hist[k], kept_as[k])
        del grads
    del hist, keep
    change = _change_norms(params, order, s, seed, device)
    return {"losses": losses, "first_grad": first, "change": change,
            "leaves": ["/".join(k) for k in order], "routes": taken,
            "route_gaps": gaps, "route_gap": max(gaps)}
