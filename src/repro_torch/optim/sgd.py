"""Momentum SGD matching the paper's server update rule (eq. 2).

    w_{t+1} = w_t + u_t + gamma * (w_t - w_{t-1})

with ``u = -eta * grad`` this is heavy-ball momentum kept as the history
``h = w_t - w_{t-1}`` (``repro/optim/sgd.py``).  ``momentum_sgd_update`` is
the in-graph step's optimizer and returns new tensors, like the reference;
the parameter server applies the same rule in place (``ps/server.py``).
``update_norm`` is the norm workers ship with ``push()`` (paper Table 1).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Params = Any


class MomentumState(NamedTuple):
    history: Params          # h = w_t - w_{t-1}, f32


def momentum_sgd_init(params: Params) -> MomentumState:
    return MomentumState(history=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


@torch.no_grad()
def momentum_sgd_update(params: Params, grads: Params, state: MomentumState,
                        *, lr: float, gamma: float = 0.9,
                        weight_decay: float = 0.0,
                        ) -> Tuple[Params, MomentumState]:
    """One eq.-2 step; returns new params and state, the inputs are left
    as they are.  Gradients may be bf16; the history is f32 and the params
    are summed in f32 and cast back to their dtype."""
    p_flat, treedef = tree_flatten(params)
    g_flat, h_flat = tree_leaves(grads), tree_leaves(state.history)
    new_p, new_h = [], []
    for p, g, h in zip(p_flat, g_flat, h_flat):
        gf = g.to(torch.float32)
        if weight_decay:
            gf = gf + weight_decay * p.to(torch.float32)
        h_new = -lr * gf + gamma * h
        new_p.append((p.to(torch.float32) + h_new).to(p.dtype))
        new_h.append(h_new)
    return (tree_unflatten(treedef, new_p),
            MomentumState(history=tree_unflatten(treedef, new_h)))


def update_norm(update: Params) -> torch.Tensor:
    """||u||_2 over the whole update tree, accumulated in f32 — the norm the
    scheduler's divergence bound reads."""
    sq = sum(torch.sum(torch.square(u.to(torch.float32)))
             for u in tree_leaves(update))
    return torch.sqrt(sq)
