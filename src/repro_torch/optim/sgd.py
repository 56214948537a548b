"""Momentum SGD matching the paper's server update rule (eq. 2).

    w_{t+1} = w_t + u_t + gamma * (w_t - w_{t-1})

with ``u = -eta * grad`` this is heavy-ball momentum kept as the history
``h = w_t - w_{t-1}`` (``repro/optim/sgd.py``).  ``momentum_sgd_update`` is
the in-graph step's optimizer and returns new tensors, like the reference;
``momentum_sgd_update_`` writes the same values, bit for bit, into the
params and history it is given (the reference's donation of both to its
jitted step); the parameter server applies the rule in place its own way
(``ps/server.py``).  ``update_norm`` is the norm workers ship with
``push()`` (paper Table 1).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..obs.trace import region
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Params = Any

# f32 elements of one piece of the in-place update: each of its temporaries
# is at most 256 MiB, whatever the leaf (one deepseek-v2 expert weight is
# 1.26 G elements)
CHUNK = 2 ** 26


class MomentumState(NamedTuple):
    history: Params          # h = w_t - w_{t-1}, f32


def momentum_sgd_init(params: Params) -> MomentumState:
    """Zero f32 history laid out as each param (a DTensor param gets a
    DTensor history with its placements)."""
    return MomentumState(history=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32,
                                   memory_format=torch.contiguous_format),
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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the storage it updates), a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _pieces(t: torch.Tensor, chunk: int):
    """Contiguous ``t`` as consecutive flat views of at most ``chunk``
    elements."""
    flat = t.view(-1)
    return [flat[i:i + chunk] for i in range(0, flat.numel(), chunk)]


@torch.no_grad()
def momentum_sgd_update_(params: Params, grads: Params, state: MomentumState,
                         *, lr: float, gamma: float = 0.9,
                         weight_decay: float = 0.0, chunk: int = CHUNK,
                         ) -> Tuple[Params, MomentumState]:
    """``momentum_sgd_update`` in place: every param leaf and its f32
    history are overwritten with the values the functional update returns,
    bit for bit (the same operations in the same order: ``-lr * g`` and
    ``gamma * h`` as two products, then their sum, with no fused
    multiply-add), and ``(params, state)`` themselves are returned.  Each
    leaf is worked in pieces of ``chunk`` elements, so no temporary is
    larger than one piece in f32.  A DTensor leaf is updated on its local
    shard.  Read nothing that aliases a param or its history during the
    update (e.g. a graph that saved them)."""
    with region("mlfabric.update"):
        for p, g, h in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state.history)):
            leaf = (_local(p), _local(g), _local(h))
            if all(x.is_contiguous() for x in leaf):
                leaf = [_pieces(x, chunk) for x in leaf]
            else:                  # one piece, the whole leaf
                leaf = [[x] for x in leaf]
            for pc, gc, hc in zip(*leaf):
                gf = gc.to(torch.float32)
                if weight_decay:
                    gf = gf + weight_decay * pc.to(torch.float32)
                hc.copy_(-lr * gf + gamma * hc)
                del gf
                pc.copy_(pc.to(torch.float32) + hc)
    return params, state


def update_norm(update: Params) -> torch.Tensor:
    """||u||_2 over the whole update tree, accumulated in f32 — the norm the
    scheduler's divergence bound reads."""
    sq = sum(torch.sum(torch.square(u.to(torch.float32)))
             for u in tree_leaves(update))
    return torch.sqrt(sq)
