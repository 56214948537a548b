"""Mixture-of-Experts with capacity-based one-hot dispatch (GShard-style):
the reference's ``repro/models/moe.py`` in PyTorch.

The router is an f32 ``[d, E]`` matrix even in a bf16 model: softmax over
the experts in f32, top-k with the gates renormalized, and the
load-balancing auxiliary loss ``E * sum(mean prob * top-1 share)`` over the
whole sequence.  Experts are stacked ``[E, d, f]`` (``[L, E, d, f]`` in the
decoder's stack) and run as a gated MLP of ``cfg.act``; an optional shared
expert is a dense gated MLP that always runs.

The sequence is cut into chunks of ``chunk`` tokens, and each (batch row,
chunk) is an independent dispatch group with its own capacity
``ceil(tokens * top_k / E * capacity_factor)``: top-k choices claim slots
choice by choice in token order, and a token whose expert is full is
dropped for that choice.  Dispatch and combine are one-hot einsums, as in
the reference (plain tensor algebra there too, outside any kernel).  The
reference scans over the chunks so that the ``[B, T, E, C]`` one-hots stay
small; here the chunks are folded into the batch dimension, so one pass
builds every group's one-hots at once.  Groups are independent: folding
them changes no slot.

On a ``model`` axis (DTensors) the router runs on each rank's own block
of the residual (per token: it needs no other rank's rows), and the
load-balance loss's two means are sums of the ranks' blocks reduced over
the axes that split the tokens.  The experts split over ``model`` then
run on each rank's own groups (its batch rows, the sequence made whole)
and its own experts (``layers.on_local_blocks``), the one-hots built
there for those groups and experts only, their outputs a partial sum
over ``model``.  In the data-axis "auto" step (``global_batch_stats``)
the load-balance loss's two means are taken over the global batch.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from .layers import (Params, activation, apply_mlp, dense, init_mlp,
                     is_dtensor, normal, on_local_blocks, whole_rows,
                     whole_rows_grad)

__all__ = ["capacity", "global_batch_stats", "init_moe", "moe_forward",
           "router_topk"]


def capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    c = int(math.ceil(tokens_per_group * moe.top_k / moe.n_experts
                      * moe.capacity_factor))
    return max(c, 1)


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int], *,
             dtype: torch.dtype, device: torch.device) -> Params:
    """MoE params with leading dims ``lead``: ``router`` [.., d, E] in f32,
    ``w_gate``/``w_up`` [.., E, d, f] and ``w_down`` [.., E, f, d] in
    ``dtype``, all drawn with std 1/sqrt(d) as the reference draws them,
    and ``shared`` (the dense MLP of width f * n_shared) when the config has
    shared experts."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_expert, moe.n_experts
    lead = tuple(lead)
    std = 1.0 / math.sqrt(d)
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "router": normal(gen, lead + (d, e), std, dtype=torch.float32,
                         device=device),
        "w_gate": normal(gen, lead + (e, d, f), std, **kw),
        "w_up": normal(gen, lead + (e, d, f), std, **kw),
        "w_down": normal(gen, lead + (e, f, d), std, **kw),
    }
    if moe.n_shared:
        p["shared"] = init_mlp(gen, lead, d, f * moe.n_shared, act=cfg.act,
                               bias=False, **kw)
    return p


def router_topk(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest in descending
    order, equal values lower index first (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_chunk(x: torch.Tensor, router_probs: torch.Tensor,
                    moe: MoEConfig, cap: int,
                    experts: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch, combine) one-hots for groups ``[G, T, d]``.

    dispatch: [G, T, E', C] in {0, 1} of x's dtype; combine: dispatch
    times the renormalized gate, f32.  Top-k choices claim capacity slots
    in priority order (GShard): every token's first choice, then every
    token's second, each in token order.  The top-k is taken over every
    expert of ``router_probs``; the one-hots hold the columns of
    ``experts`` (ids, all E by default) only.  An expert's slots depend
    on its own claims alone, so a block of its columns is the whole
    one-hots' block."""
    g, t, e = router_probs.shape
    if experts is None:
        experts = torch.arange(e, device=x.device)
    gates, idx = router_topk(router_probs, moe.top_k)           # [G,T,K]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    n = experts.shape[0]
    slots = torch.arange(cap, device=x.device)
    counts = torch.zeros((g, n), dtype=torch.int64, device=x.device)
    dispatch = torch.zeros((g, t, n, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros((g, t, n, cap), dtype=torch.float32,
                          device=x.device)
    for choice in range(moe.top_k):
        onehot = (idx[..., choice, None] == experts).to(torch.int64)
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        keep = (pos < cap) & (onehot > 0)
        counts = counts + onehot.sum(dim=1)
        d_c = ((pos[..., None] == slots) & keep[..., None]).to(x.dtype)
        dispatch = dispatch + d_c
        combine = combine + (d_c.to(torch.float32)
                             * gates[..., choice, None, None])
    return dispatch, combine


_BATCH_RANKS: list = []


@contextmanager
def global_batch_stats(n_ranks: int):
    """Within: the batch's rows lie on the ``n_ranks`` ranks of the default
    process group, each rank computing its own rows' loss, whose gradients
    the caller averages over the ranks (the data-axis "auto" step).
    ``moe_forward`` then takes the load-balance loss's two batch means over
    the global batch, as the reference computes them on it: a product of
    means is not the mean of the ranks' products."""
    _BATCH_RANKS.append(n_ranks)
    try:
        yield
    finally:
        _BATCH_RANKS.pop()


def _batch_means(me: torch.Tensor, ce: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean prob, top-1 share) over the global batch under
    :func:`global_batch_stats`, else as given.  Both are averaged over the
    ranks by one all-reduce; the mean prob keeps this rank's own gradient
    (its value is the global one, its gradient this rank's rows'), so the
    caller's average of the ranks' gradients is the global loss's
    gradient."""
    if not _BATCH_RANKS or _BATCH_RANKS[-1] == 1:
        return me, ce
    both = torch.stack([me.detach(), ce])
    dist.all_reduce(both)
    both = both / _BATCH_RANKS[-1]
    return both[0] + (me - me.detach()), both[1]


def _experts(dispatch: torch.Tensor, combine: torch.Tensor,
             xc: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, *, act) -> torch.Tensor:
    """Groups ``xc`` [G, T, d] through their experts' gated MLPs by the
    one-hot ``dispatch`` and back by ``combine`` ([G, T, E, C]), as the
    reference's einsums.  Each product's input is let go once it is used
    (without autograd nothing else holds it)."""
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xc)          # [G,E,C,d]
    h = (act(torch.einsum("gecd,edf->gecf", xe, w_gate))
         * torch.einsum("gecd,edf->gecf", xe, w_up))
    del xe
    ye = torch.einsum("gecf,efd->gecd", h, w_down)             # [G,E,C,d]
    del h
    return torch.einsum("gtec,gecd->gtd", combine.to(ye.dtype), ye)


def _route_sums(x: torch.Tensor, router: torch.Tensor, n_experts: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(router probs [..., E] f32 of x's tokens, their sums [2, E] over
    those tokens: the probabilities', and the count of tokens whose top-1
    is each expert)."""
    probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    top1 = torch.argmax(probs, dim=-1)          # first index among ties
    return probs, torch.stack([
        probs.reshape(-1, n_experts).sum(0),
        F.one_hot(top1.reshape(-1), n_experts).sum(0).to(torch.float32)])


def _group_experts(moe: MoEConfig, t: int, cap: int, act):
    """The experts of a rank's groups, on local blocks: x [b, S, d] and
    its router probs [b, S, E] cut into groups of ``t`` tokens, the
    one-hots of the experts ``ids`` (the rank's block of ``w_*``) only."""
    def run(x, probs, ids, w_gate, w_up, w_down):
        b, s, d = x.shape
        xc = x.reshape(b * (s // t), t, d)
        dispatch, combine = _dispatch_chunk(
            xc, probs.reshape(b * (s // t), t, -1), moe, cap, ids)
        return (_experts(dispatch, combine, xc, w_gate, w_up, w_down,
                         act=act).reshape(b, s, d),)
    return run


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE MLP over [B, S, d].  Returns (out [B, S, d], aux loss f32)."""
    moe = cfg.moe
    b, s, _ = x.shape
    e = moe.n_experts
    act = activation(cfg.act)
    t = min(chunk, s)
    if s % t:
        raise ValueError(f"sequence {s} is not a multiple of the MoE chunk "
                         f"{t}")
    cap = capacity(t, moe)
    if is_dtensor(x):
        return _moe_sharded(p, x, cfg, t, cap, act)

    router_probs = torch.softmax(dense(x.to(torch.float32), p["router"]),
                                 dim=-1)

    # load-balance aux loss over the full sequence, f32
    me = router_probs.mean(dim=(0, 1))                          # [E]
    top1 = torch.argmax(router_probs, dim=-1)   # first index among ties
    ce = F.one_hot(top1, e).to(torch.float32).mean(dim=(0, 1))
    me, ce = _batch_means(me, ce)
    aux = e * torch.sum(me * ce)

    # every (row, chunk) is one dispatch group
    out, = _group_experts(moe, t, cap, act)(
        x, router_probs, None, p["w_gate"], p["w_up"], p["w_down"])
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, act=cfg.act)
    return out, aux


def _moe_sharded(p: Params, x, cfg: ModelConfig, t: int, cap: int, act):
    """:func:`moe_forward` on DTensors.  The router runs on each rank's
    own block of x (laid out as the residual), its sums a partial sum
    over the axes that split the tokens, reduced into the global means
    (the gradient of each rank's block is its own tokens'); the dispatch
    groups take x and the probs with the sequence made whole."""
    from torch.distributed.tensor import Replicate
    moe = cfg.moe
    b, s, _ = x.shape
    e = moe.n_experts
    probs, sums = on_local_blocks(
        lambda xl, r: _route_sums(xl, r, e), (x, p["router"]),
        (("B", "model", None), (None, None)), out_like=(0, 1),
        partial_over=("pod", "data", "model"), partial_outs=(1,))
    dm = sums.device_mesh
    means = sums.redistribute(dm, [Replicate()] * dm.ndim) / (b * s)
    aux = e * torch.sum(means[0] * means[1])

    x = whole_rows(x)                  # once for the experts and shared
    ids = torch.arange(e, device=sums.device)
    out, = on_local_blocks(
        _group_experts(moe, t, cap, act),
        (x, probs, ids, p["w_gate"], p["w_up"], p["w_down"]),
        (("B", None, None),) * 2 + (("model",),)
        + (("model", None, None),) * 3, out_like=(0,),
        partial_over=("model",))
    out = whole_rows_grad(out)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, act=cfg.act)
    return out, aux
