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
reference scans over the chunks; here the chunks are folded into the
batch dimension, which gives each group the same slots in one pass.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from .layers import Params, activation, apply_mlp, init_mlp, normal

__all__ = ["capacity", "init_moe", "moe_forward", "router_topk"]


def capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    c = int(math.ceil(tokens_per_group * moe.top_k / moe.n_experts
                      * moe.capacity_factor))
    return max(c, 1)


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int], *,
             dtype: torch.dtype, device: torch.device) -> Params:
    """MoE params with leading dims ``lead``: ``router`` [.., d, E] in f32,
    ``w_gate``/``w_up`` [.., E, d, f] and ``w_down`` [.., E, f, d] in
    ``dtype``, all drawn with std 1/sqrt(d) as the reference draws them,
    and ``shared`` (a gated MLP of width f * n_shared) when the config has
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
        p["shared"] = init_mlp(gen, lead, d, f * moe.n_shared, **kw)
    return p


def router_topk(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest in descending
    order, equal values lower index first (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_chunk(x: torch.Tensor, router_probs: torch.Tensor,
                    moe: MoEConfig, cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch, combine) one-hots for groups ``[G, T, d]``.

    dispatch: [G, T, E, C] in {0, 1} of x's dtype; combine: dispatch times
    the renormalized gate, f32.  Top-k choices claim capacity slots in
    priority order (GShard): every token's first choice, then every
    token's second, each in token order."""
    g, t, e = router_probs.shape
    gates, idx = router_topk(router_probs, moe.top_k)           # [G,T,K]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    slots = torch.arange(cap, device=x.device)
    counts = torch.zeros((g, e), dtype=torch.int64, device=x.device)
    dispatch = torch.zeros((g, t, e, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros((g, t, e, cap), dtype=torch.float32,
                          device=x.device)
    for choice in range(moe.top_k):
        onehot = F.one_hot(idx[..., choice], e)                 # [G,T,E]
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        keep = (pos < cap) & (onehot > 0)
        counts = counts + onehot.sum(dim=1)
        d_c = ((pos[..., None] == slots) & keep[..., None]).to(x.dtype)
        dispatch = dispatch + d_c
        combine = combine + (d_c.to(torch.float32)
                             * gates[..., choice, None, None])
    return dispatch, combine


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE MLP over [B, S, d].  Returns (out [B, S, d], aux loss f32)."""
    moe = cfg.moe
    b, s, d = x.shape
    act = activation(cfg.act)
    t = min(chunk, s)
    if s % t:
        raise ValueError(f"sequence {s} is not a multiple of the MoE chunk "
                         f"{t}")
    cap = capacity(t, moe)

    router_probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)

    # load-balance aux loss over the full sequence, f32
    me = router_probs.mean(dim=(0, 1))                          # [E]
    top1 = torch.argmax(router_probs, dim=-1)   # first index among ties
    ce = F.one_hot(top1, moe.n_experts).to(torch.float32).mean(dim=(0, 1))
    aux = moe.n_experts * torch.sum(me * ce)

    # every (row, chunk) is one dispatch group
    xc = x.reshape(b * (s // t), t, d)
    dispatch, combine = _dispatch_chunk(
        xc, router_probs.reshape(b * (s // t), t, -1), moe, cap)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xc)          # [G,E,C,d]
    h = (act(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
         * torch.einsum("gecd,edf->gecf", xe, p["w_up"]))
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])        # [G,E,C,d]
    out = torch.einsum("gtec,gecd->gtd", combine.to(ye.dtype), ye)
    out = out.reshape(b, s, d)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, act=cfg.act)
    return out, aux
