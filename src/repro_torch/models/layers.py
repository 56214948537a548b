"""Shared building blocks of the decoder: rmsnorm and layernorm, the
activations, rope, whisper's sinusoidal positions, the dense MLP (gated
for silu, with or without biases), tied or untied embeddings and the
padded-vocab loss.

Functional like the reference (``repro/models/layers.py``): ``init_*``
returns a param dict, the other functions take (params, inputs).  Norms,
softmaxes and the loss are computed in f32 whatever the param dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# initializers (same distributions as the reference; jax.random's bits
# cannot be reproduced, so parity tests convert params instead of seeds)
# --------------------------------------------------------------------------- #
def normal(gen: torch.Generator, shape: Sequence[int], std: float, *,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, shape: Sequence[int], *,
               scale: float = 1.0, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Normal(0, scale/sqrt(d_in)) for a [..., d_in, d_out] weight."""
    return normal(gen, shape, scale / math.sqrt(shape[-2]), dtype=dtype,
                  device=device)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def init_norm(kind: str, shape: Sequence[int], *, dtype: torch.dtype,
              device: torch.device) -> Params:
    """Norm params of ``shape`` (``(d,)``, or ``(L, d)`` stacked)."""
    p = {"scale": torch.ones(tuple(shape), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(tuple(shape), dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p: Params, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = ((xf - mu) * torch.rsqrt(var + eps)
               * p["scale"].to(torch.float32) + p["bias"].to(torch.float32))
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# activations
# --------------------------------------------------------------------------- #
def _relu_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def activation(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The reference's three: ``silu``, ``gelu`` (``jax.nn.gelu``'s default
    tanh form) and ``relu_sq``."""
    if kind == "silu":
        return F.silu
    if kind == "gelu":
        return functools.partial(F.gelu, approximate="tanh")
    if kind == "relu_sq":
        return _relu_sq
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# rotary position embeddings
# --------------------------------------------------------------------------- #
def rope_frequencies(d_head: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs       # [.., S, D/2]
    cos = torch.cos(angles)[..., None, :]                         # [.., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, *, start: int = 0,
                         device: torch.device = None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute position embeddings [n, d] f32 of
    the positions ``start .. start + n - 1``: ``pos / 10000 ** (dim / d)``
    for the even dims, then ``[sin | cos]``.  Each element depends on its
    own position only, so a decode step's row (``start`` = its position)
    is the prefill table's row bit for bit."""
    pos = torch.arange(start, start + n, dtype=torch.float32,
                       device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# --------------------------------------------------------------------------- #
# dense MLP: gated for silu, plain otherwise; optional biases
# --------------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, lead: Sequence[int], d: int, d_ff: int,
             *, act: str, bias: bool, dtype: torch.dtype,
             device: torch.device) -> Params:
    """MLP params with leading dims ``lead`` (``(L,)`` for a stacked
    layer's): ``{up, down}``, plus ``gate`` for silu (the reference gates
    only that activation) and ``up_b``/``down_b`` (zeros) with ``bias``."""
    lead = tuple(lead)
    kw = dict(dtype=dtype, device=device)
    p: Params = {"up": dense_init(gen, lead + (d, d_ff), **kw),
                 "down": dense_init(gen, lead + (d_ff, d), **kw)}
    if act == "silu":
        p["gate"] = dense_init(gen, lead + (d, d_ff), **kw)
    if bias:
        p["up_b"] = torch.zeros(lead + (d_ff,), **kw)
        p["down_b"] = torch.zeros(lead + (d,), **kw)
    return p


def apply_mlp(p: Params, x: torch.Tensor, *, act: str) -> torch.Tensor:
    up = x @ p["up"]
    if "up_b" in p:
        up = up + p["up_b"]
    h = activation(act)(up)
    if "gate" in p:
        h = h * (x @ p["gate"])
    out = h @ p["down"]
    if "down_b" in p:
        out = out + p["down_b"]
    return out


# --------------------------------------------------------------------------- #
# embedding / unembedding with padded vocab (tied, or an untied lm_head)
# --------------------------------------------------------------------------- #
def init_embeddings(gen: torch.Generator, padded_vocab: int, d: int, *,
                    tie: bool, dtype: torch.dtype,
                    device: torch.device) -> Params:
    kw = dict(dtype=dtype, device=device)
    p: Params = {"embed": normal(gen, (padded_vocab, d), 0.02, **kw)}
    if not tie:
        p["lm_head"] = dense_init(gen, (d, padded_vocab), **kw)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens.long()]


def unembed(p: Params, h: torch.Tensor) -> torch.Tensor:
    if "lm_head" in p:
        return h @ p["lm_head"]
    return h @ p["embed"].T


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Cross-entropy over a (padded) vocab; padded ids are masked out.

    logits: [..., V_pad], labels: [...] int -> per-position loss f32.
    """
    v_pad = logits.shape[-1]
    logits = logits.to(torch.float32)
    if v_pad > vocab_size:
        pad = torch.arange(v_pad, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def chunked_loss(h: torch.Tensor, embeds: Params, labels: torch.Tensor,
                 vocab_size: int, *, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token loss with sequence-chunked logits, so [B, S, V] is
    never materialized at once.  h: [B, S, d]; labels: [B, S]."""
    b, s, _ = h.shape
    if s % chunk != 0 or s <= chunk:
        return torch.mean(softmax_xent(unembed(embeds, h), labels,
                                       vocab_size))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        logits = unembed(embeds, h[:, i:i + chunk])
        total = total + torch.sum(softmax_xent(logits, labels[:, i:i + chunk],
                                               vocab_size))
    return total / (b * s)
