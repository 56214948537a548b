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
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# initializers (same distributions as the reference; jax.random's bits
# cannot be reproduced, so parity tests convert params instead of seeds)
# --------------------------------------------------------------------------- #
def draw_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where a draw from ``gen`` is made: the generator's device, or
    ``meta`` without one (``models.api.params_specs``: shapes and dtypes,
    no storage and no random draws)."""
    return gen.device if gen is not None else torch.device("meta")


def normal(gen: Optional[torch.Generator], shape: Sequence[int], std: float,
           *, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=draw_device(gen),
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
    x = whole_rows(x)                   # once for up and gate
    up = dense(x, p["up"])
    if "up_b" in p:
        up = up + p["up_b"]
    h = activation(act)(up)
    if "gate" in p:
        h = h * dense(x, p["gate"])
    out = dense(h, p["down"])
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


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(p["embed"]):
        return _embed_sharded(p["embed"], tokens)
    return p["embed"][tokens.long()]


def _embed_sharded(table, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup on a DTensor table: the table made whole on every rank,
    each rank's rows gathered from it for its block of ``tokens`` (plain
    tokens are the same on every rank), the rows laid out as the tokens
    are.  The table's gradient is a partial sum over the axes that split
    the tokens.  DTensor's own lookup fails in its backward on a 2-D mesh
    (PyTorch 2.11: an unnormalized ``Shard(-1)`` in ``index_put``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dm = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, dm, [Replicate()] * dm.ndim,
                                    run_check=False)
    split = [isinstance(pl, Shard) for pl in tokens.placements]
    whole = table.redistribute(dm, [Replicate()] * dm.ndim).to_local(
        grad_placements=[Partial() if s else Replicate() for s in split])
    return DTensor.from_local(whole[tokens.to_local().long()], dm,
                              tokens.placements, run_check=False)


def unembed(p: Params, h: torch.Tensor) -> torch.Tensor:
    if "lm_head" in p:
        return dense(h, p["lm_head"])
    return dense(h, p["embed"].T)


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
    gold = torch.gather(whole_last_dim(logits), -1,
                        labels.long()[..., None])[..., 0]
    return logz - gold


def _whole_along(t: torch.Tensor, dims) -> torch.Tensor:
    """``t`` made whole along ``dims`` where it is a DTensor split along
    any of them (``t`` itself otherwise)."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(t):
        return t
    split = [isinstance(pl, Shard) and pl.dim in dims for pl in t.placements]
    if not any(split):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if s else pl for s, pl in zip(split, t.placements)])


def whole_last_dim(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dim whole on every rank where ``t`` is a DTensor
    split along it (``t`` itself otherwise).  ``softmax_xent`` gathers the
    gold logits from the whole vocab: DTensor's gather from a vocab-split
    tensor (its masked partial) fails to reduce a [B, S, 1] result
    (PyTorch 2.13)."""
    return _whole_along(t, {t.ndim - 1})


def whole_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` ([B, S, ..., d]) whole along every dim but the first and the
    last where it is a DTensor split along one: the sequence-parallel
    residual gathered before a projection (or a slice along the
    sequence), as DTensor cannot flatten a split sequence into a matmul's
    rows (PyTorch 2.11)."""
    return _whole_along(t, set(range(1, t.ndim - 1)))


class _WholeRowsGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient's rows whole: the
    gradient a projection gets back from the sequence-parallel residual is
    split along the sequence, and its matmul's backward flattens it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return whole_rows(g)


def whole_rows_grad(y: torch.Tensor) -> torch.Tensor:
    """``y``, whose gradient's rows are made whole on the way back where
    ``y`` is a DTensor: the output of a block that flattens its rows
    (the experts' dispatch) and goes back into the sequence-parallel
    residual."""
    return _WholeRowsGrad.apply(y) if is_dtensor(y) else y


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: the
    attention's backward gives permuted gradients, and DTensor's ``view``
    of a gradient whose local tensor is permuted fails (PyTorch 2.13)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_local_blocks(fn: Callable, args, specs, out_like, partial_over=()):
    """``fn(*args)`` on each rank's blocks, for a computation that is local
    to its batch rows and its heads or channels (a recurrence along the
    sequence, which DTensor would otherwise run op by op and flatten
    across split dims).  Each of ``args`` (DTensors; plain tensors are
    taken as replicated) is laid out by its entry of ``specs``, a tuple
    per dim of ``"B"`` (the batch axes, ``batch_spec_axes`` of the first
    arg's leading dim), ``"model"`` or None, each dropped where it does
    not divide.  ``fn`` runs on the local tensors and returns a tuple,
    whose entry i becomes a DTensor laid out as arg ``out_like[i]``, but
    a partial sum over the axes of ``partial_over`` that split an arg (a
    sum over the blocks, as of experts).  An arg replicated over a mesh
    axis that splits another arg gets its gradient as a partial sum over
    that axis: each rank's block adds its share."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..dist.policy import P, _fit_spec
    from ..dist.sharding import batch_spec_axes, mesh_view, placements
    dm = next(a.device_mesh for a in args if is_dtensor(a))
    mesh = mesh_view(dm)
    ba = batch_spec_axes(mesh, args[0].shape[0])
    whole = []
    for a, spec in zip(args, specs):
        if not is_dtensor(a):
            a = DTensor.from_local(a, dm, [Replicate()] * dm.ndim,
                                   run_check=False)
        whole.append((a, placements(mesh, _fit_spec(mesh, P(*(
            ba if e == "B" else e for e in spec)), tuple(a.shape)))))
    split = {i for _, pl in whole for i, p in enumerate(pl)
             if isinstance(p, Shard)}
    local = [_ContiguousGrad.apply(a.redistribute(dm, pl).to_local(
        grad_placements=[Partial() if i in split and isinstance(
            p, Replicate) else p for i, p in enumerate(pl)]))
        for a, pl in whole]
    names = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    partial = {names.index(a) for a in partial_over if a in names} & split
    return tuple(DTensor.from_local(o.contiguous(), dm, [
        Partial() if j in partial else p for j, p in enumerate(whole[i][1])],
        run_check=False) for o, i in zip(fn(*local), out_like))


def _gathered_over_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``w`` made whole over every mesh dim that splits both ``x``'s rows
    and ``w`` (an FSDP weight against a batch split over ``data``): the
    all-gather of the weight that GSPMD issues for FSDP, whose gradient is
    reduce-scattered on the way back.  Left to itself DTensor may gather
    the rows instead where they are few (decode), and every rank then
    multiplies the whole batch."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(w):
        return w
    rows = {i for i, pl in enumerate(x.placements)
            if isinstance(pl, Shard) and pl.dim < x.ndim - 1}
    pls = [Replicate() if i in rows and isinstance(pl, Shard) else pl
           for i, pl in enumerate(w.placements)]
    return w if pls == list(w.placements) else w.redistribute(
        w.device_mesh, pls)


def _split_as_contraction(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x``, its partial sums reduced, split along its last dim over
    every mesh dim that splits ``w``'s first (the contraction) and leaves
    ``x`` whole (a local slice): each rank multiplies its block of the
    contraction into a partial sum, as GSPMD partitions it.  Left to
    itself DTensor may gather ``w`` whole instead where ``x`` has few
    rows (decode)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not is_dtensor(w):
        return x
    # a partial sum is summed first: GSPMD reduces it before the product
    pls = [Replicate() if isinstance(xp, Partial) else xp
           for xp in x.placements]
    pls = [Shard(x.ndim - 1) if isinstance(wp, Shard) and wp.dim == 0
           and isinstance(xp, Replicate) else xp
           for xp, wp in zip(pls, w.placements)]
    return x if pls == list(x.placements) else x.redistribute(
        x.device_mesh, pls)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``.  On DTensors (a model axis) the rows of ``x`` and of the
    gradient that comes back are made whole first (``whole_rows``), ``w``
    is gathered over the mesh dims that split the batch
    (``_gathered_over_rows``), and ``x`` is split as ``w``'s contraction
    (``_split_as_contraction``)."""
    if not is_dtensor(x):
        return x @ w
    x = whole_rows(x)
    w = _gathered_over_rows(x, w)
    return _WholeRowsGrad.apply(_split_as_contraction(x, w) @ w)


def chunked_loss(h: torch.Tensor, embeds: Params, labels: torch.Tensor,
                 vocab_size: int, *, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token loss with sequence-chunked logits, so [B, S, V] is
    never materialized at once.  h: [B, S, d]; labels: [B, S]."""
    b, s, _ = h.shape
    h = whole_rows(h)
    if s % chunk != 0 or s <= chunk:
        return torch.mean(softmax_xent(unembed(embeds, h), labels,
                                       vocab_size))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        logits = unembed(embeds, h[:, i:i + chunk])
        total = total + torch.sum(softmax_xent(logits, labels[:, i:i + chunk],
                                               vocab_size))
    return total / (b * s)
