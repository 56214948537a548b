"""The plain reference of the benchmark's decoders: float32 PyTorch, TF32
off, written from the configuration's sizes and the layer equations, with
no kernel, cache or batching of the program's.

A decoder layer is ``h + mix(rms(h))`` then ``h + moe(rms(h))``; the mixer
is DeepSeek-V2's latent attention (MLA) or grouped-query attention (GQA),
both causal with rotate-half RoPE at ``rope_theta``.  The MoE layer routes
with a softmax over all experts in f32, takes each token's top k (equal
probabilities lower index first) with the gates renormalised, and keeps a
choice only while its expert has a free slot in the token's group
(``group_tokens`` consecutive tokens of one row; ``capacity`` slots an
expert; every token's first choice claims slots before any second choice,
each in token order).  Its balance loss is ``E * sum(mean prob * top-1
share)`` over the batch, and the loss is the mean next-token cross entropy
over the vocabulary (the padded table's extra columns masked) plus
``aux_coef`` times the layers' balance losses.

A mixture-of-experts model's routing is discrete: two precisions route
some tokens to other experts, and those tokens then differ by a whole
expert's output, so the reference can follow routes that a run took
(``given``): it judges each one by its own router probabilities (the
route gap) and then computes with it, as a served model's reference reads
the served tokens.

``precision="fp8"`` is the benchmark's control: every matrix product takes
its two inputs rounded to float8 e4m3 and, backward, its output's gradient
to e5m2 (each scaled by its largest magnitude), the step below the
configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Path_ = Tuple[str, ...]
F8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _f8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    amax = x.abs().amax().clamp_min(1e-30)
    s = F8[dtype] / amax
    return (x * s).to(dtype).to(torch.float32) / s


def _f8_parts(x: torch.Tensor, dtype=torch.float8_e4m3fn):
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = F8[dtype] / amax
    return (x.detach() * s).to(dtype), s


class _Round(torch.autograd.Function):
    """Values rounded to e4m3 going forward (``fwd``), gradients to e5m2
    coming back (``bwd``): the two roundings of an fp8 product's inputs
    and of its output's gradient."""

    @staticmethod
    def forward(ctx, x, fwd: bool, bwd: bool):
        ctx.bwd = bwd
        return _f8(x) if fwd else x.clone()

    @staticmethod
    def backward(ctx, g):
        return (_f8(g, torch.float8_e5m2) if ctx.bwd else g), None, None


class _F8Mm(torch.autograd.Function):
    """``a @ b`` (a [..., K], b [K, N]) with both inputs in e4m3 and, in
    the backward, the output's gradient in e5m2; it keeps the inputs as
    fp8 bytes for the backward (a deepseek-v2 layer's experts would not
    fit as float32 copies)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, sa = _f8_parts(a)
        qb, sb = _f8_parts(b)
        ctx.save_for_backward(qa, sa, qb, sb)
        return (qa.float() / sa) @ (qb.float() / sb)

    @staticmethod
    def backward(ctx, g):
        qa, sa, qb, sb = ctx.saved_tensors
        g = _f8(g, torch.float8_e5m2)
        a = qa.float() / sa
        ga = g @ (qb.float() / sb).T
        gb = a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return ga, gb


class Ops:
    """Matrix products in the reference's precision: f32, or fp8 (both
    inputs in e4m3 and, backward, the output's gradient in e5m2, each
    scaled by its largest magnitude; accumulation in f32)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.lowp = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _F8Mm.apply(a, b) if self.lowp else a @ b

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        if not self.lowp:
            return torch.einsum(eq, a, b)
        a, b = _Round.apply(a, True, False), _Round.apply(b, True, False)
        return _Round.apply(torch.einsum(eq, a, b), False, True)


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D]: the first and second halves of D rotated by the
    angle ``pos * theta ** (-2 i / D)``."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend_rows(ops: Ops, q, k, v, start: int, scale: float):
    """Queries ``start ..`` of q [B, c, H, Dk] against keys ``0 .. start +
    c`` of k [B, S, H, Dk], v [B, S, H, Dv], causally."""
    c = q.shape[1]
    kk, vv = k[:, :start + c], v[:, :start + c]
    sc = ops.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    qpos = torch.arange(start, start + c, device=q.device)[:, None]
    kpos = torch.arange(start + c, device=q.device)[None, :]
    sc = sc.masked_fill(kpos > qpos, float("-inf"))
    return ops.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), vv)


def attention(ops: Ops, q, k, v, scale: float, rows: int = 256):
    """Causal attention of q [B, S, H, Dk] over k [B, S, H, Dk] and v [B, S,
    H, Dv] (heads already matched), a block of query rows at a time, each
    block recomputed in the backward."""
    outs = []
    for start in range(0, q.shape[1], rows):
        outs.append(checkpoint(_attend_rows, ops, q[:, start:start + rows],
                               k, v, start, scale, use_reentrant=False))
    return torch.cat(outs, dim=1)


def mla(ops: Ops, p: Dict[str, torch.Tensor], x, s) -> torch.Tensor:
    m, h = s["mla"], s["n_heads"]
    b, n, _ = x.shape
    nope, rp = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    q = ops.mm(ops.mm(x, p["q_down"]), p["q_up"]).reshape(b, n, h, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], s["rope_theta"])], -1)
    kv = ops.mm(x, p["kv_down"])
    ckv, kr = kv[..., :m["kv_lora_rank"]], kv[..., m["kv_lora_rank"]:]
    kr = rope(kr[:, :, None, :], s["rope_theta"])
    k = torch.cat([ops.mm(ckv, p["k_up"]).reshape(b, n, h, nope),
                   kr.expand(b, n, h, rp)], dim=-1)
    v = ops.mm(ckv, p["v_up"]).reshape(b, n, h, m["v_head_dim"])
    out = attention(ops, q, k, v, 1.0 / math.sqrt(nope + rp))
    return ops.mm(out.reshape(b, n, -1), p["wo"])


def gqa(ops: Ops, p: Dict[str, torch.Tensor], x, s) -> torch.Tensor:
    b, n, _ = x.shape
    h, kvh, hd = s["n_heads"], s["n_kv_heads"], s["head_dim"]
    q = rope(ops.mm(x, p["wq"]).reshape(b, n, h, hd), s["rope_theta"])
    k = rope(ops.mm(x, p["wk"]).reshape(b, n, kvh, hd), s["rope_theta"])
    v = ops.mm(x, p["wv"]).reshape(b, n, kvh, hd)
    # query head i reads key and value head i // (h / kvh)
    k = k.repeat_interleave(h // kvh, dim=2)
    v = v.repeat_interleave(h // kvh, dim=2)
    out = attention(ops, q, k, v, 1.0 / math.sqrt(hd))
    return ops.mm(out.reshape(b, n, -1), p["wo"])


def routes(probs: torch.Tensor, moe: Dict, cap: int,
           given: Optional[torch.Tensor] = None):
    """(expert ids [N, k], gates [N, k] renormalised, kept [N, k] bool,
    the ids [G', T, k] routed here, the route gap) of the tokens whose
    router probabilities are ``probs`` [G, T, E].  ``given`` ([G', T, k],
    G' <= G, choice by choice in priority order) are routes the program
    took, which these probabilities judge and then follow; groups past G'
    are routed here.  The route gap is the widest by which a given route's
    probability lies below the k-th largest of its token (0 where every
    given route is among the top k)."""
    g, t, e = probs.shape
    k = moe["top_k"]
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids = top.indices[..., :k]
    gap = torch.zeros((), device=probs.device)
    if given is not None:
        n = given.shape[0]
        ids = torch.cat([given.to(ids.device, torch.int64), ids[n:]])
        kth = top.values[:n, :, k - 1:k]
        gap = (kth - torch.gather(probs[:n], -1, ids[:n])).clamp_min(0).max()
    gates = torch.gather(probs, -1, ids)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    used = torch.zeros((g, e), dtype=torch.int64, device=probs.device)
    kept = []
    for c in range(k):
        hit = F.one_hot(ids[..., c], e)                       # [G, T, E]
        slot = (torch.cumsum(hit, dim=1) - 1 + used[:, None, :])
        kept.append(((slot < cap) & (hit > 0)).any(-1))
        used = used + hit.sum(dim=1)
    kept = torch.stack(kept, dim=-1)
    return (ids.reshape(g * t, -1), gates.reshape(g * t, -1),
            kept.reshape(g * t, -1), ids.detach(), gap.detach())


def moe(ops: Ops, p: Dict[str, torch.Tensor], x, s,
        given: Optional[torch.Tensor] = None):
    """(out [B, S, d], the balance loss, the routes taken, the route gap)
    of the MoE layer (``routes`` says what ``given`` is)."""
    from ..spec import capacity
    m = s["moe"]
    b, n, d = x.shape
    e = m["n_experts"]
    probs = torch.softmax(ops.mm(x, p["router"]), dim=-1)      # [B, S, E]
    top1 = torch.argmax(probs, dim=-1)
    aux = e * torch.sum(probs.mean(dim=(0, 1))
                        * F.one_hot(top1, e).float().mean(dim=(0, 1)))
    t = min(m["group_tokens"], n)
    ids, gates, kept, taken, gap = routes(
        probs.reshape(b * n // t, t, e), m, capacity(t, m), given)
    xf = x.reshape(b * n, d)
    out = torch.zeros_like(xf)
    for j in range(e):
        tok, choice = torch.nonzero((ids == j) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        h = F.silu(ops.mm(xe, p["w_gate"][j])) * ops.mm(xe, p["w_up"][j])
        y = ops.mm(h, p["w_down"][j])
        out = out.index_add(0, tok, y * gates[tok, choice][:, None])
    out = out.reshape(b, n, d)
    if "shared/up" in p:
        out = out + ops.mm(F.silu(ops.mm(x, p["shared/up"]))
                           * ops.mm(x, p["shared/gate"]), p["shared/down"])
    return out, aux, taken, gap


def _layer(ops: Ops, p: Dict[str, torch.Tensor], h, s, given):
    mix = mla if s["kind"] == "mla" else gqa
    h = h + mix(ops, {k[4:]: v for k, v in p.items() if k.startswith("mix/")},
                rms(h, p["norm1/scale"], s["eps"]), s)
    out, aux, taken, gap = moe(ops, {k[4:]: v for k, v in p.items()
                                     if k.startswith("mlp/")},
                               rms(h, p["norm2/scale"], s["eps"]), s, given)
    return h + out, aux, taken, gap


def _xent(ops: Ops, h, head, labels, vocab: int):
    logits = ops.mm(h, head)
    pad = torch.arange(logits.shape[-1], device=h.device) >= vocab
    logits = logits.masked_fill(pad, float("-inf"))
    return torch.sum(torch.logsumexp(logits, -1)
                     - torch.gather(logits, -1, labels[..., None])[..., 0])


def loss(params: Dict[Path_, torch.Tensor], batch: Dict[str, torch.Tensor],
         s, precision: str = "f32",
         given: Optional[Sequence[torch.Tensor]] = None) -> Dict:
    """{"total": loss + aux_coef * aux, "ce": the cross entropy, "aux": the
    summed balance losses, "routes": each layer's routes [G, T, k],
    "route_gaps": each layer's route gap} of ``params`` ({path:
    f32 leaf}) on ``batch``; ``given`` holds routes to judge and follow,
    one entry a layer (see ``routes``)."""
    ops = Ops(precision)
    tokens, labels = batch["tokens"], batch["labels"]
    h = params[("embeds", "embed")][tokens]
    aux = torch.zeros((), device=h.device)
    taken, gaps = [], []
    for i in range(s["n_layers"]):
        layer = {"/".join(k[1:]): v[i] for k, v in params.items()
                 if k[0] == "layers"}
        h, a, ids, g = checkpoint(_layer, ops, layer, h, s,
                                  None if given is None else given[i],
                                  use_reentrant=False)
        aux = aux + a
        gaps.append(g)
        taken.append(ids)
    h = rms(h, params[("final_norm", "scale")], s["eps"])
    head = (params[("embeds", "lm_head")] if not s["tie"]
            else params[("embeds", "embed")].T)
    b, n, _ = h.shape
    ce = torch.zeros((), device=h.device)
    for i in range(0, n, 1024):
        ce = ce + checkpoint(_xent, ops, h[:, i:i + 1024], head,
                             labels[:, i:i + 1024], s["vocab_size"],
                             use_reentrant=False)
    ce = ce / (b * n)
    return {"total": ce + s["aux_coef"] * aux, "ce": ce.detach(),
            "aux": aux.detach(), "routes": taken, "route_gaps": gaps}
