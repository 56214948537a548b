"""GQA attention: the reference's blockwise online-softmax attention and
its KV-cache decode (``repro/models/attention.py``) in PyTorch.

Sequences of at most ``kv_block`` keys take the one-block path
(``_plain_attention``); longer ones take the blockwise online-softmax loop
(``_flash_fwd_core``) so no [S, S] score matrix is built.  That loop is
differentiated as the reference's ``jax.custom_vjp`` (``_flash_vjp``) does
it, by ``_FlashAttention``: the forward saves only (q, k, v, out, lse) and
the backward recomputes each KV block's scores from ``lse``, in plain
PyTorch (the reference's backward is jnp code too, not a kernel).  Score
matmuls accumulate and return f32, as ``preferred_element_type=f32`` does
in the reference.

Under ``set_attention_impl("pallas")`` full-sequence attention with
``Sq == Skv`` (the prefill) goes to the flash-attention kernel instead, as
in the reference.  Decode (``decode_attention``, ``gqa_decode``,
``gqa_decode_q8``) is plain PyTorch, as it is plain jnp in the reference,
and writes the new position into the cache tensors in place (the reference
donates the cache to ``jit`` for the same effect).

Whisper's cross-attention is ``gqa_forward(xattn_kv=(k, v))`` over the
encoder's keys and values (no mask, no rope) and, in decode,
``gqa_cross_decode``, one token against them through
``decode_attention``.

DeepSeek-V2's latent attention (``init_mla``, ``mla_forward``,
``mla_decode``) caches the compressed latent ``{ckv, krope}`` instead of
k and v: its prefill expands it into per-head keys and values for
``blockwise_attention``, its decode attends in the latent space.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..dist.flatbuf import encode_int8, int8_scale
from ..dist.policy import P, _fit_spec
from ..dist.sharding import batch_spec_axes, mesh_view, placements
from ..kernels.ops import flash_attention_op
from .layers import (Params, _ContiguousGrad, apply_rope, dense, dense_init,
                     is_dtensor, whole_last_dim, whole_rows)

NEG_INF = -1e30

# "blockwise" (the online-softmax loop below; the default, and the only
# choice for training) or "pallas" (the reference's name for its flash
# kernel: here the CUDA flash-attention kernel on the card and its plain
# PyTorch version on the CPU, through ``kernels.ops.flash_attention_op``)
_ATTN_IMPL = "blockwise"


def set_attention_impl(impl: str) -> None:
    global _ATTN_IMPL
    if impl not in ("blockwise", "pallas"):
        raise ValueError(f"attention impl {impl!r}: 'blockwise' or 'pallas'")
    _ATTN_IMPL = impl


def get_attention_impl() -> str:
    return _ATTN_IMPL


def _plain_attention(q, k, v, mask_bias, scale):
    """q: [B,Sq,H,D] k,v: [B,Skv,KVH,D] -> [B,Sq,H,D] (f32 softmax)."""
    b, sq, h, dk = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dk)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = scores + mask_bias  # [1,1,1,Sq,Skv] broadcast
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def _causal_bias(sq, skv, q_offset, causal, device):
    """0 where ``q_offset + q_pos >= k_pos`` (or everywhere without
    ``causal``), NEG_INF above the diagonal; [1,1,1,Sq,Skv] f32."""
    if not causal:
        return torch.zeros((1, 1, 1, sq, skv), dtype=torch.float32,
                           device=device)
    bias = torch.full((sq, skv), NEG_INF, dtype=torch.float32, device=device)
    return bias.triu(1 + q_offset)[None, None, None]


def _block_mask(sq, kv_block, q_offset, start, device):
    """True where ``q_offset + q_pos >= k_pos`` for keys [start, start +
    kv_block); [Sq, kv_block]."""
    q_pos = torch.arange(q_offset, q_offset + sq, device=device)
    k_pos = start + torch.arange(kv_block, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _flash_fwd_core(q, k, v, causal, q_offset, kv_block, scale):
    """Online softmax over KV blocks.  Returns (out [B,Sq,H,Dv], lse
    [B,KVH,G,Sq] f32)."""
    b, sq, h, dk = q.shape
    _, skv, kvh, dv = v.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dk).to(torch.float32)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32, device=q.device)
    for start in range(0, skv, kv_block):
        kk = k[:, start:start + kv_block]
        vv = v[:, start:start + kv_block]
        # one f32 [B, KVH, G, Sq, kv_block] buffer a block, scaled, masked
        # and exponentiated in place (the same values as out of place):
        # at whisper's 32k cross-attention prefill it is 12.6 GB
        p = torch.einsum("bqhgd,bkhd->bhgqk", qg, kk.to(torch.float32))
        p.mul_(scale)
        if causal:
            p.masked_fill_(
                ~_block_mask(sq, kv_block, q_offset, start, q.device),
                NEG_INF)
        m_new = torch.maximum(m, torch.amax(p, dim=-1))
        alpha = torch.exp(m - m_new)
        p.sub_(m_new[..., None]).exp_()
        l = l * alpha + torch.sum(p, dim=-1)
        o = (o * alpha[..., None]
             + torch.einsum("bhgqk,bkhd->bhgqd", p.to(vv.dtype), vv
                            ).to(torch.float32))
        m = m_new
        del p
    l_safe = torch.clamp_min(l, 1e-30)
    out = (o / l_safe[..., None]).permute(0, 3, 1, 2, 4)
    lse = m + torch.log(l_safe)
    return out.reshape(b, sq, h, dv).to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, do, causal, q_offset, kv_block, scale):
    """The reference's ``_flash_vjp_bwd``: per KV block, p = exp(s - lse)
    recomputed in f32, then dv = p^T do, ds = p (do v^T - delta) scale,
    dq += ds k, dk = ds^T q.  Grads come back in the inputs' dtypes."""
    b, sq, h, dk = q.shape
    _, skv, kvh, dv = v.shape
    g = h // kvh
    f32 = torch.float32
    qg = q.reshape(b, sq, kvh, g, dk).to(f32)
    dog = do.reshape(b, sq, kvh, g, dv).to(f32)
    outg = out.reshape(b, sq, kvh, g, dv).to(f32)
    # delta = rowsum(do * out): the softmax-jacobian diagonal correction
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dog, outg)
    dq = torch.zeros((b, sq, kvh, g, dk), dtype=f32, device=q.device)
    dk_out = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv_out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for start in range(0, skv, kv_block):
        kkf = k[:, start:start + kv_block].to(f32)
        vvf = v[:, start:start + kv_block].to(f32)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kkf) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            p = p.masked_fill(
                ~_block_mask(sq, kv_block, q_offset, start, q.device), 0.0)
        dv_out[:, start:start + kv_block] = torch.einsum(
            "bhgqk,bqhgd->bkhd", p, dog)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vvf)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kkf)
        dk_out[:, start:start + kv_block] = torch.einsum(
            "bhgqk,bqhgd->bkhd", ds, qg)
    return dq.reshape(b, sq, h, dk).to(q.dtype), dk_out, dv_out


class _FlashAttention(torch.autograd.Function):
    """The blockwise loop with the reference's flash VJP: saves exactly
    (q, k, v, out, lse), recomputes the scores block by block in the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_block, scale):
        out, lse = _flash_fwd_core(q, k, v, causal, q_offset, kv_block,
                                   scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, kv_block, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, do, *ctx.args),
                None, None, None, None)


def _attend_local(fn: Callable, q, k, v, *, q_offset: int = 0,
                  split_queries: bool = True):
    """``fn(q, k, v, q_offset)`` on this rank's local heads: q, k, v ([B, S,
    H, D] DTensors) are laid out with the batch over the data axes where it
    divides (``batch_spec_axes``) and the q heads over ``model``, and
    ``fn`` (the blockwise loop or the flash kernel) runs on the local
    tensors, ``q_offset`` the absolute position of the first local query.
    Where both head counts divide the axis (``head_policy``) the kv heads
    are split beside the q heads and the result is a DTensor in the same
    layout.  Otherwise the query positions are split with the heads
    (``_attend_split``), or, with ``split_queries=False`` (the flash
    kernel, which needs the whole sequence from position 0), the heads
    are padded (``_attend_padded``)."""
    from torch.distributed.tensor import DTensor
    dm = q.device_mesh
    mesh = mesh_view(dm)
    m = mesh.shape.get("model", 1)
    if q.shape[2] % m or k.shape[2] % m:
        if split_queries:
            return _attend_split(fn, q, k, v, mesh, q_offset)
        return _attend_padded(fn, q, k, v, mesh, q_offset)
    spec = P(batch_spec_axes(mesh, q.shape[0]), None, "model", None)
    local = [_ContiguousGrad.apply(t.redistribute(dm, placements(
        mesh, _fit_spec(mesh, spec, tuple(t.shape)))).to_local())
        for t in (q, k, v)]
    # contiguous: DTensor's views need a dense local tensor, and the
    # kernel's output is a transposed view
    return DTensor.from_local(fn(*local, q_offset).contiguous(), dm,
                              placements(mesh, _fit_spec(
                                  mesh, spec, tuple(q.shape))),
                              run_check=False)


def query_split(h: int, m: int, r: int):
    """(q heads, query chunk, chunks) of rank ``r`` of a ``model`` axis of
    ``m`` when ``h`` q heads do not divide it: ``g = gcd(h, m)`` groups of
    ``h / g`` heads and ``c = m / g`` chunks of the query positions, rank
    ``r`` taking head group ``r % g`` and chunk ``r // g`` (the groups
    minor: with ``c == 1`` this is the plain head split).  Every rank
    computes ``h * Sq / m`` head-queries, and none a zero head."""
    g = math.gcd(h, m)
    hl = h // g
    return range((r % g) * hl, (r % g + 1) * hl), r // g, m // g


def local_heads(h: int, kvh: int, m: int, r: int):
    """The q heads rank ``r`` of a ``model`` axis of ``m`` computes when
    ``h`` is padded up to a multiple of ``m`` (``ceil(h / m)`` a rank,
    ``range(r * hl, (r + 1) * hl)``; those from ``h`` on are zero heads),
    and for each the kv head it reads (group ``j // (h / kvh)``; a padded
    head reads the last real head's)."""
    hl, g = -(-h // m), h // kvh
    heads = range(r * hl, (r + 1) * hl)
    return heads, [min(j, h - 1) // g for j in heads]


def local_kv(kv_of) -> list:
    """The kv heads a rank's attention takes for its q heads' ``kv_of``
    (``local_heads``): each once where the heads fall in whole groups of
    one run of kv heads (GQA kept), else one a q head."""
    hl, n = len(kv_of), len(set(kv_of))
    if hl % n == 0 and list(kv_of) == [kv_of[0] + i * n // hl
                                       for i in range(hl)]:
        return list(range(kv_of[0], kv_of[0] + n))
    return list(kv_of)


def _attend_split(fn: Callable, q, k, v, mesh, q_offset: int):
    """``_attend_local`` where the head counts do not divide the ``model``
    axis of ``m`` ranks and ``fn`` runs the blockwise loop, as GSPMD
    splits the group x query dim: each rank takes ``H / g`` q heads and
    one of ``c`` chunks of the query positions (``query_split``), so
    ``fn`` runs at ``q_offset`` plus its chunk's start, the causal mask at
    absolute positions.  A length ``c`` does not divide is padded with
    zero query rows, whose outputs are dropped.  The kv heads, which do
    not divide, are replicated over ``model``, whole along the sequence,
    and each rank takes those its heads read (``local_kv``).  Where the q
    heads divide (``c == 1``) they are split as they are.  q's gradient
    is each rank's (heads, chunk) block, and k's and v's are partial sums
    over ``model``.  The blocks are gathered over ``model`` into the
    whole-heads layout ``split_heads`` gives heads that do not divide."""
    from torch.distributed.tensor import DTensor, Partial
    dm = q.device_mesh
    m = mesh.shape["model"]
    b, sq, h, _ = q.shape
    ba = batch_spec_axes(mesh, b)
    whole = placements(mesh, _fit_spec(mesh, P(ba, None, None, None),
                                       tuple(q.shape)))
    mi = [n for n in mesh.axis_names if mesh.shape[n] > 1].index("model")
    part = [Partial() if i == mi else pl for i, pl in enumerate(whole)]
    heads, chunk, c = query_split(h, m, dm.get_local_rank("model"))
    g, hl, cs = m // c, len(heads), -(-sq // c)
    if c == 1:
        ql = _ContiguousGrad.apply(q.redistribute(dm, placements(
            mesh, _fit_spec(mesh, P(ba, None, "model", None),
                            tuple(q.shape)))).to_local())
    else:
        qw = q.redistribute(dm, whole).to_local(grad_placements=part)
        ql = _ContiguousGrad.apply(qw)[:, chunk * cs:(chunk + 1) * cs,
                                       heads.start:heads.stop]
        ql = torch.nn.functional.pad(ql, (0, 0, 0, 0, 0, cs - ql.shape[1]))
    kv = [_ContiguousGrad.apply(t.redistribute(dm, whole).to_local(
        grad_placements=part)) for t in (k, v)]
    grp = h // k.shape[2]
    idx = torch.tensor(local_kv([j // grp for j in heads]),
                       device=kv[0].device)
    out = fn(ql, *(t.index_select(2, idx) for t in kv),
             q_offset + chunk * cs)
    dv = out.shape[-1]
    # rank r = chunk * g + group holds the block [B, cs, H / g, Dv]:
    # gathered as [B, m, cs, H / g, Dv] and laid out as [B, c * cs, H, Dv]
    blocks = DTensor.from_local(out.contiguous()[:, None], dm, placements(
        mesh, _fit_spec(mesh, P(ba, "model", None, None, None),
                        (b, m, cs, hl, dv))), run_check=False)
    out = blocks.redistribute(dm, placements(mesh, _fit_spec(
        mesh, P(ba, None, None, None, None), (b, m, cs, hl, dv)))).to_local()
    out = out.reshape(out.shape[0], c, g, cs, hl, dv).permute(
        0, 1, 3, 2, 4, 5).reshape(out.shape[0], c * cs, h, dv)[:, :sq]
    return DTensor.from_local(out, dm, whole, run_check=False)


def _attend_padded(fn: Callable, q, k, v, mesh, q_offset: int):
    """``_attend_local`` where the head counts do not divide the ``model``
    axis of ``m`` ranks and ``fn`` runs the flash kernel, which needs the
    whole sequence from position 0 (``Sq == Skv``): the q heads are padded
    up to a multiple of ``m`` with zero heads and split, ``ceil(H / m)`` a
    rank; the kv heads, which do not divide, are replicated over
    ``model``, and each rank takes those its heads read (``local_kv``).
    The padded heads' outputs are dropped, so their gradients are zero,
    and q's and k's and v's gradients are partial sums over ``model`` of
    each rank's heads.  The outputs are gathered over ``model``: the
    result's heads are whole there (the layout ``split_heads`` gives heads
    that do not divide)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dm = q.device_mesh
    m = mesh.shape["model"]
    h, kvh = q.shape[2], k.shape[2]
    ba = batch_spec_axes(mesh, q.shape[0])
    whole = placements(mesh, _fit_spec(mesh, P(ba, None, None, None),
                                       tuple(q.shape)))
    mi = [n for n in mesh.axis_names if mesh.shape[n] > 1].index("model")
    part = [Partial() if i == mi else pl for i, pl in enumerate(whole)]
    heads, kv_of = local_heads(h, kvh, m, dm.get_local_rank("model"))
    hl = len(heads)
    if h % m == 0:          # the q heads divide: split them as they are
        ql = _ContiguousGrad.apply(q.redistribute(dm, placements(
            mesh, _fit_spec(mesh, P(ba, None, "model", None),
                            tuple(q.shape)))).to_local())
    else:
        qw = q.redistribute(dm, whole).to_local(grad_placements=part)
        ql = _ContiguousGrad.apply(qw)[:, :, heads.start:min(heads.stop, h)]
        ql = torch.nn.functional.pad(ql, (0, 0, 0, hl - ql.shape[2]))
    kv = [_ContiguousGrad.apply(t.redistribute(dm, whole).to_local(
        grad_placements=part)) for t in (k, v)]
    idx = torch.tensor(local_kv(kv_of), device=kv[0].device)
    out = fn(ql, *(t.index_select(2, idx) for t in kv), q_offset).contiguous()
    split = placements(mesh, _fit_spec(mesh, P(ba, None, "model", None),
                                       (q.shape[0], 1, m * hl, 1)))
    out = DTensor.from_local(out, dm, split, run_check=False)
    out = out.redistribute(dm, whole).to_local()[:, :, :h]
    return DTensor.from_local(out, dm, whole, run_check=False)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, q_offset: int = 0,
                        kv_block: int = 512,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Sq, H, Dk]; k: [B, Skv, KVH, Dk]; v: [B, Skv, KVH, Dv].
    ``q_offset`` is the absolute position of q[0] for the causal mask."""
    _, sq, _, dk = q.shape
    skv, dv = v.shape[1], v.shape[3]
    # the reference's dispatch condition for the flash kernel
    kernel = (_ATTN_IMPL == "pallas" and dk == dv and q_offset == 0
              and sq == skv and sq % 16 == 0)
    if is_dtensor(q):
        def local(ql, kl, vl, offset):
            return blockwise_attention(ql, kl, vl, causal=causal,
                                       q_offset=offset, kv_block=kv_block,
                                       scale=scale)
        return _attend_local(local, q, k, v, q_offset=q_offset,
                             split_queries=not kernel)
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    if kernel:
        # the kernel reads the [B, S, H, D] tensors through transposed
        # views
        out = flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 scale=scale, block_q=min(128, sq),
                                 block_k=min(128, skv))
        return out.transpose(1, 2)
    if skv <= kv_block:  # small sequences: one block, no loop
        return _plain_attention(
            q, k, v, _causal_bias(sq, skv, q_offset, causal, q.device), scale)
    if skv % kv_block != 0:
        kv_block = next(b for b in range(kv_block, 0, -1) if skv % b == 0)
    return _FlashAttention.apply(q, k, v, causal, q_offset, kv_block, scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     scale: Optional[float] = None, offset: int = 0,
                     group: Optional[dist.ProcessGroup] = None
                     ) -> torch.Tensor:
    """One-token attention over a [B, S, KVH, D] cache; q: [B, H, D].

    Positions from ``length`` on are masked.  The scores are f32 from the
    cache's own values, as ``preferred_element_type=f32`` gives them in the
    reference: a bf16 cache is widened to f32 for the score product (one
    layer's k at a time), not multiplied in bf16, which would round each
    score to bf16.  The probabilities go back to the cache's dtype for the
    product with v, as in the reference.

    With ``group`` the cache is this rank's slice of a sequence split over
    ``group``, starting at position ``offset``: the softmax is split, each
    rank's scores reduced to the group's max and sum of exponentials by
    two all-reduces, and the ranks' partial products summed (in f32) by a
    third."""
    b, s, kvh, dk = k_cache.shape
    h = q.shape[1]
    g = h // kvh
    dv = v_cache.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = q.reshape(b, kvh, g, dk).to(torch.float32)
    # one pass: widen and lay k out as [B, KVH, S, D] for the batched product
    kf = torch.empty((b, kvh, s, dk), dtype=torch.float32,
                     device=k_cache.device)
    kf.copy_(k_cache.permute(0, 2, 1, 3))
    scores = torch.matmul(qg, kf.transpose(-1, -2)) * scale  # [B,KVH,G,S]
    del kf
    valid = offset + torch.arange(s, device=q.device) < length
    probs = _split_softmax(torch.where(valid, scores, NEG_INF), group)
    out = _sum_blocks(torch.matmul(probs.to(v_cache.dtype),
                                   v_cache.permute(0, 2, 1, 3)), group)
    return out.reshape(b, 1, h, dv)


def _split_softmax(scores: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The softmax over the last dim of ``scores``; with ``group`` each
    rank holds a block of the positions, and the max and the sum of the
    exponentials are reduced over the group by two all-reduces."""
    if group is None:
        return torch.softmax(scores, dim=-1)
    peak = torch.amax(scores, dim=-1, keepdim=True)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    probs = torch.exp(scores - peak)
    total = torch.sum(probs, dim=-1, keepdim=True)
    dist.all_reduce(total, group=group)
    return probs / total


def _sum_blocks(out: torch.Tensor,
                group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The ranks' partial products over their blocks of positions summed
    over ``group`` in f32 (``out`` itself without a group)."""
    if group is None:
        return out
    out32 = out.to(torch.float32)
    dist.all_reduce(out32, group=group)
    return out32.to(out.dtype)


class _CacheBlock:
    """This rank's block of a DTensor decode cache laid out by
    ``cache_shardings`` (the batch over the data axes, the sequence over
    ``model``): the new token's placements (the cache's batch layout,
    replicated elsewhere), the block's first position ``lo`` and length,
    and the group its sequence is split over (None where it is whole).
    Decode splits the positions, not the heads, whatever the head counts:
    each rank attends every head of its block with the split softmax, as
    the reference's cache rules lay the cache out, so the head and query
    splits of training and prefill (``_attend_split``, ``_attend_padded``)
    do not apply."""

    def __init__(self, cache: torch.Tensor):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh, cpl = cache.device_mesh, cache.placements
        self.tok = [Shard(0) if pl == Shard(0) else Replicate()
                    for pl in cpl]
        seq = [i for i, pl in enumerate(cpl) if pl == Shard(1)]
        if len(seq) > 1:
            raise ValueError(f"cache sequence split over {len(seq)} mesh "
                             "axes; the cache rules split it over model "
                             "only")
        self.n = cache.to_local().shape[1]
        self.lo, self.group = 0, None
        if seq:
            self.lo = self.mesh.get_coordinate()[seq[0]] * self.n
            self.group = self.mesh.get_group(seq[0])

    def holds(self, pos: int) -> bool:
        return self.lo <= pos < self.lo + self.n

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """A token tensor's local rows in the token layout."""
        return t.redistribute(self.mesh, self.tok).to_local()

    def wrap(self, t: torch.Tensor) -> torch.Tensor:
        """A local result in the token layout, as a DTensor."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, self.tok, run_check=False)


def _decode_sharded(q, k, v, k_cache, v_cache, pos: int):
    """``gqa_decode``'s write and attention on a DTensor cache: the rank
    holding position ``pos`` writes the new k and v into its block in
    place, and every rank attends over its block (``decode_attention``
    with the ``model`` group: the split softmax).  Returns the attention
    output [B, 1, H, D] in the token's layout."""
    blk = _CacheBlock(k_cache)
    ql, kl, vl = (blk.local(t) for t in (q, k, v))
    kc, vc = k_cache.to_local(), v_cache.to_local()
    if blk.holds(pos):
        kc[:, pos - blk.lo] = kl[:, 0]
        vc[:, pos - blk.lo] = vl[:, 0]
    return blk.wrap(decode_attention(ql[:, 0], kc, vc, pos + 1,
                                     offset=blk.lo, group=blk.group))


# --------------------------------------------------------------------------- #
# GQA attention layer
# --------------------------------------------------------------------------- #
def init_gqa(gen: torch.Generator, cfg: ModelConfig, n: int, *,
             dtype: torch.dtype, device: torch.device) -> Params:
    """``n`` stacked layers' attention params, leading dim ``n``."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "wq": dense_init(gen, (n, d, h * hd), **kw),
        "wk": dense_init(gen, (n, d, kvh * hd), **kw),
        "wv": dense_init(gen, (n, d, kvh * hd), **kw),
        "wo": dense_init(gen, (n, h * hd, d),
                         scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h * hd), **kw)
        p["bk"] = torch.zeros((n, kvh * hd), **kw)
        p["bv"] = torch.zeros((n, kvh * hd), **kw)
    return p


def _promote(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` in the type JAX gives ``x @ w``: bf16 input against f32
    weights (whisper's bf16 stub frames in an f32 model) is widened, as
    ``jnp.matmul`` promotes; ``torch.matmul`` refuses mixed types."""
    return x.to(torch.promote_types(x.dtype, w.dtype))


def _q_proj(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ wq`` (plus ``bq``), x widened as JAX's promotion would."""
    q = dense(_promote(x, p["wq"]), p["wq"])
    return q + p["bq"] if "bq" in p else q


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = whole_rows(_promote(x, p["wq"]))      # once for the three
    q = dense(x, p["wq"])
    k = dense(x, p["wk"])
    v = dense(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return split_heads(q, h, hd), split_heads(k, kvh, hd), split_heads(
        v, kvh, hd)


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[..., n * hd] -> [..., n, hd].  A DTensor split along its last dim
    into pieces that hold no whole number of heads (2 KV heads over a
    ``model`` axis of 4) is made whole along it first: DTensor cannot
    unflatten such a split.  ``_attend_local`` then splits the q heads
    over ``model`` again, with the query positions where they do not divide
    (``_attend_split``; padded under the flash kernel, ``_attend_padded``),
    and the kv heads stay whole there."""
    if is_dtensor(t):
        from torch.distributed.tensor import Shard
        pieces = math.prod(size for size, pl in zip(
            t.device_mesh.shape, t.placements)
            if isinstance(pl, Shard) and pl.dim == t.ndim - 1)
        if n % pieces:
            t = whole_last_dim(t)
    return t.reshape(*t.shape[:-1], n, hd)


class _MergeHeads(torch.autograd.Function):
    """[..., n, hd] -> [..., n * hd], whose backward makes the gradient
    whole along its last dim where a DTensor splits it into pieces that
    hold no whole number of heads (14 heads over a ``model`` axis of 16:
    ``wo``'s rows split into 56-row pieces), as ``split_heads`` does
    forward: DTensor cannot unflatten such a split."""

    @staticmethod
    def forward(ctx, t):
        ctx.n = t.shape[-2]
        return t.reshape(*t.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.n, g.shape[-1] // ctx.n)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[..., n, hd] -> [..., n * hd]."""
    return _MergeHeads.apply(t) if is_dtensor(t) else t.reshape(
        *t.shape[:-2], -1)


def gqa_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                causal: bool = True, kv_block: int = 512,
                xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (train / prefill).  Returns (out, kv) where
    kv is the cache contribution {k, v}: [B, S, KVH, D] after RoPE.

    With ``xattn_kv = (k, v)`` (the encoder's, [B, F, KVH, D]) this is
    cross-attention: q (with ``bq``) from x, k and v as given, no mask and
    no rope.  The reference also projects x's own k and v there and
    discards them (XLA drops that work under ``jit``); they are not
    computed here."""
    b, s, _ = x.shape
    if xattn_kv is not None:
        q = split_heads(_q_proj(p, x), cfg.n_heads, cfg.head_dim)
        k, v = xattn_kv
        causal = False
    else:
        q, k, v = _qkv(p, x, cfg)
        if cfg.rope:
            pos = torch.arange(s, device=x.device)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
    out = blockwise_attention(q, k, v, causal=causal, kv_block=kv_block)
    return dense(merge_heads(out), p["wo"]), {"k": k, "v": v}


def _rope_at(q, k, pos: int, cfg: ModelConfig):
    posv = torch.full((1,), pos, device=q.device)
    return (apply_rope(q, posv, cfg.rope_theta),
            apply_rope(k, posv, cfg.rope_theta))


def gqa_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: [B, 1, d]; cache {k, v}: [B, S, KVH, D];
    ``pos``: the current position (cache length so far).  Position ``pos``
    of the cache tensors is written in place; the returned dict holds the
    same tensors."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        q, k = _rope_at(q, k, pos, cfg)
    if is_dtensor(cache["k"]):
        out = _decode_sharded(q, k, v, cache["k"], cache["v"], pos)
    else:
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        out = decode_attention(q[:, 0], cache["k"], cache["v"], pos + 1)
    return dense(out.reshape(b, 1, -1), p["wo"]), {"k": cache["k"],
                                                   "v": cache["v"]}


def gqa_cross_decode(p: Params, x: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Cross-attention of one decode token x [B, 1, d] against the fixed
    encoder k, v [B, F, KVH, D], its first ``n_valid`` frames.  On a
    DTensor k and v laid out by ``cache_shardings`` (the frames over
    ``model``) every rank attends over its block of frames, with the split
    softmax; k and v are only read."""
    d = k.shape[3]
    q = _q_proj(p, x)
    q = split_heads(q, q.shape[-1] // d, d)[:, 0]               # [B, H, D]
    if is_dtensor(k):
        blk = _CacheBlock(k)
        out = blk.wrap(decode_attention(blk.local(q), k.to_local(),
                                        v.to_local(), n_valid, offset=blk.lo,
                                        group=blk.group))
    else:
        out = decode_attention(q, k, v, n_valid)
    return dense(out.reshape(x.shape[0], 1, -1), p["wo"])


def quantize_kv(t: torch.Tensor, *, reciprocal: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], f32 scale [...]): one symmetric scale per
    head vector, ``max(max|t| / 127, 1e-30)``.  ``reciprocal=True`` takes
    the division as the reference's jitted decode does (a multiply by
    f32(1/127)), ``False`` as its eager one (``flatbuf.int8_scale``)."""
    tf32 = t.to(torch.float32)
    s = int8_scale(tf32.abs().amax(dim=-1), reciprocal=reciprocal)
    return encode_int8(tf32, s[..., None]), s


def gqa_decode_q8(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  pos: int, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against an int8 KV cache.

    Cache: {k_q, v_q: int8 [B,S,KVH,D]; k_s, v_s: f32 [B,S,KVH]}, one
    symmetric scale per (position, KV head), written in place at ``pos``.
    The reference computes the scale as ``max|t| / 127.0``, which ``jit``
    (its serving path) turns into a multiply by f32(1/127); this is the
    jitted scale (``quantize_kv``).  On a DTensor cache (the sequence over
    ``model``) the new token is quantized whole, the rank holding ``pos``
    writes it into its block, and every rank attends over its block with
    the split softmax, every head, as ``gqa_decode`` does (``_CacheBlock``:
    the heads are not split in decode)."""
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        q, k = _rope_at(q, k, pos, cfg)
    names = ("k_q", "v_q", "k_s", "v_s")
    blk = _CacheBlock(cache["k_q"]) if is_dtensor(cache["k_q"]) else None
    if blk is not None:
        q, k, v = (blk.local(t) for t in (q, k, v))
    k_q, v_q, k_s, v_s = (cache[n].to_local() if blk else cache[n]
                          for n in names)
    lo, group = (blk.lo, blk.group) if blk else (0, None)
    if blk is None or blk.holds(pos):
        for (tq, ts), t in (((k_q, k_s), k), ((v_q, v_s), v)):
            qv, sv = quantize_kv(t)
            tq[:, pos - lo] = qv[:, 0]
            ts[:, pos - lo] = sv[:, 0]

    kvh, h, dk = k_q.shape[2], q.shape[2], q.shape[-1]
    g = h // kvh
    scale = 1.0 / math.sqrt(dk)
    b = q.shape[0]                      # this rank's rows
    qg = q[:, 0].reshape(b, kvh, g, dk).to(torch.float32)
    # scores on the int8 payload, per-position scales folded in afterwards
    scores = torch.matmul(qg, k_q.permute(0, 2, 3, 1).to(torch.float32)
                          ) * scale
    scores = scores * k_s.transpose(1, 2)[:, :, None, :]
    valid = lo + torch.arange(k_q.shape[1], device=x.device) < pos + 1
    probs = _split_softmax(torch.where(valid, scores, NEG_INF), group)
    probs_v = probs * v_s.transpose(1, 2)[:, :, None, :]
    out = _sum_blocks(torch.matmul(
        probs_v, v_q.permute(0, 2, 1, 3).to(torch.float32)), group)
    out = out.reshape(b, 1, h * v_q.shape[-1]).to(x.dtype)
    if blk is not None:
        out = blk.wrap(out)
    return dense(out, p["wo"]), {n: cache[n] for n in names}


# --------------------------------------------------------------------------- #
# DeepSeek-V2 multi-head latent attention (MLA)
# --------------------------------------------------------------------------- #
# f32 elements of one widened slice of the latent cache in ``mla_decode``'s
# score product: 1 GB, a few slices at decode_32k's batch of 128
_MLA_SCORE_ELEMS = 1 << 28


def init_mla(gen: torch.Generator, cfg: ModelConfig, n: int, *,
             dtype: torch.dtype, device: torch.device) -> Params:
    """``n`` stacked layers' MLA params: the low-rank q path, the latent
    ``kv_down`` (rank R plus the shared rope key), ``k_up``/``v_up`` out of
    the latent and ``wo``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "q_down": dense_init(gen, (n, d, m.q_lora_rank), **kw),
        "q_up": dense_init(gen, (n, m.q_lora_rank, h * qk), **kw),
        "kv_down": dense_init(gen, (n, d, m.kv_lora_rank
                                    + m.qk_rope_head_dim), **kw),
        "k_up": dense_init(gen, (n, m.kv_lora_rank,
                                 h * m.qk_nope_head_dim), **kw),
        "v_up": dense_init(gen, (n, m.kv_lora_rank, h * m.v_head_dim), **kw),
        "wo": dense_init(gen, (n, h * m.v_head_dim, d),
                         scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }


def _mla_q(p: Params, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope] after rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    q = dense(dense(x, p["q_down"]), p["q_up"]).reshape(
        b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, pos, cfg.rope_theta)


def _mla_latent(p: Params, x: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the cache holds for x [B, S, d]: (ckv [B, S, R], krope [B, S,
    rope] after rope), the latent unnormalized, as in the reference."""
    ckv, krope = torch.split(whole_last_dim(dense(x, p["kv_down"])), [
        cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim], dim=-1)
    return ckv, apply_rope(krope[:, :, None, :], pos, cfg.rope_theta)[:, :,
                                                                       0]


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim
                           + cfg.mla.qk_rope_head_dim)


def mla_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                kv_block: int = 512
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train/prefill MLA over [B, S, d]: the latent expanded into per-head
    keys (nope part from ``k_up``, the one rope key broadcast to every
    head) and values, then ``blockwise_attention``.  With head dims 192
    and 128 (dk != dv) that is the blockwise loop under either impl, as
    in the reference.  Returns (out, the cache contribution {ckv, krope})."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    pos = torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(p, x, pos, cfg)
    ckv, krope = _mla_latent(p, x, pos, cfg)
    k_nope = dense(ckv, p["k_up"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = dense(ckv, p["v_up"]).reshape(b, s, h, m.v_head_dim)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim).to(k_nope.dtype)], dim=-1)
    out = blockwise_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                              causal=True, kv_block=kv_block,
                              scale=_mla_scale(cfg))
    return dense(merge_heads(out), p["wo"]), {"ckv": ckv, "krope": krope}


def _f32_scores(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q [B, H, R] against c [B, S, R] -> [B, H, S] f32 of the stored
    values (``preferred_element_type=f32``), c widened to f32 a slice of
    positions at a time so the widened copy stays small."""
    b, s, r = c.shape
    qf = q.to(torch.float32)
    out = torch.empty((b, q.shape[1], s), dtype=torch.float32,
                      device=c.device)
    step = max(1, _MLA_SCORE_ELEMS // (b * r))
    for i in range(0, s, step):
        out[..., i:i + step] = torch.matmul(
            qf, c[:, i:i + step].to(torch.float32).transpose(1, 2))
    return out


def mla_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-form MLA decode against the latent cache {ckv: [B, S, R],
    krope: [B, S, rope]}, position ``pos`` written in place.  q is
    absorbed through ``k_up`` (a product in the model's dtype), the scores
    are f32 from the stored latent, the probabilities go back to the
    cache's dtype for the product with ``ckv``, and the latent output is
    expanded through ``v_up``: the cache stays compressed."""
    m = cfg.mla
    b = x.shape[0]
    h, r = cfg.n_heads, m.kv_lora_rank
    posv = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, x, posv, cfg)
    ckv_new, krope_new = _mla_latent(p, x, posv, cfg)
    k_up = p["k_up"].reshape(r, h, m.qk_nope_head_dim)
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], k_up)
    q_rope = q_rope[:, 0]
    ckv, krope = cache["ckv"], cache["krope"]
    blk = _CacheBlock(ckv) if is_dtensor(ckv) else None
    if blk is not None:
        # this rank's block of the latent (the sequence over ``model``)
        q_eff, q_rope, ckv_new, krope_new = (blk.local(t) for t in (
            q_eff, q_rope, ckv_new, krope_new))
        ckv, krope = ckv.to_local(), krope.to_local()
    lo, group = (blk.lo, blk.group) if blk else (0, None)
    if blk is None or blk.holds(pos):
        ckv[:, pos - lo] = ckv_new[:, 0]
        krope[:, pos - lo] = krope_new[:, 0]

    scores = _f32_scores(q_eff, ckv)
    scores += _f32_scores(q_rope, krope)
    scores *= _mla_scale(cfg)
    valid = lo + torch.arange(ckv.shape[1], device=x.device) < pos + 1
    probs = _split_softmax(scores.masked_fill_(~valid, NEG_INF), group)
    del scores
    out_latent = _sum_blocks(torch.matmul(probs.to(ckv.dtype), ckv),
                             group)                           # [B, H, R]
    if blk is not None:
        out_latent = blk.wrap(out_latent)
    out = torch.einsum("bhr,rhd->bhd", out_latent,
                       p["v_up"].reshape(r, h, m.v_head_dim))
    return dense(out.reshape(b, 1, h * m.v_head_dim), p["wo"]), {
        "ckv": cache["ckv"], "krope": cache["krope"]}
