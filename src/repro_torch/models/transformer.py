"""The decoder stack: the reference's ``repro/models/transformer.py`` for
every config, with the stubbed vision prefix; an encoder-decoder config
(whisper) adds ``encoder`` and ``cross`` params and its ``forward`` and
``decode_step`` go to ``models/encdec.py``.

A layer is a token mixer and an MLP, each behind a pre-norm (rmsnorm or
layernorm) and a residual add.  ``cfg.layer_kind(idx)`` picks the mixer:
"a" GQA attention, "l" DeepSeek-V2's latent attention (MLA,
``attention.mla_forward``), "m" mamba (``models/mamba.py``), "r" the RWKV6
time mix (``models/rwkv.py``).  The MLP is the RWKV channel mix on an "r"
layer, the experts ``{router, w_gate, w_up, w_down[, shared]}``
(``models/moe.py``: an f32 router beside the model's dtype) on a layer
where ``cfg.moe.is_moe_layer(idx)`` ("all", "odd" or "even" layers), and
the dense MLP otherwise: ``{up, down}``, with ``gate`` for silu and
``up_b``/``down_b`` with ``cfg.mlp_bias``.  An MoE layer adds its
load-balance loss to the stack's auxiliary loss, and ``loss_fn`` returns
``loss + AUX_LOSS_COEF * aux``.

Params are the reference's tree: ``embeds/{embed[, lm_head]}``,
``final_norm/{scale[, bias]}`` and ``layers``.  A homogeneous stack (one
layer kind, experts on all layers or none) is ``{"layers": {mix, mlp,
norm1, norm2}}`` with every leaf stacked ``[L, ...]``.  A heterogeneous
one (``cfg.group_size > 1``: jamba's "mmmammmm" with experts on odd
layers, groups of 8) is ``{"layers": (slot_0, ..., slot_{gs-1})}``: slot s
holds layer ``g * gs + s`` of every group g, its leaves stacked ``[G,
...]``.  The layout matters beyond tidiness: the flat wire pads each
*leaf* to a quantization block and the checkpoint names leaves by their
path (``layers/3/mix/wq``), so another layout would move the block
boundaries and the names.  The forward unbinds each stacked leaf once and
loops over the layers in Python (the reference scans over layers or
groups); ``unbind``'s backward stacks the per-layer grads in one copy.
With ``remat`` (the default, as in the reference) each layer, never a
group, runs under ``torch.utils.checkpoint``: the backward keeps only each
layer's input and recomputes its internals.

A ``frontend="vision"`` config (phi-3-vision) takes precomputed patch
embeddings as ``batch["frontend_embeds"]`` ``[B, n_frontend_tokens, d]``:
``embed_inputs`` puts them before the token embeddings, the positions run
on through the text, and ``loss_fn`` scores the text positions only.  The
vision tower itself is a stub in the reference too.

Serving: ``prefill`` runs the forward once and returns the last position's
logits and the cache, in the params' layout (stacked ``[L, ...]`` or a
tuple of slots stacked ``[G, ...]``).  Per layer kind the cache is:

  attention   {k, v}:            [B, S, KVH, Dh] (int8: {k_q, v_q, k_s, v_s})
  MLA         {ckv, krope}:      [B, S, R] / [B, S, rope]
  mamba       {conv, ssm}:       [B, K-1, d_inner] / [B, d_inner, n] f32
  rwkv        {shift, wkv, cm_shift}: [B, 1, d] / [B, H, D, D] f32 / [B, 1, d]

A prefill's mamba and rwkv entries are the states after its last token.
``init_cache`` makes a zero cache of ``max_len`` positions and
``decode_step`` runs one token per sequence against it.  The reference
returns a new cache from each step and donates the old one to ``jit``;
here the step writes its position, and the recurrent layers their new
states, into the cache tensors in place and returns the same tensors,
which is what keeps a ``decode_32k`` cache (51.5 GB in bf16 for
Qwen2-0.5B at batch 128) to one copy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..dist.policy import constrain
from ..dist.sharding import to_cache_layout
from ..obs.trace import region
from . import attention as attn
from . import mamba as mamba_mod
from . import rwkv as rwkv_mod
from .layers import (Params, apply_mlp, apply_norm, chunked_loss,
                     embed_tokens, init_embeddings, init_mlp, init_norm,
                     is_dtensor, unembed, whole_rows)
from .moe import init_moe, moe_forward

AUX_LOSS_COEF = 0.01


def _is_moe_layer(cfg: ModelConfig, idx: int) -> bool:
    return cfg.moe is not None and cfg.moe.is_moe_layer(idx)


# --------------------------------------------------------------------------- #
# per-layer init
# --------------------------------------------------------------------------- #
def init_layer(gen: torch.Generator, cfg: ModelConfig, idx: int, n: int, *,
               dtype: torch.dtype, device: torch.device) -> Params:
    """Layer ``idx``'s params, ``n`` of them stacked on a leading axis (the
    layers of a homogeneous stack, or one slot's over the groups)."""
    kind = cfg.layer_kind(idx)
    kw = dict(dtype=dtype, device=device)
    if kind == "a":
        mix = attn.init_gqa(gen, cfg, n, **kw)
    elif kind == "l":
        mix = attn.init_mla(gen, cfg, n, **kw)
    elif kind == "m":
        mix = mamba_mod.init_mamba(gen, cfg, n, **kw)
    elif kind == "r":
        mix = rwkv_mod.init_rwkv(gen, cfg, n, **kw)
    else:
        raise ValueError(kind)
    if kind == "r":
        mlp = rwkv_mod.init_channel_mix(gen, cfg, n, **kw)
    elif _is_moe_layer(cfg, idx):
        mlp = init_moe(gen, cfg, (n,), **kw)
    else:
        mlp = init_mlp(gen, (n,), cfg.d_model, cfg.d_ff, act=cfg.act,
                       bias=cfg.mlp_bias, **kw)
    return {"mix": mix, "mlp": mlp,
            "norm1": init_norm(cfg.norm, (n, cfg.d_model), **kw),
            "norm2": init_norm(cfg.norm, (n, cfg.d_model), **kw)}


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                dtype: torch.dtype, device: torch.device) -> Params:
    gs = cfg.group_size
    kw = dict(dtype=dtype, device=device)
    embeds = init_embeddings(gen, cfg.padded_vocab, cfg.d_model,
                             tie=cfg.tie_embeddings, **kw)
    if gs == 1:
        layers = init_layer(gen, cfg, 0, cfg.n_layers, **kw)
    else:
        layers = tuple(init_layer(gen, cfg, s, cfg.n_groups, **kw)
                       for s in range(gs))
    p = {"embeds": embeds,
         "final_norm": init_norm(cfg.norm, (cfg.d_model,), **kw),
         "layers": layers}
    if cfg.encoder is not None:
        from . import encdec
        p["encoder"] = encdec.init_encoder(gen, cfg, **kw)
        p["cross"] = encdec.init_cross_layers(gen, cfg, **kw)
    return p


# --------------------------------------------------------------------------- #
# per-layer apply (train/prefill mode and decode mode)
# --------------------------------------------------------------------------- #
def layer_forward(p: Params, h: torch.Tensor, cfg: ModelConfig, idx: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             Optional[torch.Tensor]]:
    """Full-sequence layer ``idx``.  Returns (h, its cache contribution,
    the MoE aux loss or None)."""
    kind = cfg.layer_kind(idx)
    hn = apply_norm(cfg.norm, p["norm1"], h)
    if kind in ("a", "l"):
        mix = attn.gqa_forward if kind == "a" else attn.mla_forward
        with region("mlfabric.attention", layer=idx):
            mix_out, cache = mix(p["mix"], hn, cfg)
    elif kind == "m":
        mix_out, cache = mamba_mod.mamba_forward(p["mix"], hn, cfg)
    elif kind == "r":
        mix_out, cache = rwkv_mod.rwkv_time_mix(p["mix"], hn, cfg)
    else:
        raise ValueError(kind)
    h = constrain(h + mix_out, "residual")
    hn = apply_norm(cfg.norm, p["norm2"], h)
    aux = None
    if kind == "r":
        mlp_out, cm_state = rwkv_mod.channel_mix(p["mlp"], hn)
        cache = {**cache, **cm_state}
    elif _is_moe_layer(cfg, idx):
        with region("mlfabric.moe", layer=idx):
            mlp_out, aux = moe_forward(p["mlp"], hn, cfg)
    else:
        mlp_out = apply_mlp(p["mlp"], hn, act=cfg.act)
    return constrain(h + mlp_out, "residual"), cache, aux


def _layer_h(p: Params, h: torch.Tensor, cfg: ModelConfig, idx: int):
    """``layer_forward`` without the cache contribution: what a
    rematerialized layer returns, so the checkpoint keeps no cache as an
    output.  h alone for a dense layer, (h, aux) for an MoE layer."""
    h, _, aux = layer_forward(p, h, cfg, idx)
    return h if aux is None else (h, aux)


def layer_decode(p: Params, h: torch.Tensor, cache: Params, pos: int,
                 cfg: ModelConfig, idx: int) -> Tuple[torch.Tensor, Params]:
    """One-token step of layer ``idx`` against its cache, which is written
    in place and returned."""
    kind = cfg.layer_kind(idx)
    hn = apply_norm(cfg.norm, p["norm1"], h)
    if kind == "a" and "k_q" in cache:
        mix_out, _ = attn.gqa_decode_q8(p["mix"], hn, cache, pos, cfg)
    elif kind == "a":
        mix_out, _ = attn.gqa_decode(p["mix"], hn, cache, pos, cfg)
    elif kind == "l":
        mix_out, _ = attn.mla_decode(p["mix"], hn, cache, pos, cfg)
    elif kind == "m":
        mix_out, _ = mamba_mod.mamba_decode(p["mix"], hn, cache, cfg)
    elif kind == "r":
        mix_out, _ = rwkv_mod.rwkv_decode(p["mix"], hn, cache, cfg)
    else:
        raise ValueError(kind)
    h = h + mix_out
    hn = apply_norm(cfg.norm, p["norm2"], h)
    if kind == "r":
        mlp_out, cm_state = rwkv_mod.channel_mix(
            p["mlp"], hn, state={"cm_shift": cache["cm_shift"]})
        cache["cm_shift"].copy_(cm_state["cm_shift"])
    elif _is_moe_layer(cfg, idx):
        mlp_out, _ = moe_forward(p["mlp"], hn, cfg)
    else:
        mlp_out = apply_mlp(p["mlp"], hn, act=cfg.act)
    return h + mlp_out, cache


def _unbind_layers(tree, n: int):
    """Stacked layer tree -> list of ``n`` per-layer trees (views)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


def _per_layer(layers, cfg: ModelConfig) -> List[Params]:
    """The stack's ``layers`` tree (params or cache) -> one tree of views
    per layer, in layer order."""
    gs = cfg.group_size
    if gs == 1:
        return _unbind_layers(layers, cfg.n_layers)
    slots = [_unbind_layers(slot, cfg.n_groups) for slot in layers]
    return [slots[i % gs][i // gs] for i in range(cfg.n_layers)]


# --------------------------------------------------------------------------- #
# cache init
# --------------------------------------------------------------------------- #
def layer_cache_spec(cfg: ModelConfig, idx: int, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16, *,
                     kv_int8: bool = False
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of layer ``idx``'s cache."""
    kind = cfg.layer_kind(idx)
    if kind == "a":
        shp = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        if kv_int8:
            sshp = (batch, max_len, cfg.n_kv_heads)
            return {"k_q": (shp, torch.int8), "v_q": (shp, torch.int8),
                    "k_s": (sshp, torch.float32),
                    "v_s": (sshp, torch.float32)}
        return {"k": (shp, dtype), "v": (shp, dtype)}
    if kind == "l":
        m = cfg.mla
        return {"ckv": ((batch, max_len, m.kv_lora_rank), dtype),
                "krope": ((batch, max_len, m.qk_rope_head_dim), dtype)}
    if kind == "m":
        mm = cfg.mamba
        di = mm.inner(cfg.d_model)
        return {"conv": ((batch, mm.d_conv - 1, di), dtype),
                "ssm": ((batch, di, mm.d_state), torch.float32)}
    if kind == "r":
        r = cfg.rwkv
        h = r.n_heads(cfg.d_model)
        return {"shift": ((batch, 1, cfg.d_model), dtype),
                "wkv": ((batch, h, r.head_dim, r.head_dim), torch.float32),
                "cm_shift": ((batch, 1, cfg.d_model), dtype)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, kv_int8: bool = False,
               device: Union[str, torch.device] = "cpu") -> Params:
    """Zero cache in the params' layout: every leaf stacked ``[L, ...]``,
    or a tuple of ``group_size`` slots stacked ``[G, ...]``.  An
    encoder-decoder's decode also needs a prefill's ``cross_kv``, which
    the caller adds (``models/encdec.py``)."""
    gs = cfg.group_size
    n = cfg.n_layers if gs == 1 else cfg.n_groups

    def slot(idx):
        return {k: torch.zeros((n,) + shape, dtype=dt, device=device)
                for k, (shape, dt) in layer_cache_spec(
                    cfg, idx, batch, max_len, dtype, kv_int8=kv_int8).items()}

    return {"layers": slot(0) if gs == 1 else tuple(slot(s)
                                                    for s in range(gs))}


# --------------------------------------------------------------------------- #
# the stack
# --------------------------------------------------------------------------- #
def stack_forward(params: Params, h: torch.Tensor, cfg: ModelConfig, *,
                  remat: bool = True, collect_cache: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Run all layers.  Returns (h, the cache in the params' layout or
    None, the aux loss summed over the MoE layers: f32, zero without
    experts)."""
    # nothing to recompute when no graph is being recorded
    remat = remat and torch.is_grad_enabled() and not collect_cache
    gs = cfg.group_size
    slots = [CacheStack(cfg.n_layers if gs == 1 else cfg.n_groups)
             for _ in range(gs)]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, layer_p in enumerate(_per_layer(params["layers"], cfg)):
        if remat:
            out = checkpoint(_layer_h, layer_p, h, cfg, i,
                             use_reentrant=False)
            h, a = out if isinstance(out, tuple) else (out, None)
        else:
            h, c, a = layer_forward(layer_p, h, cfg, i)
            if collect_cache:
                slots[i % gs].put(i // gs, c)
        if a is not None:
            aux = aux + a
    cache = None
    if collect_cache:
        slots = [slot.stacked() for slot in slots]
        cache = {"layers": slots[0] if gs == 1 else tuple(slots)}
    return h, cache, aux


class CacheStack:
    """One slot's cache leaves stacked ``[n, ...]`` as its layers yield
    them, into one buffer per leaf made at the first layer (no stack
    copy).  A sharded layer's leaf (a DTensor) goes in as this rank's
    block of the cache's layout (``sharding.to_cache_layout``: one
    all-to-all or a local slice a leaf), so the stacked leaf is a DTensor
    laid out as ``cache_shardings`` lays it out, and no rank holds more of
    the cache than its block.  The dry-run counts this under
    ``op_analysis.scope("cache")``."""

    def __init__(self, n: int):
        self.n = n
        self.bufs: Dict[str, torch.Tensor] = {}
        self.like: Dict[str, torch.Tensor] = {}

    def put(self, i: int, cache: Dict[str, torch.Tensor]) -> None:
        from ..launch.op_analysis import scope
        with scope("cache"):
            for k, t in cache.items():
                if is_dtensor(t):
                    t = to_cache_layout(t, k)
                    self.like[k] = t
                    t = t.to_local()
                if k not in self.bufs:
                    self.bufs[k] = t.new_empty((self.n,) + tuple(t.shape))
                self.bufs[k][i] = t

    def stacked(self) -> Dict[str, torch.Tensor]:
        from torch.distributed.tensor import DTensor, Shard
        out = dict(self.bufs)
        for k, t in self.like.items():
            out[k] = DTensor.from_local(
                out[k], t.device_mesh,
                [Shard(p.dim + 1) if isinstance(p, Shard) else p
                 for p in t.placements], run_check=False)
        return out


def stack_decode(params: Params, h: torch.Tensor, cache: Params, pos: int,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    for i, (layer_p, layer_c) in enumerate(zip(
            _per_layer(params["layers"], cfg),
            _per_layer(cache["layers"], cfg))):
        h, _ = layer_decode(layer_p, h, layer_c, pos, cfg, i)
    return h, cache


# --------------------------------------------------------------------------- #
# model-level entry points
# --------------------------------------------------------------------------- #
def embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings, after the stubbed patch embeddings
    (``batch["frontend_embeds"]``) for a vision config that is given
    them."""
    h = embed_tokens(params["embeds"], batch["tokens"])
    if cfg.frontend == "vision" and "frontend_embeds" in batch:
        h = torch.cat([batch["frontend_embeds"].to(h.dtype), h], dim=1)
    return h


def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, remat: bool = True,
            collect_cache: bool = False
            ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (the final-normed h, the cache or None, the aux loss)."""
    if cfg.encoder is not None:
        from . import encdec
        return encdec.encdec_forward(params, batch, cfg, remat=remat,
                                     collect_cache=collect_cache)
    h = constrain(embed_inputs(params, batch, cfg), "residual")
    h, cache, aux = stack_forward(params, h, cfg, remat=remat,
                                  collect_cache=collect_cache)
    return apply_norm(cfg.norm, params["final_norm"], h), cache, aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss + AUX_LOSS_COEF * aux, {"loss", "aux_loss"}); the loss is over
    the text positions (after a vision prefix)."""
    h, _, aux = forward(params, batch, cfg, remat=remat)
    if cfg.frontend == "vision" and "frontend_embeds" in batch:
        h = h[:, batch["frontend_embeds"].shape[1]:]
    loss = chunked_loss(h, params["embeds"], batch["labels"], cfg.vocab_size)
    return loss + AUX_LOSS_COEF * aux, {"loss": loss, "aux_loss": aux}


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward that also returns the decode cache.  Returns
    (last-position logits [B, V_pad], cache).  Inference only: no graph is
    recorded."""
    with torch.no_grad():
        h, cache, _ = forward(params, batch, cfg, remat=False,
                              collect_cache=True)
        return constrain(unembed(params["embeds"], whole_rows(h)[:, -1]),
                         "logits"), cache


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                pos, cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: [B, 1] int; pos: the position (an int or a
    0-d tensor).  Returns (logits [B, V_pad], cache), the cache written in
    place."""
    pos = int(pos)
    with torch.no_grad():
        if cfg.encoder is not None:
            from . import encdec
            return encdec.encdec_decode_step(params, cache, tokens, pos, cfg)
        h = embed_tokens(params["embeds"], tokens)
        h, cache = stack_decode(params, h, cache, pos, cfg)
        h = apply_norm(cfg.norm, params["final_norm"], h)
        return constrain(unembed(params["embeds"], h[:, -1]), "logits"), \
            cache
