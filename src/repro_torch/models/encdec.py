"""Whisper's encoder-decoder backbone (``repro/models/encdec.py``), the
audio frontend stubbed as in the reference.

The encoder takes precomputed frame embeddings ``batch["frontend_embeds"]``
[B, n_frames, d], adds sinusoidal positions in the frames' dtype and runs
pre-norm layers of bidirectional attention and the biased GELU MLP, then
a final norm.  The decoder is the dense stack (``transformer.layer_forward``,
no rope: sinusoidal positions are added to the token embeddings) with one
cross-attention sub-layer per layer after it, against the encoder output's
keys and values (``cross_kv``: k and v, each [L, B, F, KVH, D]).

Params beside the decoder's: ``encoder/{layers/{norm1, attn, norm2, mlp},
final_norm}`` (layers stacked [L_enc, ...]) and ``cross/{norm, attn}``
(stacked [L, ...]), the reference's tree.  A prefill's cache is
``{"layers": the self-attention k and v, "cross_kv": (k, v)}``;
``transformer.init_cache`` gives only ``layers``, and the caller adds a
prefill's ``cross_kv`` before decoding, as the reference's ``serve`` does.
A decode step writes its position of the self cache in place and only
reads ``cross_kv``.

Types: the reference's serving passes bf16 frames to a model of any
dtype.  ``frames + positions`` is then bf16, and in an f32 model the
first projection widens it (``attention._promote``: ``jnp.matmul``
promotes bf16 against f32, ``torch.matmul`` refuses mixed types); the
residual add promotes by itself.  This is JAX's promotion layer by layer;
the reference's own ``lax.scan`` over the encoder refuses such a carry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..dist.policy import constrain
from . import attention as attn
from . import transformer as tf
from .layers import (Params, apply_mlp, apply_norm, dense, embed_tokens,
                     init_mlp, init_norm, is_dtensor, sinusoidal_positions,
                     unembed)

CrossKV = Tuple[torch.Tensor, torch.Tensor]


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def init_encoder(gen: torch.Generator, cfg: ModelConfig, *,
                 dtype: torch.dtype, device: torch.device) -> Params:
    n = cfg.encoder.n_layers
    kw = dict(dtype=dtype, device=device)
    layers = {"norm1": init_norm(cfg.norm, (n, cfg.d_model), **kw),
              "attn": attn.init_gqa(gen, cfg, n, **kw),
              "norm2": init_norm(cfg.norm, (n, cfg.d_model), **kw),
              "mlp": init_mlp(gen, (n,), cfg.d_model, cfg.d_ff, act=cfg.act,
                              bias=cfg.mlp_bias, **kw)}
    return {"layers": layers,
            "final_norm": init_norm(cfg.norm, (cfg.d_model,), **kw)}


def init_cross_layers(gen: torch.Generator, cfg: ModelConfig, *,
                      dtype: torch.dtype, device: torch.device) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {"norm": init_norm(cfg.norm, (cfg.n_layers, cfg.d_model), **kw),
            "attn": attn.init_gqa(gen, cfg, cfg.n_layers, **kw)}


# --------------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------------- #
def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames [B, n_frames, d] (the stub embeddings) -> the encoder
    output."""
    enc = params["encoder"]
    h = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      device=frames.device).to(frames.dtype)
    for p in tf._unbind_layers(enc["layers"], cfg.encoder.n_layers):
        hn = apply_norm(cfg.norm, p["norm1"], h)
        out, _ = attn.gqa_forward(p["attn"], hn, cfg, causal=False)
        h = h + out
        hn = apply_norm(cfg.norm, p["norm2"], h)
        h = h + apply_mlp(p["mlp"], hn, act=cfg.act)
    return apply_norm(cfg.norm, enc["final_norm"], h)


def cross_kv(cross: Params, enc_out: torch.Tensor, cfg: ModelConfig
             ) -> CrossKV:
    """Every decoder layer's cross-attention k and v of the encoder output,
    each [L, B, F, KVH, D]."""
    b, f, _ = enc_out.shape
    p = cross["attn"]
    if is_dtensor(enc_out):
        # a layer at a time: DTensor's broadcast product would flatten
        # the layers into the batch (PyTorch 2.11)
        k = torch.stack([dense(enc_out, w) for w in p["wk"].unbind(0)])
        v = torch.stack([dense(enc_out, w) for w in p["wv"].unbind(0)])
    else:
        k = enc_out[None] @ p["wk"][:, None]
        v = enc_out[None] @ p["wv"][:, None]
    if "bk" in p:
        k = k + p["bk"][:, None, None]
        v = v + p["bv"][:, None, None]
    # heads that do not divide ``model`` are made whole first, as in the
    # self-attention: in training and prefill the cross-attention splits
    # its q heads and its queries over ``model`` (``attention.
    # _attend_split``) and keeps these whole; decode reads them in
    # ``cache_shardings``' layout (the frames over ``model``, every head)
    kvh = k.shape[-1] // cfg.head_dim
    return (attn.split_heads(k, kvh, cfg.head_dim),
            attn.split_heads(v, kvh, cfg.head_dim))


# --------------------------------------------------------------------------- #
# decoder with cross-attention
# --------------------------------------------------------------------------- #
def _decoder_layer(p: Params, cp: Params, k: torch.Tensor, v: torch.Tensor,
                   h: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A self layer, then norm, cross-attention against (k, v) and the
    residual.  Returns (h, the self layer's cache contribution)."""
    h, cache, _ = tf.layer_forward(p, h, cfg, 0)
    hn = apply_norm(cfg.norm, cp["norm"], h)
    out, _ = attn.gqa_forward(cp["attn"], hn, cfg, xattn_kv=(k, v))
    return constrain(h + out, "residual"), cache


def _decoder_layer_h(p, cp, k, v, h, cfg) -> torch.Tensor:
    """``_decoder_layer`` without its cache: what a rematerialized layer
    returns."""
    return _decoder_layer(p, cp, k, v, h, cfg)[0]


def _decoder_stack(params: Params, h: torch.Tensor, kv: CrossKV,
                   cfg: ModelConfig, *, remat: bool = True,
                   collect_cache: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The decoder layers, each rematerialized under autograd with
    ``remat`` as ``transformer.stack_forward`` does it.  Returns (h, the
    self cache stacked [L, ...] or None)."""
    remat = remat and torch.is_grad_enabled() and not collect_cache
    layers = tf._per_layer(params["layers"], cfg)
    cross = tf._unbind_layers(params["cross"], cfg.n_layers)
    stacked = tf.CacheStack(cfg.n_layers)
    for i, (p, cp) in enumerate(zip(layers, cross)):
        if remat:
            h = checkpoint(_decoder_layer_h, p, cp, kv[0][i], kv[1][i], h,
                           cfg, use_reentrant=False)
            continue
        h, c = _decoder_layer(p, cp, kv[0][i], kv[1][i], h, cfg)
        if collect_cache:
            stacked.put(i, c)
    return h, stacked.stacked() if collect_cache else None


def decoder_embed(params: Params, tokens: torch.Tensor, start: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings plus the sinusoidal positions ``start ..``: the
    rows of the prefill's table, bit for bit."""
    h = embed_tokens(params["embeds"], tokens)
    pos = sinusoidal_positions(tokens.shape[1], cfg.d_model, start=start,
                               device=h.device)
    return h + pos.to(h.dtype)


def encdec_forward(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, *, remat: bool = True,
                   collect_cache: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (the final-normed decoder h, the cache ``{"layers",
    "cross_kv"}`` or None, a zero aux loss)."""
    enc_out = encode(params, batch["frontend_embeds"], cfg)
    kv = cross_kv(params["cross"], enc_out, cfg)
    h = constrain(decoder_embed(params, batch["tokens"], 0, cfg), "residual")
    h, layers = _decoder_stack(params, h, kv, cfg, remat=remat,
                               collect_cache=collect_cache)
    h = apply_norm(cfg.norm, params["final_norm"], h)
    cache = {"layers": layers, "cross_kv": kv} if collect_cache else None
    return h, cache, torch.zeros((), dtype=torch.float32, device=h.device)


def encdec_decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                       pos: int, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Params]:
    """One token per sequence at ``pos``: the self cache written in place,
    ``cache["cross_kv"]`` (a prefill's) read.  Returns (logits, cache)."""
    if "cross_kv" not in cache:
        raise KeyError("an encoder-decoder decode step needs the cache's "
                       "'cross_kv' from a prefill")
    ck, cv = cache["cross_kv"]
    h = decoder_embed(params, tokens, pos, cfg)
    layers: List[Params] = tf._per_layer(params["layers"], cfg)
    cross = tf._unbind_layers(params["cross"], cfg.n_layers)
    for i, (p, cp, c) in enumerate(zip(layers, cross,
                                       tf._per_layer(cache["layers"], cfg))):
        h, _ = tf.layer_decode(p, h, c, pos, cfg, i)
        hn = apply_norm(cfg.norm, cp["norm"], h)
        h = h + attn.gqa_cross_decode(cp["attn"], hn, ck[i], cv[i],
                                      ck.shape[2])
    h = apply_norm(cfg.norm, params["final_norm"], h)
    return unembed(params["embeds"], h[:, -1]), cache
