"""The dense decoder stack (``layer_pattern="a"``): the reference's
``repro/models/transformer.py`` for homogeneous attention stacks.

Params are the reference's tree: ``embeds/{embed[, lm_head]}``,
``final_norm/{scale[, bias]}`` and ``layers/{mix,mlp,norm1,norm2}/...``
(rmsnorm or layernorm, tied or untied head) with every layer leaf stacked on a
leading ``[L, ...]`` axis, as ``init_stack`` builds it.  Stacked leaves
matter beyond tidiness: the flat wire pads each *leaf* to a quantization
block, so splitting them per layer would move the block boundaries.  The
forward unbinds each stacked leaf once and loops over the layers in Python
(the reference scans); ``unbind``'s backward stacks the per-layer grads in
one copy.  With ``remat`` (the default, as in the reference) each layer's
forward runs under ``torch.utils.checkpoint``, the counterpart of the
reference's ``jax.checkpoint`` around its scan body: the backward keeps
only each layer's input and recomputes the layer's internals (at seq 4096
the blockwise-attention scores alone are gigabytes per layer).

Serving: ``prefill`` runs the forward once and returns the last position's
logits and the cache ``{"layers": {k, v}}`` stacked ``[L, B, S, KVH, D]``;
``init_cache`` makes a zero cache of ``max_len`` positions (bf16-typed
``{k, v}`` or, with ``kv_int8``, ``{k_q, v_q, k_s, v_s}``), and
``decode_step`` runs one token per sequence against it.  The reference
returns a new cache from each step and donates the old one to ``jit``;
here the step writes its position into the cache tensors in place and
returns the same tensors, which is what keeps a ``decode_32k`` cache
(51.5 GB in bf16 for Qwen2-0.5B at batch 128) to one copy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import (Params, apply_mlp, apply_norm, chunked_loss, dense_init,
                     embed_tokens, init_embeddings, init_norm, unembed)


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.layer_pattern != "a" or cfg.moe is not None
            or cfg.norm not in ("rmsnorm", "layernorm") or cfg.act != "silu"
            or cfg.mlp_bias or cfg.encoder is not None
            or cfg.frontend != "none"):
        raise NotImplementedError(
            f"{cfg.name}: the port carries dense attention decoders with "
            "rmsnorm or layernorm and a gated SiLU MLP so far")


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                dtype: torch.dtype, device: torch.device) -> Params:
    _check_supported(cfg)
    n, d = cfg.n_layers, cfg.d_model
    kw = dict(dtype=dtype, device=device)
    return {
        "embeds": init_embeddings(gen, cfg.padded_vocab, d,
                                  tie=cfg.tie_embeddings, **kw),
        "final_norm": init_norm(cfg.norm, (d,), **kw),
        "layers": {
            "mix": attn.init_gqa(gen, cfg, n, **kw),
            "mlp": {"up": dense_init(gen, (n, d, cfg.d_ff), **kw),
                    "down": dense_init(gen, (n, cfg.d_ff, d), **kw),
                    "gate": dense_init(gen, (n, d, cfg.d_ff), **kw)},
            "norm1": init_norm(cfg.norm, (n, d), **kw),
            "norm2": init_norm(cfg.norm, (n, d), **kw),
        },
    }


def layer_forward(p: Params, h: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence layer.  Returns (h, cache contribution {k, v})."""
    mix_out, kv = attn.gqa_forward(p["mix"], apply_norm(cfg.norm, p["norm1"],
                                                        h), cfg)
    h = h + mix_out
    return h + apply_mlp(p["mlp"], apply_norm(cfg.norm, p["norm2"], h)), kv


def _layer_h(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``layer_forward``'s h alone: what a rematerialized layer returns, so
    the checkpoint keeps no cache contribution as an output."""
    return layer_forward(p, h, cfg)[0]


def layer_decode(p: Params, h: torch.Tensor, cache: Params, pos: int,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One-token layer step against the layer's cache (written in place)."""
    hn = apply_norm(cfg.norm, p["norm1"], h)
    if "k_q" in cache:
        mix_out, cache_new = attn.gqa_decode_q8(p["mix"], hn, cache, pos, cfg)
    else:
        mix_out, cache_new = attn.gqa_decode(p["mix"], hn, cache, pos, cfg)
    h = h + mix_out
    return h + apply_mlp(p["mlp"], apply_norm(cfg.norm, p["norm2"], h)), \
        cache_new


def _unbind_layers(tree, n: int):
    """Stacked layer tree -> list of ``n`` per-layer trees (views)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


# --------------------------------------------------------------------------- #
# cache init
# --------------------------------------------------------------------------- #
def layer_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16, *,
                     kv_int8: bool = False
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    shp = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if kv_int8:
        sshp = (batch, max_len, cfg.n_kv_heads)
        return {"k_q": (shp, torch.int8), "v_q": (shp, torch.int8),
                "k_s": (sshp, torch.float32), "v_s": (sshp, torch.float32)}
    return {"k": (shp, dtype), "v": (shp, dtype)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, kv_int8: bool = False,
               device: Union[str, torch.device] = "cpu") -> Params:
    """Zero cache, every leaf stacked ``[L, ...]`` as the reference's."""
    _check_supported(cfg)
    return {"layers": {
        k: torch.zeros((cfg.n_layers,) + shape, dtype=dt, device=device)
        for k, (shape, dt) in layer_cache_spec(
            cfg, batch, max_len, dtype, kv_int8=kv_int8).items()}}


# --------------------------------------------------------------------------- #
# the stack
# --------------------------------------------------------------------------- #
def stack_forward(params: Params, h: torch.Tensor, cfg: ModelConfig, *,
                  remat: bool = True, collect_cache: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run all layers.  Returns (h, the stacked cache {"layers": {k, v}}
    ``[L, B, S, KVH, D]`` or None)."""
    # nothing to recompute when no graph is being recorded
    remat = remat and torch.is_grad_enabled() and not collect_cache
    cache = None
    for i, layer_p in enumerate(_unbind_layers(params["layers"],
                                               cfg.n_layers)):
        if remat:
            h = checkpoint(_layer_h, layer_p, h, cfg, use_reentrant=False)
            continue
        h, kv = layer_forward(layer_p, h, cfg)
        if collect_cache:
            if cache is None:  # one [L, ...] buffer per leaf, no stack copy
                cache = {k: t.new_empty((cfg.n_layers,) + tuple(t.shape))
                         for k, t in kv.items()}
            for k, t in kv.items():
                cache[k][i] = t
    return h, ({"layers": cache} if collect_cache else None)


def stack_decode(params: Params, h: torch.Tensor, cache: Params, pos: int,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    layers = _unbind_layers(params["layers"], cfg.n_layers)
    caches = _unbind_layers(cache["layers"], cfg.n_layers)
    for layer_p, layer_c in zip(layers, caches):
        h, _ = layer_decode(layer_p, h, layer_c, pos, cfg)
    return h, cache


# --------------------------------------------------------------------------- #
# model-level entry points
# --------------------------------------------------------------------------- #
def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, remat: bool = True,
            collect_cache: bool = False
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    h = embed_tokens(params["embeds"], batch["tokens"])
    h, cache = stack_forward(params, h, cfg, remat=remat,
                             collect_cache=collect_cache)
    return apply_norm(cfg.norm, params["final_norm"], h), cache


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h, _ = forward(params, batch, cfg, remat=remat)
    loss = chunked_loss(h, params["embeds"], batch["labels"], cfg.vocab_size)
    # dense stacks have no auxiliary loss; the key keeps the reference's
    # (total, {"loss", "aux_loss"}) contract
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss, {"loss": loss, "aux_loss": aux}


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward that also returns the decode cache.  Returns
    (last-position logits [B, V_pad], cache).  Inference only: no graph is
    recorded."""
    with torch.no_grad():
        h, cache = forward(params, batch, cfg, remat=False,
                           collect_cache=True)
        return unembed(params["embeds"], h[:, -1]), cache


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                pos, cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: [B, 1] int; pos: the position (an int or a
    0-d tensor).  Returns (logits [B, V_pad], cache), the cache written in
    place."""
    pos = int(pos)
    with torch.no_grad():
        h = embed_tokens(params["embeds"], tokens)
        h, cache = stack_decode(params, h, cache, pos, cfg)
        h = apply_norm(cfg.norm, params["final_norm"], h)
        return unembed(params["embeds"], h[:, -1]), cache
