"""The dense decoder stack (``layer_pattern="a"``): the reference's
``repro/models/transformer.py`` for homogeneous attention stacks.

Params are the reference's tree: ``embeds/embed``, ``final_norm/scale`` and
``layers/{mix,mlp,norm1,norm2}/...`` with every layer leaf stacked on a
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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import (Params, apply_mlp, apply_rmsnorm, chunked_loss,
                     dense_init, embed_tokens, normal)


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.layer_pattern != "a" or cfg.moe is not None or cfg.norm != "rmsnorm"
            or cfg.act != "silu" or cfg.mlp_bias or not cfg.tie_embeddings
            or cfg.encoder is not None or cfg.frontend != "none"):
        raise NotImplementedError(
            f"{cfg.name}: the port carries dense attention decoders with "
            "rmsnorm, a gated SiLU MLP and tied embeddings so far")


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                dtype: torch.dtype, device: torch.device) -> Params:
    _check_supported(cfg)
    n, d = cfg.n_layers, cfg.d_model
    kw = dict(dtype=dtype, device=device)
    ones = lambda *shape: torch.ones(shape, **kw)  # noqa: E731
    return {
        "embeds": {"embed": normal(gen, (cfg.padded_vocab, d), 0.02, **kw)},
        "final_norm": {"scale": ones(d)},
        "layers": {
            "mix": attn.init_gqa(gen, cfg, n, **kw),
            "mlp": {"up": dense_init(gen, (n, d, cfg.d_ff), **kw),
                    "down": dense_init(gen, (n, cfg.d_ff, d), **kw),
                    "gate": dense_init(gen, (n, d, cfg.d_ff), **kw)},
            "norm1": {"scale": ones(n, d)},
            "norm2": {"scale": ones(n, d)},
        },
    }


def layer_forward(p: Params, h: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    mix_out, _ = attn.gqa_forward(p["mix"], apply_rmsnorm(p["norm1"], h), cfg)
    h = h + mix_out
    return h + apply_mlp(p["mlp"], apply_rmsnorm(p["norm2"], h))


def _unbind_layers(tree, n: int):
    """Stacked layer tree -> list of ``n`` per-layer trees (views)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


def stack_forward(params: Params, h: torch.Tensor, cfg: ModelConfig, *,
                  remat: bool = True) -> torch.Tensor:
    # nothing to recompute when no graph is being recorded
    remat = remat and torch.is_grad_enabled()
    for layer_p in _unbind_layers(params["layers"], cfg.n_layers):
        if remat:
            h = checkpoint(layer_forward, layer_p, h, cfg,
                           use_reentrant=False)
        else:
            h = layer_forward(layer_p, h, cfg)
    return h


def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, remat: bool = True) -> torch.Tensor:
    h = embed_tokens(params["embeds"], batch["tokens"])
    h = stack_forward(params, h, cfg, remat=remat)
    return apply_rmsnorm(params["final_norm"], h)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = forward(params, batch, cfg, remat=remat)
    loss = chunked_loss(h, params["embeds"], batch["labels"], cfg.vocab_size)
    # dense stacks have no auxiliary loss; the key keeps the reference's
    # (total, {"loss", "aux_loss"}) contract
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss, {"loss": loss, "aux_loss": aux}
