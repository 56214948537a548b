"""Public model API: ``build_model(cfg)`` returns a ``Model`` bundle of
functions over the reference's param tree (``repro/models/api.py``)."""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..tree import tree_flatten, tree_unflatten
from . import transformer as tf
from .layers import Params


@dataclass(frozen=True)
class Model:
    config: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Params]
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    prefill: Callable[..., Tuple[torch.Tensor, Params]]
    decode_step: Callable[..., Tuple[torch.Tensor, Params]]
    init_cache: Callable[..., Params]


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> Model:
    """``device`` defaults to the card and raises where there is none.
    ``init(generator)`` draws on the generator's device and places the
    params on ``device``; ``init_cache(batch, max_len, kv_int8=False)``
    makes a zero cache of the model's dtype on ``device``."""
    dev = resolve_device(device)
    return Model(
        config=cfg,
        device=dev,
        init=functools.partial(tf.init_params, cfg=cfg, dtype=dtype,
                               device=dev),
        loss_fn=functools.partial(tf.loss_fn, cfg=cfg),
        prefill=functools.partial(tf.prefill, cfg=cfg),
        decode_step=functools.partial(tf.decode_step, cfg=cfg),
        init_cache=functools.partial(tf.init_cache, cfg, dtype=dtype,
                                     device=dev),
    )


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens in a sequence of ``seq_len`` positions: a vision config
    gives ``n_frontend_tokens`` of them to the stubbed patch embeddings."""
    if cfg.frontend == "vision":
        return seq_len - cfg.n_frontend_tokens
    return seq_len


def value_and_grad(loss_fn: Callable, params: Params, batch, *,
                   has_aux: bool = False) -> Tuple[object, Params]:
    """``(loss_fn(params, batch), d loss / d params)``: the loss (or, with
    ``has_aux``, ``(loss, aux)``) and the gradient tree, by autograd on
    detached copies of the leaves (``jax.value_and_grad``'s contract; the
    params are left as they are)."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    out = loss_fn(tree_unflatten(treedef, live), batch)
    loss = out[0] if has_aux else out
    return out, tree_unflatten(treedef, list(torch.autograd.grad(loss,
                                                                 live)))
