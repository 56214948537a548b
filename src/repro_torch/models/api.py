"""Public model API: ``build_model(cfg)`` returns a ``Model`` bundle of
functions over the reference's param tree (``repro/models/api.py``);
``params_specs``, ``input_specs`` and ``cache_specs`` give every input of
an (arch x shape) cell as ``meta`` tensors, the reference's
``ShapeDtypeStruct`` stand-ins leaf for leaf: the dry-run's contract (no
storage, no random draws)."""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeConfig
from ..device import DeviceLike, resolve_device
from ..obs.trace import region
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
    with region("mlfabric.forward"):
        out = loss_fn(tree_unflatten(treedef, live), batch)
    loss = out[0] if has_aux else out
    with region("mlfabric.backward"):
        grads = torch.autograd.grad(loss, live)
    return out, tree_unflatten(treedef, list(grads))


def params_specs(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16
                 ) -> Params:
    """The param tree as ``meta`` tensors: the reference's shapes and
    dtypes leaf for leaf (its ``params_specs``, an ``eval_shape`` of the
    init), with no storage and no random draws, so a 236 B-parameter
    config's leaves can be named and sized on any host."""
    return tf.init_params(None, cfg, dtype=dtype,
                          device=torch.device("meta"))


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16, *,
                kv_int8: bool = False) -> Dict[str, Any]:
    """Abstract inputs of (arch x shape) as ``meta`` tensors: the ``batch``
    of ``loss_fn`` / ``prefill`` (``tokens``, ``labels`` for training,
    ``frontend_embeds`` for a vision or audio frontend), or a decode
    step's ``tokens`` [B, 1], ``pos`` (a 0-d int32) and ``cache`` at
    ``seq_len``."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        st = text_len(cfg, s)
        batch: Dict[str, Any] = {"tokens": _spec((b, st), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _spec((b, st), torch.int32)
        if cfg.frontend == "vision":
            batch["frontend_embeds"] = _spec(
                (b, cfg.n_frontend_tokens, cfg.d_model), dtype)
        if cfg.frontend == "audio":
            batch["frontend_embeds"] = _spec(
                (b, cfg.encoder.n_frames, cfg.d_model), dtype)
        return batch
    return {"tokens": _spec((b, 1), torch.int32),
            "pos": _spec((), torch.int32),
            "cache": cache_specs(cfg, b, s, dtype, kv_int8=kv_int8)}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, *,
                kv_int8: bool = False) -> Params:
    """The decode cache as ``meta`` tensors, in ``init_cache``'s tree (a
    tuple of ``group_size`` slots for a hybrid), with an encoder-decoder's
    ``cross_kv`` pair ([L, B, frames, KVH, Dh] each)."""
    gs, ng = cfg.group_size, cfg.n_groups

    def stacked(idx):
        return {k: _spec((ng, *shp), dt)
                for k, (shp, dt) in tf.layer_cache_spec(
                    cfg, idx, batch, max_len, dtype,
                    kv_int8=kv_int8).items()}

    cache: Params = {"layers": stacked(0) if gs == 1
                     else tuple(stacked(s) for s in range(gs))}
    if cfg.encoder is not None:
        kv = _spec((cfg.n_layers, batch, cfg.encoder.n_frames,
                    cfg.n_kv_heads, cfg.head_dim), dtype)
        cache["cross_kv"] = (kv, kv)
    return cache
