"""Public model API: ``build_model(cfg)`` returns a ``Model`` bundle of
functions over the reference's param tree (``repro/models/api.py``)."""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from . import transformer as tf
from .layers import Params


@dataclass(frozen=True)
class Model:
    config: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Params]
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> Model:
    """``device`` defaults to the card and raises where there is none.
    ``init(generator)`` draws on the generator's device and places the
    params on ``device``."""
    dev = resolve_device(device)
    return Model(
        config=cfg,
        device=dev,
        init=functools.partial(tf.init_params, cfg=cfg, dtype=dtype,
                               device=dev),
        loss_fn=functools.partial(tf.loss_fn, cfg=cfg),
    )

