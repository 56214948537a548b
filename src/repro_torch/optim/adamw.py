"""AdamW — the production optimizer of the reference's SPMD training path
(``repro/optim/adamw.py``).  Functional, like the reference: the inputs are
left as they are and new tensors come back.  The moments are f32; the
bias corrections are f32 powers ``b ** step``, as the reference computes
them."""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple, Union

import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    mu: Params
    nu: Params


def adamw_init(params: Params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device if tree_leaves(params) else "cpu"
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: AdamWState, *,
                 lr: Union[float, torch.Tensor], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Params, AdamWState]:
    step = state.step + 1                   # on the params' device
    sf = step.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                 device=sf.device)
    c1 = 1.0 - torch.pow(f32(b1), sf)
    c2 = 1.0 - torch.pow(f32(b2), sf)

    p_flat, treedef = tree_flatten(params)
    g_flat, m_flat, v_flat = (tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu))
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(p_flat, g_flat, m_flat, v_flat):
        gf = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * torch.square(gf)
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        pf = p.to(torch.float32)
        pf = pf - lr * (delta + weight_decay * pf)
        new_p.append(pf.to(p.dtype))
        new_m.append(m_new)
        new_v.append(v_new)
    return (tree_unflatten(treedef, new_p),
            AdamWState(step=step, mu=tree_unflatten(treedef, new_m),
                       nu=tree_unflatten(treedef, new_v)))
