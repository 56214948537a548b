"""The weights of a cell, made by the benchmark from ``--seed``.

``leaf_specs(sizes)`` lists every parameter as a path in the program's
param tree (``embeds/embed``, ``layers/mix/wq``, ...; layers stacked
``[L, ...]``), its shape, its type and its draw: normal with a standard
deviation (the program's own init rule: 1/sqrt(fan-in) for projections,
0.02 for the embedding, ``wo`` also over sqrt(2 L)), or ones for norm
scales.  ``make_leaf`` draws one leaf on the device from a generator
seeded by the run's seed and the leaf's index, in the type it is trained in
(one ``randn`` call a leaf), so the plain reference can draw any leaf again
after the program's state is gone.  The program's tree and the reference's
flat dict are filled from the same draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

Path_ = Tuple[str, ...]


@dataclass(frozen=True)
class LeafSpec:
    path: Path_
    shape: Tuple[int, ...]
    dtype: torch.dtype
    std: float            # 0.0: a norm scale, all ones


def _attn_specs(s, L) -> List[Tuple[str, Tuple[int, ...], float]]:
    d, h = s["d_model"], s["n_heads"]
    wo_scale = 1.0 / math.sqrt(2 * L)
    if s["kind"] == "mla":
        m = s["mla"]
        qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
        return [("q_down", (L, d, m["q_lora_rank"]), d),
                ("q_up", (L, m["q_lora_rank"], h * qk), m["q_lora_rank"]),
                ("kv_down", (L, d, m["kv_lora_rank"] + m["qk_rope_head_dim"]),
                 d),
                ("k_up", (L, m["kv_lora_rank"], h * m["qk_nope_head_dim"]),
                 m["kv_lora_rank"]),
                ("v_up", (L, m["kv_lora_rank"], h * m["v_head_dim"]),
                 m["kv_lora_rank"]),
                ("wo", (L, h * m["v_head_dim"], d),
                 (h * m["v_head_dim"], wo_scale))]
    hd, kvh = s["head_dim"], s["n_kv_heads"]
    return [("wq", (L, d, h * hd), d), ("wk", (L, d, kvh * hd), d),
            ("wv", (L, d, kvh * hd), d),
            ("wo", (L, h * hd, d), (h * hd, wo_scale))]


def leaf_specs(s) -> List[LeafSpec]:
    """Every leaf of the param tree, in the program's flattening order
    (sorted keys at every level)."""
    L, d, v = s["n_layers"], s["d_model"], s["padded_vocab"]
    bf16, f32 = torch.bfloat16, torch.float32
    out: List[LeafSpec] = []

    def add(path, shape, fan, dtype=bf16):
        scale = 1.0
        if isinstance(fan, tuple):
            fan, scale = fan
        out.append(LeafSpec(tuple(path.split("/")), tuple(shape), dtype,
                            scale / math.sqrt(fan)))

    out.append(LeafSpec(("embeds", "embed"), (v, d), bf16, 0.02))
    if not s["tie"]:
        add("embeds/lm_head", (d, v), d)
    out.append(LeafSpec(("final_norm", "scale"), (d,), bf16, 0.0))
    for name, shape, fan in _attn_specs(s, L):
        add(f"layers/mix/{name}", shape, fan)
    m = s["moe"]
    e, f = m["n_experts"], m["d_expert"]
    add("layers/mlp/router", (L, d, e), d, f32)
    # the program draws every expert weight, w_down too, at 1/sqrt(d)
    add("layers/mlp/w_gate", (L, e, d, f), d)
    add("layers/mlp/w_up", (L, e, d, f), d)
    add("layers/mlp/w_down", (L, e, f, d), d)
    if m["n_shared"]:
        fs = f * m["n_shared"]
        add("layers/mlp/shared/up", (L, d, fs), d)
        add("layers/mlp/shared/down", (L, fs, d), fs)
        add("layers/mlp/shared/gate", (L, d, fs), d)
    out.append(LeafSpec(("layers", "norm1", "scale"), (L, d), bf16, 0.0))
    out.append(LeafSpec(("layers", "norm2", "scale"), (L, d), bf16, 0.0))
    return sorted(out, key=lambda t: t.path)


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63)


def make_leaf(spec: LeafSpec, index: int, seed: int, device,
              dtype: torch.dtype = None) -> torch.Tensor:
    """Leaf ``index`` drawn from the run's seed on ``device``: one draw in
    the leaf's own type (``dtype`` casts the drawn values afterwards)."""
    if spec.std == 0.0:
        t = torch.ones(spec.shape, dtype=spec.dtype, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(
            leaf_seed(seed, index))
        t = torch.randn(spec.shape, generator=gen, dtype=spec.dtype,
                        device=device)
        t.mul_(spec.std)
    return t if dtype is None else t.to(dtype)


def make_flat(s, seed: int, device, dtype: torch.dtype = None
              ) -> Dict[Path_, torch.Tensor]:
    """``{path: leaf}`` of every leaf (``dtype`` casts each, as the plain
    reference takes them in f32)."""
    return {spec.path: make_leaf(spec, i, seed, device, dtype)
            for i, spec in enumerate(leaf_specs(s))}


def nest(flat: Dict[Path_, torch.Tensor]) -> Dict:
    """``{path: leaf}`` as the program's nested dict tree."""
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree
