"""What the benchmark is made of, read from its files by name: the cells of
``BENCHMARK.json``, the configuration files under ``portbench/configs/``,
the traffic mixes under ``portbench/traffic/`` and each cell's limits under
``portbench/workloads/``.

``sizes(cfg)`` turns a configuration file (the published ``config.json``
keys, as run) into the plain sizes the benchmark's own code uses: the
weights it makes, the plain reference and the model-FLOP count.  It reads
only the file, never the program, and refuses a value the program cannot
run (a departure that is not written down in the file).

Nothing here imports the program.
"""

from __future__ import annotations

import copy
import json
import math
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"

VOCAB_PAD = 256          # the program pads its tables to a multiple of this
AUX_LOSS_COEF = 0.01     # loss + 0.01 * (the layers' summed balance losses)


def benchmark() -> Dict[str, Any]:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> Dict[str, Any]:
    """The ``workloads`` entry of ``name`` with its configuration entry, its
    traffic parameters and its limits resolved: keys ``name``, ``config``
    (the file's dict), ``config_name``, ``traffic`` (the mix's dict),
    ``traffic_name``, ``chips``, ``limits``."""
    b = benchmark()
    for w in b["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in b["configs"] if c["name"] == w["config"])
    return {"name": name, "config_name": conf["name"],
            "config": json.loads((ROOT / conf["file"]).read_text()),
            "traffic_name": w["traffic"], "traffic": traffic(w["traffic"]),
            "chips": w["chips"], "limits": limits(name)}


def traffic(name: str) -> Dict[str, Any]:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(name: str) -> Dict[str, float]:
    path = BENCH / "workloads" / f"{name}.json"
    return json.loads(path.read_text())["limits"]


def metrics_for(name: str, trace: bool) -> Dict[str, Dict[str, Any]]:
    """The metrics the cell ``name`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer ones with it on (each listed for the cell
    by its ``workloads`` key, or for every cell without one)."""
    b = benchmark()
    key = "per_layer" if trace else "end_to_end"
    return {m["name"]: m for m in b[key]
            if "workloads" not in m or name in m["workloads"]}


# --------------------------------------------------------------------------- #
# configuration files -> sizes
# --------------------------------------------------------------------------- #
def _need(cfg: Dict[str, Any], key: str, want) -> None:
    if cfg.get(key) != want:
        raise ValueError(f"{cfg.get('model_type')}: {key} = {cfg.get(key)!r}; "
                         f"the program runs only {want!r} (list a change in "
                         f"'reduced' and run it as the program does)")


def sizes(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The sizes of a configuration file, as the benchmark's own code uses
    them."""
    mt = cfg["model_type"]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    s: Dict[str, Any] = {
        "n_layers": cfg["num_hidden_layers"], "d_model": d, "n_heads": h,
        "n_kv_heads": cfg["num_key_value_heads"],
        "vocab_size": cfg["vocab_size"],
        "tie": bool(cfg["tie_word_embeddings"]),
        "rope_theta": float(cfg["rope_theta"]),
        "eps": float(cfg["rms_norm_eps"]),
        "aux_coef": float(cfg.get("assumed", {}).get("aux_loss_coef",
                                                     AUX_LOSS_COEF)),
    }
    _need(cfg, "hidden_act", "silu")
    _need(cfg, "attention_bias", False)
    a = cfg.get("assumed", {})
    if mt == "deepseek_v2":
        for k, v in (("first_k_dense_replace", 0), ("moe_layer_freq", 1),
                     ("topk_method", "greedy"), ("norm_topk_prob", True),
                     ("routed_scaling_factor", 1), ("seq_aux", False),
                     ("scoring_func", "softmax"),
                     ("rope_scaling_applied", False)):
            _need(cfg, k, v)
        s["kind"] = "mla"
        s["mla"] = {k: cfg[k] for k in ("q_lora_rank", "kv_lora_rank",
                                        "qk_nope_head_dim",
                                        "qk_rope_head_dim", "v_head_dim")}
        s["head_dim"] = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        s["moe"] = {"n_experts": cfg["n_routed_experts"],
                    "top_k": cfg["num_experts_per_tok"],
                    "d_expert": cfg["moe_intermediate_size"],
                    "n_shared": cfg["n_shared_experts"]}
    elif mt == "granitemoe":
        for k, v in (("embedding_multiplier", 1.0),
                     ("residual_multiplier", 1.0), ("logits_scaling", 1.0),
                     ("attention_dropout", 0.0), ("rope_scaling", None)):
            _need(cfg, k, v)
        s["kind"] = "gqa"
        s["head_dim"] = d // h
        _need(cfg, "attention_multiplier", 1.0 / math.sqrt(s["head_dim"]))
        s["moe"] = {"n_experts": cfg["num_local_experts"],
                    "top_k": cfg["num_experts_per_tok"],
                    "d_expert": cfg["intermediate_size"], "n_shared": 0}
    else:
        raise ValueError(f"no sizes for model_type {mt!r}")
    s["moe"]["capacity_factor"] = float(a.get("capacity_factor", 1.25))
    s["moe"]["group_tokens"] = int(a.get("moe_group_tokens", 256))
    s["padded_vocab"] = -(-s["vocab_size"] // VOCAB_PAD) * VOCAB_PAD
    # the port's dense MLP width, which no layer of these all-MoE stacks
    # uses, and its explicit head size (0: hidden / heads)
    s["d_ff"], s["d_head"] = s["moe"]["d_expert"], 0
    return s


def reduced_sizes(s: Dict[str, Any]) -> Dict[str, Any]:
    """The CPU tests' cut of ``s``: the program's ``ModelConfig.reduced()``
    rule (same layer kinds, tiny widths), written out for the sizes."""
    r = copy.deepcopy(s)
    r.update(n_layers=min(s["n_layers"], 2), d_model=128,
             n_heads=min(s["n_heads"], 4), n_kv_heads=min(s["n_kv_heads"], 2),
             head_dim=32, d_head=32, d_ff=256, vocab_size=512,
             padded_vocab=512)
    r["moe"].update(n_experts=min(s["moe"]["n_experts"], 4),
                    top_k=min(s["moe"]["top_k"], 2), d_expert=64)
    if s["kind"] == "mla":
        r["mla"] = {"q_lora_rank": 48, "kv_lora_rank": 32,
                    "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
                    "v_head_dim": 32}
        r["head_dim"] = 48
    return r


def capacity(group_tokens: int, moe: Dict[str, Any]) -> int:
    return max(1, int(math.ceil(group_tokens * moe["top_k"]
                                / moe["n_experts"] * moe["capacity_factor"])))


def param_count(s: Dict[str, Any]) -> int:
    from .weights import leaf_specs
    return sum(math.prod(spec.shape) for spec in leaf_specs(s))
