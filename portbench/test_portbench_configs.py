"""The configuration files against their published sources, and the port's
``ModelConfig`` built from them against the files (CPU).

    python -m pytest -q portbench/test_portbench_configs.py
"""

import json
import math
import re

import pytest

from portbench import spec

CONFIGS = {c["name"]: c for c in spec.benchmark()["configs"]}
SOURCES = {"deepseek_v2_layer": "DeepSeek-V2.json",
           "granite_moe_1b": "granite-3.0-1b-a400m-base.json"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection)_size$"
                   r"|_dim$|_rank$|head_size|expan|^num_experts_per_tok$"
                   r"|^num_attention_heads$|^num_key_value_heads$"
                   r"|^n_routed_experts$|^num_local_experts$"
                   r"|^n_shared_experts$|^vocab_size$"
                   r"|(^|_)top_?k(_group)?$")


def _file(name):
    return json.loads((spec.ROOT / CONFIGS[name]["file"]).read_text())


def _source(name):
    return json.loads((spec.BENCH / "configs" / "sources"
                       / SOURCES[name]).read_text())


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_file_holds_every_source_key(name):
    src, f = _source(name)["config"], _file(name)
    missing = [k for k in src if k not in f]
    assert not missing, missing


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_every_difference_is_listed(name):
    src, f = _source(name)["config"], _file(name)
    differs = sorted(k for k in src if f[k] != src[k])
    listed = CONFIGS[name]["reduced"]
    assert set(differs) <= set(listed), set(differs) - set(listed)
    # the file's own list and its departures say the same
    assert f["reduced"] == listed
    assert sorted(f["departures"]) == sorted(listed)
    for k in differs:
        assert f["departures"][k]["run"] == f[k]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_no_width_changes(name):
    src, f = _source(name)["config"], _file(name)
    for k, v in src.items():
        if isinstance(v, dict):
            # nested groups are kept whole, as published
            assert f[k] == v, k
        if WIDTH.search(k):
            assert f[k] == v, k
            assert k not in CONFIGS[name]["reduced"], k


def test_deepseek_lists_the_issue_keys():
    need = {"num_hidden_layers", "first_k_dense_replace", "topk_method",
            "norm_topk_prob", "routed_scaling_factor", "seq_aux",
            "rope_scaling"}
    assert need <= set(CONFIGS["deepseek_v2_layer"]["reduced"])
    src = _source("deepseek_v2_layer")
    # greedy routing leaves the expert groups unused, so they stay as
    # published (a per-token count of groups is held as a width)
    f = _file("deepseek_v2_layer")
    assert f["topk_method"] == "greedy"
    for k in ("n_group", "topk_group"):
        assert f[k] == src["config"][k], k
    assert src["source_url"] == CONFIGS["deepseek_v2_layer"]["source"]


def test_deepseek_layer_parameter_count():
    s = spec.sizes(_file("deepseek_v2_layer"))
    assert spec.param_count(s) == 5_020_695_552


def _program_cfg(name, cut=False):
    from portbench import program
    s = spec.sizes(_file(name))
    if cut:
        s = spec.reduced_sizes(s)
    return program.model_config(s, name), s


@pytest.mark.parametrize("name,arch", [("deepseek_v2_layer",
                                        "deepseek-v2-236b"),
                                       ("granite_moe_1b",
                                        "granite-moe-1b-a400m")])
def test_model_config_matches_the_file(name, arch):
    import dataclasses
    from repro_torch.configs import get_config
    cfg, _ = _program_cfg(name)
    f = _file(name)
    assert cfg.n_layers == f["num_hidden_layers"]
    assert cfg.d_model == f["hidden_size"]
    assert cfg.n_heads == f["num_attention_heads"]
    assert cfg.n_kv_heads == f["num_key_value_heads"]
    assert cfg.vocab_size == f["vocab_size"]
    assert cfg.tie_embeddings == f["tie_word_embeddings"]
    assert cfg.rope_theta == f["rope_theta"]
    assert cfg.moe.top_k == f["num_experts_per_tok"]
    assert cfg.moe.capacity_factor == f["assumed"]["capacity_factor"]
    if f["model_type"] == "deepseek_v2":
        assert cfg.moe.n_experts == f["n_routed_experts"]
        assert cfg.moe.n_shared == f["n_shared_experts"]
        assert cfg.moe.d_expert == f["moe_intermediate_size"]
        for k in ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
                  "qk_rope_head_dim", "v_head_dim"):
            assert getattr(cfg.mla, k) == f[k]
    else:
        assert cfg.moe.n_experts == f["num_local_experts"]
        assert cfg.moe.d_expert == f["intermediate_size"]
        assert cfg.head_dim == f["hidden_size"] // f["num_attention_heads"]
        assert math.isclose(f["attention_multiplier"],
                            cfg.head_dim ** -0.5)
    # and it is the port's registered architecture at the file's depth
    reg = get_config(arch)
    assert dataclasses.replace(reg, name=name, source="",
                               n_layers=cfg.n_layers) == \
        dataclasses.replace(cfg, source="")


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_cut_is_the_programs_reduced(name):
    import dataclasses
    cfg, _ = _program_cfg(name)
    cut, _ = _program_cfg(name, cut=True)
    assert dataclasses.replace(cfg.reduced(), name=name) == cut


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_program_param_tree_is_the_benchmarks(name):
    from portbench import program
    cfg, s = _program_cfg(name)
    program.check_program(cfg, s)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_file_refuses_what_the_program_cannot_run(name):
    f = _file(name)
    bad = dict(f, topk_method="group_limited_greedy") \
        if f["model_type"] == "deepseek_v2" else dict(f, logits_scaling=6.0)
    with pytest.raises(ValueError):
        spec.sizes(bad)
