"""The sparse-expert families on a ``model`` axis: granite-moe-1b-a400m
(experts on every layer) and deepseek-v2-236b (latent attention, routed
and shared experts), reduced, in f32, against the JAX package's
``build_step`` on the same meshes (``tests/_torch_sharded_twin.py``).

Cases: the auto and the MLfabric step on ``(data=2, model=2)`` and
``(data=1, model=4)`` (the experts split over ``model``; on ``(2,2)`` the
MLfabric step's backward runs its expert products on the model submesh),
the prefill of 4 rows and 3 decode steps on a cache whose sequence is
split over ``model`` (deepseek-v2's compressed latent: each rank writes
the positions it holds and attends over them with the split softmax).

The cut ``deepseek-v2-236b:cap`` binds the experts' capacity (factor
``CAP_FACTOR``: 8 slots an expert in a group of 32 tokens with 2 choices
each), so choices are dropped (``test_capacity_drops_choices``); its auto
step on both meshes holds the port's groups whole and its slots claimed
in the reference's order where ``model`` splits the sequence.

Tolerances: the f32 rule of ``tests/test_torch_steps.py`` (loss and aux
loss rtol 1e-5, params rtol 1e-4 / atol 1e-6); logits and every cache
leaf within atol 1e-5 / rtol 1e-5, as ``tests/test_torch_sharded_steps.py``
holds qwen2-0.5b.  Every output param leaf is a DTensor laid out by
``param_shardings`` (stripped of the batch axes for MLfabric).
"""

import pytest

import _torch_sharded_twin as twin
from _torch_cuts import cut_config

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
CAP, CAP_FACTOR = "deepseek-v2-236b:cap", 0.5
TRAIN = [(a, m, c) for a in ARCHS for m in ("2x2", "1x4")
         for c in ("auto", "mlfabric")] + [
    (CAP, m, "auto") for m in ("2x2", "1x4")]
SERVE = [(a, m, k) for a in ARCHS for m in ("2x2", "1x4")
         for k in ("prefill", "decode")]
CUTS = {CAP: {"moe.capacity_factor": CAP_FACTOR}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return twin.run_twins(tmp_path_factory.mktemp("sharded_moe"), {
        "archs": ARCHS + [CAP], "cuts": CUTS, "train": TRAIN,
        "serve": SERVE})


def test_ranks_agree(runs):
    twin.check_ranks_agree(runs[1])


@pytest.mark.parametrize("arch,mesh,case", TRAIN)
def test_step_matches_jax(runs, arch, mesh, case):
    twin.check_step(runs, arch, mesh, case)


@pytest.mark.parametrize("arch,mesh,case", TRAIN)
def test_step_layout(runs, arch, mesh, case):
    twin.check_layout(runs[2], f"{arch}/{mesh}/{case}")


@pytest.mark.parametrize("arch,mesh,kind", SERVE)
def test_serve_matches_jax(runs, arch, mesh, kind):
    twin.check_serve(runs, arch, mesh, kind)
    twin.check_layout(runs[2], f"{arch}/{mesh}/{kind}")


def test_capacity_drops_choices(runs):
    """The capacity-bound cut's forward, on the plain port with the twins'
    params and batch, keeps fewer expert choices than its tokens make: a
    group whose tokens a rank split, or whose slots it claimed in another
    order, would drop others."""
    import torch

    from repro.data import SyntheticLM
    from repro_torch.configs import get_config
    from repro_torch.interop import to_torch
    from repro_torch.models import build_model, moe
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg = cut_config(get_config(CAP.split(":")[0]).reduced(), CUTS[CAP])
    _, treedef = tree_flatten(build_model(cfg, dtype=torch.float32,
                                          device="cpu").init(
        torch.Generator().manual_seed(0)))
    params = to_torch(tree_unflatten(treedef, runs[0][CAP]), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg.vocab_size, twin.SEQ, seed=0).batch(0, twin.BATCH).items()}
    kept, made = [], []
    plain = moe._dispatch_chunk

    def counted(x, probs, m, cap, experts=None):
        dispatch, combine = plain(x, probs, m, cap, experts)
        kept.append(int(dispatch.sum()))
        made.append(probs.shape[0] * probs.shape[1] * m.top_k)
        return dispatch, combine

    moe._dispatch_chunk = counted
    try:
        with torch.no_grad():
            tf.forward(params, batch, cfg)
    finally:
        moe._dispatch_chunk = plain
    assert made and all(k < n for k, n in zip(kept, made)), (kept, made)
