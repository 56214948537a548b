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

Tolerances: the f32 rule of ``tests/test_torch_steps.py`` (loss and aux
loss rtol 1e-5, params rtol 1e-4 / atol 1e-6); logits and every cache
leaf within atol 1e-5 / rtol 1e-5, as ``tests/test_torch_sharded_steps.py``
holds qwen2-0.5b.  Every output param leaf is a DTensor laid out by
``param_shardings`` (stripped of the batch axes for MLfabric).
"""

import pytest

import _torch_sharded_twin as twin

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
TRAIN = [(a, m, c) for a in ARCHS for m in ("2x2", "1x4")
         for c in ("auto", "mlfabric")]
SERVE = [(a, m, k) for a in ARCHS for m in ("2x2", "1x4")
         for k in ("prefill", "decode")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return twin.run_twins(tmp_path_factory.mktemp("sharded_moe"), {
        "archs": ARCHS, "cuts": {}, "train": TRAIN, "serve": SERVE})


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
