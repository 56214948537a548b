"""The recurrent families on a ``model`` axis: jamba-v0.1-52b (the hybrid:
7 mamba layers and one attention layer a group, experts on odd layers)
and rwkv6-1.6b (the RWKV6 time and channel mix), reduced, in f32, against
the JAX package's ``build_step`` on the same meshes
(``tests/_torch_sharded_twin.py``).  Jamba runs one group of 4 layers,
"mamm" with experts on the odd ones (its reduced config has two groups of
"mmmammmm"): every pairing of mixer and MLP once, mamba and attention each
with and without experts, in a tuple of 4 slots, for a quarter of the
reference's compile time.

Cases: the auto and the MLfabric step on ``(data=2, model=2)`` and
``(data=1, model=4)`` (mamba's ``in_x``, ``in_z`` and ``x_proj`` split
over ``model``; rwkv6's token-shift adapter ``ts_down`` split over
``model`` into pieces that hold no whole one of its 5 mixes), the prefill
of 4 rows and 3 decode steps, the recurrent states written in place
under ``cache_shardings``.

Tolerances: the f32 rule of ``tests/test_torch_steps.py`` (loss and aux
loss rtol 1e-5, params rtol 1e-4 / atol 1e-6); logits and every cache
leaf within atol 1e-5 / rtol 1e-5 (``tests/test_torch_sharded_steps.py``'s
rule), rwkv6's within atol 2e-5 (``SERVE_ATOL``: measured, and
``tests/test_torch_families.py``'s rule for it unsharded).  Every
output param leaf is a DTensor laid out by ``param_shardings`` (stripped
of the batch axes for MLfabric).
"""

import pytest

import _torch_sharded_twin as twin

ARCHS = ["jamba-v0.1-52b", "rwkv6-1.6b"]
CUTS = {"jamba-v0.1-52b": {"n_layers": 4, "layer_pattern": "mamm"}}
# serving: rwkv6's WKV state sums the prefill's tokens, and its cache and
# logits read up to 1.98e-5 off the reference's on 0.09% of the entries
# (measured), inside the 2e-5 of tests/test_torch_families.py
SERVE_ATOL = {"jamba-v0.1-52b": 1e-5, "rwkv6-1.6b": 2e-5}
TRAIN = [(a, m, c) for a in ARCHS for m in ("2x2", "1x4")
         for c in ("auto", "mlfabric")]
SERVE = [(a, m, k) for a in ARCHS for m in ("2x2", "1x4")
         for k in ("prefill", "decode")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return twin.run_twins(tmp_path_factory.mktemp("sharded_recurrent"), {
        "archs": ARCHS, "cuts": CUTS, "train": TRAIN, "serve": SERVE})


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
    twin.check_serve(runs, arch, mesh, kind, atol=SERVE_ATOL[arch])
    twin.check_layout(runs[2], f"{arch}/{mesh}/{kind}")
