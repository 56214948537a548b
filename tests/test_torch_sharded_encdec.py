"""Whisper-tiny's encoder-decoder on a ``model`` axis, and decode with an
int8 KV cache on a ``model`` axis, reduced, in f32, against the JAX
package's ``build_step`` on the same meshes
(``tests/_torch_sharded_twin.py``).

* whisper-tiny: the auto and the MLfabric step on ``(data=2, model=2)``
  and ``(data=1, model=4)``, where its 2 KV heads do not divide 4 and the
  cross-attention's keys and values replicate their heads, as the
  reference's ``head_policy`` does; the prefill of 4 rows beside 16 stub
  frames (its ``cross_kv`` laid out by ``cache_shardings``, the frames
  over ``model``) and 3 decode steps that read ``cross_kv`` and never
  write it.
* ``kv_int8`` decode (the reference's ``build_decode_step(kv_int8=True)``)
  on qwen2-0.5b and granite-moe-1b-a400m: 3 steps from position 32 on a
  seeded int8 cache whose sequence is split over ``model``, the new
  token quantized whole (the jitted scale) and written by the rank that
  holds its position.

Tolerances: the f32 rule of ``tests/test_torch_steps.py`` for the steps;
logits and every cache leaf within atol 1e-5 / rtol 1e-5 (as
``tests/test_torch_sharded_steps.py`` holds qwen2-0.5b); an int8 payload
within one step of the reference's on fewer than 0.1% of its entries (a
rounding tie of a value the two sides compute in other orders).
"""

import pytest

import _torch_sharded_twin as twin

TRAIN = [("whisper-tiny", m, c) for m in ("2x2", "1x4")
         for c in ("auto", "mlfabric")]
SERVE = [("whisper-tiny", m, k) for m in ("2x2", "1x4")
         for k in ("prefill", "decode")] + [
    (a, m, "decode_q8") for a in ("qwen2-0.5b", "granite-moe-1b-a400m")
    for m in ("2x2", "1x4")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return twin.run_twins(tmp_path_factory.mktemp("sharded_encdec"), {
        "archs": ["whisper-tiny", "qwen2-0.5b", "granite-moe-1b-a400m"],
        "cuts": {}, "train": TRAIN, "serve": SERVE})


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
