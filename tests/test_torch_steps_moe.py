"""The data-axis "auto" step of a sparse-expert config against the JAX
package's ``build_step``: granite-moe-1b-a400m reduced, in f32, on a world
of four gloo ranks ``(data=4)`` against the reference on 4 forced CPU
devices ``(data=4, model=1)`` (``tests/_torch_sharded_twin.py``).

The load-balance loss ``E * sum(mean prob * top-1 share)`` is a product of
two batch means.  The reference takes it over the global batch under
``jit``; the port's step takes each rank's gradients on its own rows and
averages them, so it takes the two means over the global batch inside the
model (``models.moe.global_batch_stats``).  With ``microbatches=2``
microbatch i is global rows ``[i B/2, (i+1) B/2)``, as the reference cuts
it, of which each rank takes its share.  At f061be1 the port took the aux
loss per rank (and the microbatches from each rank's rows): there the two
auto twins, ``test_ranks_agree`` and ``test_mlfabric_stays_rank_local``
fail (the ranks' aux losses differed from the reference's by up to 0.29).

The MLfabric step stays rank-local, as the reference's does (its
``shard_map`` takes each rank's loss on its own rows): it matches the
reference's and differs from the auto step.  qwen2-0.5b, which has no
aux loss, runs the auto step beside it.

Tolerances: ``tests/test_torch_steps.py``'s f32 rule: loss and aux loss
within rtol 1e-5 on every rank, params within rtol 1e-4 / atol 1e-6.
"""

import numpy as np
import pytest

import _torch_sharded_twin as twin

TRAIN = [("granite-moe-1b-a400m", "4", c)
         for c in ("auto", "auto_mb2", "mlfabric")] + [
    ("qwen2-0.5b", "4", "auto")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return twin.run_twins(tmp_path_factory.mktemp("steps_moe"), {
        "archs": ["granite-moe-1b-a400m", "qwen2-0.5b"], "cuts": {},
        "train": TRAIN, "serve": []})


def test_ranks_agree(runs):
    twin.check_ranks_agree(runs[1])


@pytest.mark.parametrize("arch,mesh,case", TRAIN)
def test_step_matches_jax(runs, arch, mesh, case):
    twin.check_step(runs, arch, mesh, case)


def test_mlfabric_stays_rank_local(runs):
    """The MLfabric step's aux loss is each rank's own (they differ), and
    its params differ from the auto step's by more than the f32 rule, in
    the port as in the reference."""
    _, port, _, jres = runs
    key = "granite-moe-1b-a400m/4"
    aux = [float(p[f"{key}/mlfabric/aux_loss"]) for p in port]
    assert len(set(aux)) > 1, aux
    for res in (port[0], jres):
        gap = max(float(np.abs(res[f"{key}/mlfabric/{i}"]
                               - res[f"{key}/auto/{i}"]).max())
                  for i in range(len(runs[0]["granite-moe-1b-a400m"])))
        assert gap > 1e-5, gap
