"""Donation on a ``model`` axis: the donating call of the sharded steps
(``StepBundle.donating()``) against their functional ``fn`` on a world of
four gloo processes, with DTensor params and history.

On ``make_host_mesh(data=2, model=2)`` and ``make_host_mesh(data=1,
model=4)`` (a pod axis of one beside them), reduced qwen2-0.5b and reduced
deepseek-v2 in f32 take one functional step (so the history carries
something), then the same step through ``fn`` and through the donating
call from the same params, history and batch:

* every param and history leaf's local shard, and every metric, bit-equal
  to ``fn``'s on every rank;
* every param and history leaf still a DTensor laid out as it came in, its
  local shard at the storage it had (``data_ptr``);
* every param leaf that ``fn`` moved, moved.

Cases: the auto step (with 2 microbatches too) and the MLfabric step,
plain and compressed (the int8 wire over the pod axis of one, on leaves
gathered over ``model``).  The harness's constants are
``tests/_torch_sharded_twin.py``'s; the port runs alone, as the values are
held to its own functional step (the twins hold that one to the
reference's).
"""

import json
import os
import textwrap

import pytest

from _torch_sharded_twin import BATCH, LR, N_RANKS, REPO, SEQ

ARCHS = ["qwen2-0.5b", "deepseek-v2-236b"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
CASES = {
    "auto": dict(grad_path="auto"),
    "auto_mb2": dict(grad_path="auto", microbatches=2),
    "mlfabric": dict(grad_path="mlfabric"),
    "compressed": dict(grad_path="mlfabric", compress_inter=True,
                       bucket_bytes=1024),
}

_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import build_step, init_rank, make_host_mesh
    rank, world, _ = init_rank("gloo")
    out, (archs, meshes, cases, (lr, seq, batch)) = sys.argv[4], eval(
        sys.argv[5])
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import sharding as shd
    from repro_torch.interop import to_torch
    from repro_torch.models import build_model
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_leaves, tree_map

    shape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                global_batch=batch)
    made, res = {}, {}

    def local(tree):
        return [t.to_local() for t in tree_leaves(tree)]

    def layout(tree):
        return [(type(t).__name__, tuple(t.placements), tuple(t.shape))
                for t in tree_leaves(tree)]

    for arch in archs:
        cfg = get_config(arch).reduced()
        init = build_model(cfg, dtype=torch.float32, device="cpu").init(
            torch.Generator().manual_seed(0))
        b = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, seq, seed=0).batch(0, batch).items()}
        for m, (data, model) in meshes.items():
            if m not in made:
                made[m] = make_host_mesh(data, model, device="cpu")
            mesh = made[m]
            specs = shd.param_shardings(cfg, mesh, init)
            for case, kw in cases.items():
                sp = specs if kw["grad_path"] == "auto" else tree_map(
                    shd.strip_data, specs)
                bundle = build_step(cfg, shape, mesh, lr=lr, **kw)
                params = to_torch(init, mesh=mesh, specs=sp)
                opt = momentum_sgd_init(params)
                params, opt, _ = bundle.fn(params, opt, b)
                before = [t.clone() for t in local(params)]
                want_p, want_o, want_m = bundle.fn(params, opt, b)
                lay = layout((params, opt))
                ptrs = [t.data_ptr() for t in local((params, opt))]
                got_p, got_o, got_m = bundle.donating()(params, opt, b)
                got, want = local((got_p, got_o)), local((want_p, want_o))
                fn_moved = [not torch.equal(a, w) for a, w in
                            zip(before, local(want_p))]
                res[f"{arch}/{m}/{case}"] = {
                    "leaves": len(got),
                    "unequal": [i for i, (a, w) in enumerate(zip(got, want))
                                if a.dtype != w.dtype
                                or not torch.equal(a, w)],
                    "metrics_unequal": [k for k in want_m if not torch.equal(
                        torch.as_tensor(want_m[k]),
                        torch.as_tensor(got_m[k]))],
                    "dtensors": all(isinstance(t, DTensor) for t in
                                    tree_leaves((got_p, got_o))),
                    "layout_kept": layout((got_p, got_o)) == lay,
                    "storage_kept": [t.data_ptr() for t in got] == ptrs,
                    "fn_moved": sum(fn_moved),
                    "moved_not_donated": [
                        i for i, (mv, a, p0) in enumerate(zip(
                            fn_moved, local(got_p), before))
                        if mv and torch.equal(a, p0)],
                }
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.launch import run_local_world
    tmp = tmp_path_factory.mktemp("donation_sharded")
    plan = (ARCHS, MESHES, CASES, (LR, SEQ, BATCH))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    run_local_world(_SCRIPT, N_RANKS, args=(tmp, repr(plan)), env=env,
                    timeout_s=400)
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(N_RANKS)]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_donating_call_is_bit_equal_on_a_model_axis(world, arch, mesh,
                                                    case):
    key = f"{arch}/{mesh}/{case}"
    for r, res in enumerate(world):
        got = res[key]
        assert got["leaves"] > 0, (r, got)
        assert got["unequal"] == [], (r, got)
        assert got["metrics_unequal"] == [], (r, got)
        assert got["dtensors"] and got["layout_kept"], (r, got)
        assert got["storage_kept"], (r, got)
        assert got["fn_moved"] > 0 and got["moved_not_donated"] == [], \
            (r, got)
