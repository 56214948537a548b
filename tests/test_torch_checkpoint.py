"""The port's checkpoints and bounded-divergence replica against the JAX
package's.

* Leaf names: the port writes ``jax.tree_util``'s key-path names, letter
  for letter (``layers/mix/wq``, ``.history/...``, ``.step``, ``.mu/...``;
  jamba's tuple of slots as ``layers/3/mix/wq``).
* Files cross both ways: a ``Checkpointer`` directory written by the
  reference restores in the port bit for bit (bf16 via f32, ints as
  ints), and one written by the port restores in the reference; for the
  reduced qwen2-0.5b and the reduced jamba-v0.1-52b (a tuple of 8 slots
  stacked over 2 groups, f32 leaves beside bf16 ones).
* ``Checkpointer``'s publish, ``keep`` garbage collection and
  ``latest_step``; the replica's syncs, step, divergence bound, byte
  counts and ``recover()`` equal to the reference's (pure bookkeeping:
  exact, the divergence to 1e-12 of a double).
* The twin of ``tests/test_system.py::test_end_to_end_train_restart_replicate``
  on the reduced stablelm-1.6b from JAX-initialized params in f32: every
  step's loss within rtol 1e-6 of the reference's (f32 sums in other
  orders; the largest gap over the six steps read 1.5e-7 on the CPU), and
  the port's restarted run bit-equal to its uninterrupted one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import BoundedDivergenceReplica as JReplica
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint.checkpoint import _flatten_with_names as j_names
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.optim import adamw_init as j_adamw_init
from repro.optim import momentum_sgd_init as j_momentum_init
from repro.optim import momentum_sgd_update as j_momentum_update
from repro.optim.sgd import MomentumState as JMomentumState
from repro.optim.sgd import update_norm as j_update_norm
from repro_torch.checkpoint import (BoundedDivergenceReplica, Checkpointer,
                                    load_pytree, save_pytree)
from repro_torch.checkpoint.checkpoint import _flatten_with_names
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.interop import to_numpy, to_torch
from repro_torch.models import build_model
from repro_torch.optim import (AdamWState, MomentumState, adamw_init,
                               momentum_sgd_init, momentum_sgd_update,
                               update_norm)
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


@pytest.fixture(scope="module")
def jparams():
    """[(arch, the reference's params)]: bf16, as the CLI inits them."""
    return [(arch, jax.jit(j_build_model(j_get_config(arch).reduced()).init)(
        jax.random.key(0))) for arch in ("qwen2-0.5b", "jamba-v0.1-52b")]


def _torch_tree(jtree):
    return to_torch(jax.tree.map(np.asarray, jtree), device="cpu")


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("which", ["params", "momentum", "adamw"])
def test_leaf_names_are_the_references(jparams, which):
    for arch, jp in jparams:
        tparams = _torch_tree(jp)
        jtree, ttree = {
            "params": (jp, tparams),
            "momentum": (j_momentum_init(jp), momentum_sgd_init(tparams)),
            "adamw": (j_adamw_init(jp), adamw_init(tparams)),
        }[which]
        jn = [n for n, _ in j_names(jtree)]
        tn = [n for n, _ in _flatten_with_names(ttree)]
        assert tn == jn, arch
        if which == "momentum":
            assert tn[0] == ".history/embeds/embed"
        if which == "adamw":
            assert tn[0] == ".step" and tn[1].startswith(".mu/")
        if arch.startswith("jamba"):
            assert any(n.endswith("layers/3/mix/wq") for n in tn)
        for (_, a), (_, b) in zip(_flatten_with_names(ttree),
                                  j_names(jtree)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_tree_walks_like_jax():
    from typing import NamedTuple

    class S(NamedTuple):
        a: object
        b: object

    tree = {"x": S(a=np.zeros(1), b=(np.ones(1), None, [np.ones(2)])),
            "n": None, "e": {}, "t": ()}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    jn = ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
          for path, _ in flat]
    tn = [n for n, _ in _flatten_with_names(tree)]
    assert tn == jn == ["x/.a", "x/.b/0", "x/.b/2/0"]
    leaves, treedef = tree_flatten(tree)
    back = tree_unflatten(treedef, leaves)
    assert isinstance(back["x"], S) and back["n"] is None
    assert back["e"] == {} and back["t"] == () and isinstance(
        back["x"].b[2], list)


def _assert_trees_equal(ttree, jtree):
    tl, jl = tree_leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        np.testing.assert_array_equal(_np(t), _np(j))


def test_jax_checkpoint_restores_in_the_port(jparams, tmp_path):
    for arch, jp in jparams:
        rng = np.random.default_rng(0)
        jopt = JMomentumState(history=jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
            jp))
        jadam = j_adamw_init(jp)._replace(step=jnp.asarray(7, jnp.int32))
        JCheckpointer(str(tmp_path / arch)).save(
            5, {"params": jp, "opt": jopt, "adam": jadam},
            metadata={"data": {"cursor": 5, "seed": 0}})
        tparams = _torch_tree(jp)
        like = {"params": jax.tree.map(torch.zeros_like, tparams),
                "opt": momentum_sgd_init(tparams),
                "adam": adamw_init(tparams)}
        step, state, meta = Checkpointer(str(tmp_path / arch)).restore(like)
        assert step == 5 and meta["data"] == {"cursor": 5, "seed": 0}
        assert isinstance(state["opt"], MomentumState)
        assert isinstance(state["adam"], AdamWState)
        assert state["adam"].step.dtype == torch.int32
        assert type(state["params"]["layers"]) is type(jp["layers"])
        _assert_trees_equal(state["params"], jp)
        _assert_trees_equal(state["opt"], jopt)
        _assert_trees_equal(state["adam"], jadam)


def test_port_checkpoint_restores_in_jax(jparams, tmp_path):
    for arch, jp in jparams:
        tparams = _torch_tree(jp)
        g = torch.Generator().manual_seed(1)
        topt = momentum_sgd_init(tparams)
        for h in tree_leaves(topt):
            h.normal_(generator=g)
        Checkpointer(str(tmp_path / arch)).save(
            9, {"params": tparams, "opt": topt},
            metadata={"data": {"cursor": 9}})
        like = {"params": jax.tree.map(jnp.zeros_like, jp),
                "opt": j_momentum_init(jp)}
        step, state, meta = JCheckpointer(str(tmp_path / arch)).restore(like)
        assert step == 9 and meta["data"]["cursor"] == 9
        assert isinstance(state["opt"], JMomentumState)
        _assert_trees_equal(tparams, state["params"])
        _assert_trees_equal(topt, state["opt"])
        # and the interop path gives the port's own state class back
        back = to_torch(to_numpy(topt), device="cpu")
        assert isinstance(back, MomentumState)
        _assert_trees_equal(back, state["opt"])
        assert isinstance(to_torch(jax.tree.map(np.asarray, state["opt"]),
                                   device="cpu"), MomentumState)


def test_save_load_pytree_single_file(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree)
    assert sorted(os.listdir(tmp_path)) == ["t.npz"]    # no .tmp left
    with np.load(path) as z:
        assert z["b"].dtype == np.float32               # bf16 stored as f32
    back = load_pytree(path, tree)
    assert back["b"].dtype == torch.bfloat16
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"],
                                                             tree["b"])


def test_checkpointer_gc_latest_and_atomic_publish(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"p": {"w": torch.zeros(2)}})
    for s in (1, 2, 3):
        ck.save(s, {"p": {"w": torch.full((2,), float(s))}})
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    # a half-written step (its .tmp directory) is invisible
    os.makedirs(ck._step_dir(4) + ".tmp")
    assert ck.latest_step() == 3
    step, st, meta = ck.restore({"p": {"w": torch.zeros(2)}})
    assert step == 3 and torch.equal(st["p"]["w"], torch.full((2,), 3.0))
    assert meta["step"] == 3
    # re-saving a published step replaces it whole
    ck.save(3, {"p": {"w": torch.full((2,), 7.0)}}, metadata={"x": 1})
    _, st, meta = ck.restore({"p": {"w": torch.zeros(2)}}, step=3)
    assert torch.equal(st["p"]["w"], torch.full((2,), 7.0))
    assert meta["x"] == 1
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_0000000002", "step_0000000003", "step_0000000004.tmp"]
    with open(os.path.join(ck._step_dir(3), "meta.json")) as f:
        assert json.load(f)["step"] == 3


def test_replica_bookkeeping_equals_reference():
    rng = np.random.default_rng(2)
    jr = JReplica(div_max=1.5, gamma=0.8)
    tr = BoundedDivergenceReplica(div_max=1.5, gamma=0.8)
    for step in range(25):
        p = {"w": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}
        jp = {"w": jnp.asarray(p["w"], jnp.bfloat16),
              "b": jnp.asarray(p["b"])}
        tp = {"w": torch.from_numpy(p["w"]).bfloat16(),
              "b": torch.from_numpy(p["b"])}
        norm = float(rng.uniform(0.0, 0.9))
        opp = step == 11
        assert tr.offer(step, tp, norm, opportunistic=opp) == \
            jr.offer(step, jp, norm, opportunistic=opp)
        assert tr.divergence() == pytest.approx(jr.divergence(), abs=1e-12)
    for f in ("syncs", "replica_step", "bytes_replicated", "bytes_offered",
              "h_norm_ub", "pending_norms"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.replication_savings == jr.replication_savings
    assert 0 < tr.syncs < 25
    (trec, ts, tl), (jrec, js_, jl) = tr.recover(), jr.recover()
    assert (ts, tl) == (js_, jl)
    assert trec["w"].dtype == torch.bfloat16 and trec["w"].device.type == "cpu"
    _assert_trees_equal(trec, jrec)
    with pytest.raises(RuntimeError):
        BoundedDivergenceReplica(div_max=1.0).recover()


def test_replica_copy_is_its_own():
    """The replica keeps a copy: later in-place changes of the primary's
    tensors do not reach it."""
    r = BoundedDivergenceReplica(div_max=10.0)
    p = {"w": torch.zeros(3)}
    r.offer(0, p, 0.1)
    p["w"].add_(1.0)
    assert torch.equal(r.recover()[0]["w"], torch.zeros(3))


def test_end_to_end_train_restart_replicate_twin(tmp_path):
    """SPMD-style loop on both packages from the same f32 params and data:
    the losses agree step by step; the port's run checkpoints, crashes,
    restarts and lands on its uninterrupted state; the replica is usable."""
    jcfg = j_get_config("stablelm-1.6b").reduced()
    jmodel = j_build_model(jcfg, dtype=jnp.float32)
    jp = jmodel.init(jax.random.key(0))
    jo = j_momentum_init(jp)

    @jax.jit
    def jstep(params, opt, batch):
        (_, m), g = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(params,
                                                                     batch)
        p2, o2 = j_momentum_update(params, g, opt, lr=0.2, gamma=0.9)
        return p2, o2, m["loss"], j_update_norm(g)

    cfg = get_config("stablelm-1.6b").reduced()
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = _torch_tree(jp)
    opt = momentum_sgd_init(params)

    def step_fn(params, opt, batch):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = model.loss_fn(tree_unflatten(treedef, live), batch)
        g = tree_unflatten(treedef, list(torch.autograd.grad(loss, live)))
        p2, o2 = momentum_sgd_update(params, g, opt, lr=0.2, gamma=0.9)
        return p2, o2, float(loss.detach()), float(update_norm(g))

    def pipe():
        return DataPipeline(SyntheticLM(vocab_size=cfg.vocab_size,
                                        seq_len=32, seed=1), global_batch=4)

    tpipe, jpipe = pipe(), pipe()
    ck = Checkpointer(str(tmp_path))
    replica = BoundedDivergenceReplica(div_max=5.0, gamma=0.9)
    losses, jlosses = [], []
    for step in range(6):
        b = tpipe.next_batch()
        jb = {k: jnp.asarray(v) for k, v in jpipe.next_batch().items()}
        params, opt, loss, gn = step_fn(
            params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        jp, jo, jloss, _ = jstep(jp, jo, jb)
        replica.offer(step, params, gn * 0.2)
        losses.append(loss)
        jlosses.append(float(jloss))
        if step == 3:
            ck.save(step + 1, {"params": params, "opt": opt},
                    metadata={"data": tpipe.state_dict()})
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    assert losses[-1] < losses[0]

    step, state, meta = ck.restore({"params": params, "opt": opt})
    assert step == 4
    pipe2 = pipe()
    pipe2.load_state_dict(meta["data"])
    p2, o2 = state["params"], state["opt"]
    for _ in range(step, 6):
        b = {k: torch.from_numpy(v) for k, v in pipe2.next_batch().items()}
        p2, o2, loss2, _ = step_fn(p2, o2, b)
    assert loss2 == losses[-1]
    for a, b in zip(tree_leaves((p2, o2)), tree_leaves((params, opt))):
        assert torch.equal(a, b)
    rec, rec_step, lost = replica.recover()
    assert rec_step >= 0 and lost >= 0
    assert rec_step + lost == 5
