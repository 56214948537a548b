"""Donation in the port: the in-place eq.-2 update and the steps' donating
call (``StepBundle.donating()``, the counterpart of the reference's
``jitted()`` with ``donate_argnums``).

* ``optim.sgd.momentum_sgd_update_`` against ``momentum_sgd_update``: bit
  for bit, on bf16 and f32 leaves, with weight decay, on leaves that do not
  split into whole pieces, and on one that is not contiguous.
* The donating call of the train step (auto, ``microbatches=2``), the
  MLfabric step (plain, ``overlap_chunks=2``, compressed) against ``fn`` on
  the same inputs, bit for bit, on reduced qwen2-0.5b and reduced
  deepseek-v2 in f32 on a one-rank CPU mesh; every donated leaf keeps its
  storage.
* ``donate_argnums`` and ``args`` against the reference's bundle, and the
  donated train step against the reference's ``build_step(...).jitted()``
  on a one-device mesh at the f32 rule of ``tests/test_torch_steps.py``
  (rtol 1e-4, atol 1e-6; loss rtol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist.compat import AxisType, make_mesh as j_make_mesh
from repro.launch.steps import build_step as j_build_step
from repro.models import build_model as j_build_model
from repro.optim.sgd import momentum_sgd_init as j_momentum_sgd_init
from repro_torch.configs import get_config, get_shape
from repro_torch.data import SyntheticLM
from repro_torch.dist.collectives import mlfabric_grad_reduce
from repro_torch.interop import to_torch
from repro_torch.launch import build_step, make_host_mesh
from repro_torch.models import build_model
from repro_torch.optim import (MomentumState, momentum_sgd_init,
                               momentum_sgd_update, momentum_sgd_update_)
from repro_torch.tree import tree_leaves, tree_map

LR, SEQ, BATCH = 0.1, 32, 4
ARCHS = ["qwen2-0.5b", "deepseek-v2-236b"]
CASES = {
    "auto": dict(grad_path="auto"),
    "microbatches2": dict(grad_path="auto", microbatches=2),
    "mlfabric": dict(grad_path="mlfabric"),
    "overlap2": dict(grad_path="mlfabric", overlap_chunks=2),
    "compressed": dict(grad_path="mlfabric", compress_inter=True,
                       bucket_bytes=1024),
}


# --------------------------------------------------------------------------- #
# the in-place update
# --------------------------------------------------------------------------- #
def _tree(gen, dtype, shapes):
    return {f"l{i}": torch.randn(s, generator=gen).to(dtype)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("chunk", [7, 1000, 2 ** 26])
def test_inplace_update_is_bit_equal(dtype, weight_decay, chunk):
    """Pieces of 7 and 1000 split no leaf into whole pieces; 2^26 keeps
    each leaf in one."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(33, 61), (5,), (4, 3, 250)]
    params = _tree(gen, dtype, shapes)
    grads = _tree(gen, torch.bfloat16, shapes)
    state = MomentumState(history=_tree(gen, torch.float32, shapes))
    want_p, want_s = momentum_sgd_update(params, grads, state, lr=0.3,
                                         gamma=0.9, weight_decay=weight_decay)
    ptrs = [t.data_ptr() for t in tree_leaves((params, state))]
    got_p, got_s = momentum_sgd_update_(params, grads, state, lr=0.3,
                                        gamma=0.9, weight_decay=weight_decay,
                                        chunk=chunk)
    assert got_p is params and got_s is state
    assert [t.data_ptr() for t in tree_leaves((params, state))] == ptrs
    for a, b in zip(tree_leaves((want_p, want_s)), tree_leaves((got_p,
                                                                got_s))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_inplace_update_of_a_view_that_is_not_contiguous():
    gen = torch.Generator().manual_seed(1)
    base = torch.randn(16, 12, generator=gen)
    params = {"w": base[:, ::2]}
    grads = {"w": torch.randn(16, 6, generator=gen)}
    state = MomentumState(history={"w": torch.randn(16, 6, generator=gen)})
    want_p, want_s = momentum_sgd_update(params, grads, state, lr=0.1)
    momentum_sgd_update_(params, grads, state, lr=0.1, chunk=5)
    assert torch.equal(base[:, ::2], want_p["w"])
    assert torch.equal(state.history["w"], want_s.history["w"])


def test_reduce_never_aliases_a_lone_f32_leaf():
    """With nothing to reduce over and a mean over one, the bucket is not
    copied; the tree form still hands back a tensor of its own."""
    mesh = make_host_mesh(device="cpu")
    g = torch.arange(300, dtype=torch.float32)
    out = mlfabric_grad_reduce({"w": g}, mesh=mesh, inter_axis=None)
    assert torch.equal(out["w"], g)
    out["w"].add_(1)
    assert torch.equal(g, torch.arange(300, dtype=torch.float32))


# --------------------------------------------------------------------------- #
# the donating call of every training builder
# --------------------------------------------------------------------------- #
def _setup(arch, seed=0):
    cfg = get_config(arch).reduced()
    params = build_model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(seed))
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=SEQ,
                                global_batch=BATCH)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, SEQ, seed=0).batch(0, BATCH).items()}
    return cfg, params, shape, batch


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_donating_call_is_bit_equal(arch, case):
    cfg, params, shape, batch = _setup(arch)
    mesh = make_host_mesh(device="cpu")
    bundle = build_step(cfg, shape, mesh, lr=LR, **CASES[case])
    assert bundle.donate_argnums == (0, 1)
    opt = momentum_sgd_init(params)
    # a first step gives the history something to carry
    params, opt, _ = bundle.fn(params, opt, batch)
    want_p, want_o, want_m = bundle.fn(params, opt, batch)
    keep = tree_map(lambda t: t.clone(), (params, opt))
    ptrs = [t.data_ptr() for t in tree_leaves((params, opt))]
    got_p, got_o, got_m = bundle.donating()(params, opt, batch)
    assert [t.data_ptr() for t in tree_leaves((got_p, got_o))] == ptrs
    for a, b in zip(tree_leaves((want_p, want_o)), tree_leaves((got_p,
                                                                got_o))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k in want_m:
        assert torch.equal(want_m[k], got_m[k]), k
    # the step moved every leaf it donated
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(keep[0]),
                                                   tree_leaves(got_p))]
    assert sum(moved) >= len(moved) - 1, moved   # an unused leaf may stay


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k"])
def test_serving_bundles_donate_as_the_reference(kind):
    cfg = get_config("qwen2-0.5b").reduced()
    bundle = build_step(cfg, get_shape(kind), make_host_mesh(device="cpu"))
    assert bundle.donate_argnums == ((1,) if kind == "decode_32k" else ())
    assert bundle.donating() is bundle.fn


# --------------------------------------------------------------------------- #
# against the reference's bundle
# --------------------------------------------------------------------------- #
def _j_mesh():
    return j_make_mesh((1, 1), ("data", "model"),
                       axis_types=(AxisType.Auto,) * 2)


def _spec_leaves(tree):
    return [(tuple(l.shape), np.dtype(l.dtype).name)
            for l in jax.tree_util.tree_leaves(tree)]


def _port_spec_leaves(tree):
    return [(tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for l in tree_leaves(tree)]


@pytest.mark.parametrize("kind,kw", [
    ("train_4k", {}), ("train_4k", {"grad_path": "mlfabric"}),
    ("prefill_32k", {}), ("decode_32k", {}),
    ("decode_32k", {"kv_int8": True})])
@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_matches_the_reference(arch, kind, kw):
    """``donate_argnums`` and every abstract arg, leaf for leaf."""
    ref = j_build_step(j_get_config(arch).reduced(), j_get_shape(kind),
                       _j_mesh(), **kw)
    port = build_step(get_config(arch).reduced(), get_shape(kind),
                      make_host_mesh(device="cpu"), **kw)
    assert port.donate_argnums == ref.donate_argnums
    assert len(port.args) == len(ref.args)
    for a, b in zip(ref.args, port.args):
        assert _spec_leaves(a) == _port_spec_leaves(b)
    assert all(l.device.type == "meta" for l in tree_leaves(port.args)
               if isinstance(l, torch.Tensor))


def test_donated_step_matches_the_reference_jitted():
    jcfg = j_get_config("qwen2-0.5b").reduced()
    jparams = j_build_model(jcfg, dtype=jnp.float32).init(jax.random.key(0))
    shape = dataclasses.replace(j_get_shape("train_4k"), seq_len=SEQ,
                                global_batch=BATCH)
    jb = {k: jnp.asarray(v) for k, v in
          JSyntheticLM(jcfg.vocab_size, SEQ, seed=0).batch(0, BATCH).items()}
    # the port's copies first: the reference's call donates its inputs
    params = to_torch(jax.tree_util.tree_map(np.array, jparams),
                      device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    jp, jo, jm = j_build_step(jcfg, shape, _j_mesh(), lr=LR).jitted()(
        jparams, j_momentum_sgd_init(jparams), jb)
    cfg = get_config("qwen2-0.5b").reduced()
    pshape = dataclasses.replace(get_shape("train_4k"), seq_len=SEQ,
                                 global_batch=BATCH)
    opt = momentum_sgd_init(params)
    ptrs = [t.data_ptr() for t in tree_leaves((params, opt))]
    p, o, m = build_step(cfg, pshape, make_host_mesh(device="cpu"),
                         lr=LR).donating()(params, opt, batch)
    assert [t.data_ptr() for t in tree_leaves((p, o))] == ptrs
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves((jp, jo)),
                    tree_leaves((p, o))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6)
