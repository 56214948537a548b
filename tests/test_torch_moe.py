"""The port's sparse-expert layer (``repro_torch/models/moe.py``) against
the JAX package's ``repro/models/moe.py``.

The same numpy inputs, and params initialized in JAX and converted through
numpy, go through both.  Tolerances:

* dispatch and combine of ``_dispatch_chunk``: dispatch equal, combine
  within 1e-6 (the same f32 gate renormalization; the slots are the same
  integers), with tokens dropped and with planted router ties (equal
  probabilities take the lower expert first in both);
* ``moe_forward`` in f32: out within atol 2e-5, aux within 1e-6 (f32
  einsums summed in other orders by XLA and by PyTorch's CPU kernels);
  grads within rtol 1e-4 / atol 1e-5 against ``jax.grad``;
* in bf16: out within atol 4e-2 / rtol 4e-2 of the reference's.  The
  combine sums up to top-k expert outputs rounded to bf16, and the order
  of those additions, like the bf16 rounding of each expert's einsum,
  differs between the two frameworks: a few bf16 ulps of values of order
  one.  The routing itself is decided in f32, so the same experts are
  chosen.

The twins of ``tests/test_moe_ssp.py::TestMoE`` keep that class's claims
and tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as jmoe
from repro_torch.configs import MoEConfig, get_config
from repro_torch.interop import to_torch
from repro_torch.models.moe import (_dispatch_chunk, capacity, init_moe,
                                    moe_forward, router_topk)
from repro_torch.tree import tree_flatten, tree_unflatten

ARCH = "granite-moe-1b-a400m"


def _cfg(**moe_kw):
    cfg = get_config(ARCH).reduced()
    jcfg = j_get_config(ARCH).reduced()
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe_kw))
    return cfg, jcfg


def _params(jcfg, dtype, seed=0):
    """JAX-initialized MoE params and their port copy."""
    jp = jmoe.init_moe(jax.random.key(seed), jcfg, dtype=dtype)
    return jp, to_torch(jax.tree.map(np.asarray, jp), device="cpu")


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# --------------------------------------------------------------------------- #
# twins of tests/test_moe_ssp.py::TestMoE
# --------------------------------------------------------------------------- #
class TestMoE:
    @pytest.fixture()
    def setup(self):
        cfg = get_config(ARCH).reduced()
        params = init_moe(torch.Generator().manual_seed(0), cfg, (),
                          dtype=torch.bfloat16, device=torch.device("cpu"))
        x = torch.randn((2, 16, cfg.d_model),
                        generator=torch.Generator().manual_seed(1)).bfloat16()
        return cfg, params, x

    def test_output_shape_and_finite(self, setup):
        cfg, params, x = setup
        out, aux = moe_forward(params, x, cfg)
        assert out.shape == x.shape and out.dtype == x.dtype
        assert torch.isfinite(out.float()).all()
        assert float(aux) > 0.0 and aux.dtype == torch.float32
        assert params["router"].dtype == torch.float32

    def test_capacity_formula(self):
        # deepseek-v2-236b's experts: 256 tokens, top-6 of 160, cf 1.25
        moe = MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2)
        assert capacity(256, moe) == 12
        assert capacity(256, get_config(ARCH).moe) == 80
        assert capacity(1, get_config(ARCH).moe) == 1

    def test_dispatch_respects_capacity(self, setup):
        cfg, params, x = setup
        moe = cfg.moe
        probs = torch.softmax(torch.randn(
            (2, 16, moe.n_experts), generator=torch.Generator()
            .manual_seed(2)), -1)
        cap = capacity(16, moe)
        dispatch, combine = _dispatch_chunk(x, probs, moe, cap)
        slot_load = dispatch.float().sum(dim=1)
        assert (slot_load <= 1 + 1e-6).all()
        expert_load = dispatch.float().sum(dim=(1, 3))
        assert (expert_load <= cap + 1e-6).all()

    def test_combine_weights_normalized(self, setup):
        cfg, params, x = setup
        moe = cfg.moe
        probs = torch.softmax(torch.randn(
            (2, 16, moe.n_experts), generator=torch.Generator()
            .manual_seed(3)), -1)
        cap = capacity(16, moe) + 16
        dispatch, combine = _dispatch_chunk(x, probs, moe, cap)
        np.testing.assert_allclose(combine.sum(dim=(2, 3)).numpy(), 1.0,
                                   rtol=1e-3)

    def test_shared_expert_always_on(self):
        cfg, _ = _cfg(n_shared=2)
        params = init_moe(torch.Generator().manual_seed(0), cfg, (),
                          dtype=torch.bfloat16, device=torch.device("cpu"))
        assert "shared" in params
        assert params["shared"]["up"].shape == (cfg.d_model,
                                                2 * cfg.moe.d_expert)
        x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
        out, _ = moe_forward(params, x, cfg)
        assert out.shape == x.shape

    def test_chunked_equals_unchunked(self, setup):
        cfg, params, x = setup
        big = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        out1, _ = moe_forward(params, x, big, chunk=8)
        out2, _ = moe_forward(params, x, big, chunk=16)
        np.testing.assert_allclose(out1.float().numpy(),
                                   out2.float().numpy(), rtol=3e-2,
                                   atol=3e-2)


# --------------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------------- #
def test_init_matches_reference_tree():
    cfg, jcfg = _cfg(n_shared=1)
    jp, _ = _params(jcfg, jnp.bfloat16)
    tp = init_moe(torch.Generator().manual_seed(0), cfg, (3,),
                  dtype=torch.bfloat16, device=torch.device("cpu"))
    jl = jax.tree_util.tree_leaves(jp)
    tl, _ = tree_flatten(tp)
    assert [(3,) + j.shape for j in jl] == [tuple(t.shape) for t in tl]
    assert [str(j.dtype) for j in jl] == [
        str(t.dtype).removeprefix("torch.") for t in tl]
    for t, j in zip(tl, jl):
        ts, js = float(t.float().std()), float(jnp.std(j.astype(jnp.float32)))
        assert abs(ts - js) <= 0.1 * js + 1e-6, (ts, js)


def test_router_topk_ties_take_lower_index_first():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = router_topk(torch.from_numpy(probs), 3)
    assert ti.tolist() == np.asarray(ji).tolist()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _planted_ties(p_np, pairs):
    """Copy router column a into column b for each (a, b): those experts'
    probabilities are then equal for every token."""
    r = p_np["router"].copy()
    for a, b in pairs:
        r[..., b] = r[..., a]
    return {**p_np, "router": r}


@pytest.mark.parametrize("case", ["plain", "drops", "ties", "ties_drops"])
def test_dispatch_chunk_matches_reference(case):
    moe = get_config(ARCH).reduced().moe
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 32, moe.n_experts)).astype(np.float32)
    if "ties" in case:
        logits[:, ::2, 1] = logits[:, ::2, 0]      # planted ties
        logits[:, 1::3, 3] = logits[:, 1::3, 2]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    cap = 5 if "drops" in case else 32          # 32: no expert overflows
    x = rng.standard_normal((3, 32, 8)).astype(np.float32)
    jd, jc = jmoe._dispatch_chunk(jnp.asarray(x), jnp.asarray(probs), moe,
                                  cap)
    td, tc = _dispatch_chunk(torch.from_numpy(x), torch.from_numpy(probs),
                             moe, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)
    kept = float(td.sum())
    if "drops" in case:
        assert kept < 3 * 32 * moe.top_k          # some choices dropped
    else:
        assert kept == 3 * 32 * moe.top_k


MOE_CASES = {
    # name: (moe overrides, router ties, B, S, chunk)
    "default": ({}, (), 2, 32, 16),
    "drops": (dict(capacity_factor=0.5), (), 2, 32, 16),
    "ties": ({}, ((0, 1), (2, 3)), 2, 32, 16),
    "ties_drops": (dict(capacity_factor=0.5), ((0, 1),), 2, 32, 32),
    "shared": (dict(n_shared=1), (), 1, 16, 256),
}


def _forward_pair(case, dtype):
    kw, ties, b, s, chunk = MOE_CASES[case]
    cfg, jcfg = _cfg(**kw)
    jp, _ = _params(jcfg, dtype)
    p_np = _planted_ties(jax.tree.map(np.asarray, jp), ties)
    jp = jax.tree.map(jnp.asarray, p_np)
    jp = {**jp, **{k: v.astype(dtype) for k, v in jp.items()
                   if k not in ("router", "shared")}}
    if "shared" in jp:
        jp["shared"] = jax.tree.map(lambda v: v.astype(dtype), jp["shared"])
    tp = to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    x = _x(b, s, cfg.d_model)
    return cfg, jcfg, jp, tp, x, chunk


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference_f32(case):
    cfg, jcfg, jp, tp, x, chunk = _forward_pair(case, jnp.float32)
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg, chunk=chunk)
    tout, taux = moe_forward(tp, torch.from_numpy(x), cfg, chunk=chunk)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=0, atol=2e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    if case in ("drops", "ties_drops"):
        # the case really drops tokens: a drop-free capacity differs
        free = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        out_free, _ = moe_forward(tp, torch.from_numpy(x), free, chunk=chunk)
        assert not torch.allclose(out_free, tout, atol=1e-4)


@pytest.mark.parametrize("case", ["default", "ties_drops"])
def test_moe_forward_matches_reference_bf16(case):
    cfg, jcfg, jp, tp, x, chunk = _forward_pair(case, jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["w_up"].dtype == torch.bfloat16
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                  chunk=chunk)
    tout, taux = moe_forward(tp, torch.from_numpy(x).bfloat16(), cfg,
                             chunk=chunk)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=4e-2, atol=4e-2)
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("case", ["default", "ties_drops", "shared"])
def test_moe_grads_match_jax_grad(case):
    cfg, jcfg, jp, tp, x, chunk = _forward_pair(case, jnp.float32)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe_forward(p, xx, jcfg, chunk=chunk)
        return jnp.sum(out * w) + 0.01 * aux

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp,
                                                           jnp.asarray(x))
    leaves, treedef = tree_flatten(tp)
    live = [t.clone().requires_grad_(True) for t in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe_forward(tree_unflatten(treedef, live), tx, cfg,
                           chunk=chunk)
    loss = torch.sum(out * torch.from_numpy(w)) + 0.01 * aux
    grads = torch.autograd.grad(loss, live + [tx])
    jleaves = jax.tree_util.tree_leaves(jg_p) + [jg_x]
    assert len(jleaves) == len(grads)
    for tg, jg in zip(grads, jleaves):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5)
    router = next(i for i, t in enumerate(leaves) if t is tp["router"])
    assert float(grads[router].abs().max()) > 0
