"""The recurrent layers in the port against the JAX package's: mamba
(``repro/models/mamba.py``) and the RWKV6 time and channel mix
(``repro/models/rwkv.py``), on the reduced jamba-v0.1-52b (d 128, d_inner
256, state 8) and rwkv6-1.6b (4 heads of 32) with the reference's params
converted through numpy, and the jamba stack's tree.

* ``mamba_scan`` (one chunk and four, the state carried, its gradient
  through the rematerialized chunks), ``mamba_forward`` (from zeros and
  from a state) and 6 ``mamba_decode`` steps, f32, within atol 2e-5 /
  rtol 1e-5: the doubling scan and ``jax.lax.associative_scan`` multiply
  in other orders.  Gradients within rtol 1e-4 / atol 1e-6, as
  ``test_torch_model.py``.
* The time mix (chunks of 32 and 8, from zeros and from a state), the
  channel mix and 6 decode steps within rtol 1e-4 (the chunked form's
  ``1/P`` factors amplify rounding) and atol 2e-5.
* A prefill split in two halves, the state carried, equals one prefill
  (the same limits: the chunks fall elsewhere).
* Twins of ``tests/test_system.py::test_serve_path_all_subquadratic_archs``
  and ``tests/test_substrate.py::TestOptim::test_tuple_structured_params``.
* The jamba tree: a tuple of 8 slots stacked over the groups, its leaves'
  names, order, shapes and types those of ``jax.tree_util``'s walk of the
  reference's params and cache; ``interop`` carries it both ways, f32
  leaves (``a_log``, ``dt_bias``, ``d_skip``, the router) as f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_names as j_names
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import mamba as jmamba
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_config
from repro_torch.interop import to_numpy, to_torch
from repro_torch.models import build_model
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv as trwkv
from repro_torch.optim import momentum_sgd_init, momentum_sgd_update
from repro_torch.tree import tree_flatten_with_path

B, T = 2, 64
MAMBA_TOL = dict(rtol=1e-5, atol=2e-5)
RWKV_TOL = dict(rtol=1e-4, atol=2e-5)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), err_msg=msg, **tol)


def _pair(arch, init, seed):
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = init(jax.random.key(seed), jcfg, dtype=jnp.float32)
    return jcfg, cfg, jp, to_torch(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def _x(cfg, t=T, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, t, cfg.d_model)).astype(np.float32)


def _states(t_state, j_state, tol, msg):
    assert sorted(t_state) == sorted(j_state), msg
    for k in t_state:
        assert tuple(t_state[k].shape) == j_state[k].shape, (msg, k)
        _close(t_state[k], j_state[k], tol, f"{msg} {k}")


# --------------------------------------------------------------------------- #
# mamba
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mamba():
    return _pair("jamba-v0.1-52b", jmamba.init_mamba, 1)


def _scan_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    m = cfg.mamba
    di, n = m.inner(cfg.d_model), m.d_state
    return {"x_in": rng.standard_normal((B, T, di)),
            "dt": rng.uniform(0.001, 0.2, (B, T, di)),
            "a_log": np.log(np.broadcast_to(np.arange(1, n + 1), (di, n))),
            "b_ssm": rng.standard_normal((B, T, n)),
            "c_ssm": rng.standard_normal((B, T, n)),
            "d_skip": rng.standard_normal(di),
            "h0": rng.standard_normal((B, di, n))}


@pytest.mark.parametrize("chunk", [16, 128])
def test_mamba_scan_matches_reference(mamba, chunk):
    _, cfg, _, _ = mamba
    ins = {k: v.astype(np.float32)
           for k, v in _scan_inputs(cfg, chunk).items()}
    jy, jh = jax.jit(lambda a: jmamba.mamba_scan(**a, chunk=chunk))(
        {k: jnp.asarray(v) for k, v in ins.items()})
    ty, th = tmamba.mamba_scan(**{k: torch.from_numpy(v)
                                  for k, v in ins.items()}, chunk=chunk)
    _close(ty, jy, MAMBA_TOL, "y")
    _close(th, jh, MAMBA_TOL, "h_final")


def test_mamba_scan_grad_through_remat_matches_reference(mamba):
    """Four chunks, each rematerialized under autograd."""
    _, cfg, _, _ = mamba
    ins = {k: v.astype(np.float32) for k, v in _scan_inputs(cfg, 7).items()}
    w = np.random.default_rng(8).standard_normal(
        ins["x_in"].shape).astype(np.float32)
    keys = ("x_in", "dt", "b_ssm", "c_ssm", "h0")

    def jloss(a):
        y, h = jmamba.mamba_scan(**a, chunk=16)
        return jnp.sum(y * w) + jnp.sum(h)

    jg = jax.jit(jax.grad(jloss))({k: jnp.asarray(v) for k, v in ins.items()})
    t_ins = {k: torch.from_numpy(v).requires_grad_(k in keys)
             for k, v in ins.items()}
    y, h = tmamba.mamba_scan(**t_ins, chunk=16)
    tg = torch.autograd.grad(torch.sum(y * torch.from_numpy(w))
                             + torch.sum(h), [t_ins[k] for k in keys])
    for k, g in zip(keys, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_forward_matches_reference(mamba, with_state):
    jcfg, cfg, jp, tp = mamba
    x = _x(cfg, seed=2)
    jstate = tstate = None
    if with_state:
        st = jmamba.init_mamba_state(jcfg, B, jnp.float32)
        rng = np.random.default_rng(3)
        jstate = {k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                  for k, v in st.items()}
        tstate = {k: torch.from_numpy(np.array(v))
                  for k, v in jstate.items()}
    jout, jnew = jax.jit(lambda p, x, s: jmamba.mamba_forward(
        p, x, jcfg, state=s))(jp, jnp.asarray(x), jstate)
    tout, tnew = tmamba.mamba_forward(tp, torch.from_numpy(x), cfg,
                                      state=tstate)
    _close(tout, jout, MAMBA_TOL, "out")
    _states(tnew, jnew, MAMBA_TOL, "state")


def test_mamba_decode_matches_reference(mamba):
    jcfg, cfg, jp, tp = mamba
    x = _x(cfg, seed=4)
    jst = jmamba.init_mamba_state(jcfg, B, jnp.float32)
    tst = tmamba.init_mamba_state(cfg, B, torch.float32)
    ptrs = {k: t.data_ptr() for k, t in tst.items()}
    step = jax.jit(lambda p, x, s: jmamba.mamba_decode(p, x, s, jcfg))
    for pos in range(6):
        jout, jst = step(jp, jnp.asarray(x[:, pos:pos + 1]), jst)
        tout, tst = tmamba.mamba_decode(tp, torch.from_numpy(
            x[:, pos:pos + 1]), tst, cfg)
        assert {k: t.data_ptr() for k, t in tst.items()} == ptrs
        _close(tout, jout, MAMBA_TOL, f"step {pos}")
        _states(tst, jst, MAMBA_TOL, f"step {pos}")


def test_mamba_split_prefill_equals_one(mamba):
    _, cfg, _, tp = mamba
    x = torch.from_numpy(_x(cfg, seed=5))
    out, state = tmamba.mamba_forward(tp, x, cfg)
    a, st = tmamba.mamba_forward(tp, x[:, :T // 2], cfg)
    b, st = tmamba.mamba_forward(tp, x[:, T // 2:], cfg, state=st)
    _close(torch.cat([a, b], 1), out, MAMBA_TOL, "out")
    for k in state:
        _close(st[k], state[k], MAMBA_TOL, k)


# --------------------------------------------------------------------------- #
# rwkv6
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def rwkv():
    jcfg, cfg, jp, tp = _pair("rwkv6-1.6b", jrwkv.init_rwkv, 2)
    jcm = jrwkv.init_channel_mix(jax.random.key(4), jcfg, dtype=jnp.float32)
    return jcfg, cfg, jp, tp, jcm, to_torch(jax.tree.map(np.asarray, jcm),
                                            device="cpu")


def _rwkv_state(jcfg, seed):
    st = jrwkv.init_rwkv_state(jcfg, B, jnp.float32)
    rng = np.random.default_rng(seed)
    jst = {k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
           for k, v in st.items()}
    return jst, {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}


@pytest.mark.parametrize("chunk", [32, 8])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_time_mix_matches_reference(rwkv, chunk, with_state):
    jcfg, cfg, jp, tp, _, _ = rwkv
    x = _x(cfg, seed=chunk)
    jst, tst = _rwkv_state(jcfg, 9) if with_state else (None, None)
    jout, jnew = jax.jit(lambda p, x, s: jrwkv.rwkv_time_mix(
        p, x, jcfg, state=s, chunk=chunk))(jp, jnp.asarray(x), jst)
    tout, tnew = trwkv.rwkv_time_mix(tp, torch.from_numpy(x), cfg,
                                     state=tst, chunk=chunk)
    _close(tout, jout, RWKV_TOL, "out")
    _states(tnew, jnew, RWKV_TOL, "state")


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(rwkv, with_state):
    _, cfg, _, _, jcm, tcm = rwkv
    x = _x(cfg, seed=11)
    prev = np.random.default_rng(12).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    jout, jst = jrwkv.channel_mix(
        jcm, jnp.asarray(x),
        {"cm_shift": jnp.asarray(prev)} if with_state else None)
    tout, tst = trwkv.channel_mix(
        tcm, torch.from_numpy(x),
        {"cm_shift": torch.from_numpy(prev)} if with_state else None)
    _close(tout, jout, RWKV_TOL, "out")
    _states(tst, jst, RWKV_TOL, "state")


def test_rwkv_decode_matches_reference(rwkv):
    jcfg, cfg, jp, tp, _, _ = rwkv
    x = _x(cfg, seed=13)
    jst = jrwkv.init_rwkv_state(jcfg, B, jnp.float32)
    tst = trwkv.init_rwkv_state(cfg, B, torch.float32)
    ptrs = {k: t.data_ptr() for k, t in tst.items()}
    step = jax.jit(lambda p, x, s: jrwkv.rwkv_decode(p, x, s, jcfg))
    for pos in range(6):
        jout, jst = step(jp, jnp.asarray(x[:, pos:pos + 1]), jst)
        tout, tst = trwkv.rwkv_decode(tp, torch.from_numpy(
            x[:, pos:pos + 1]), tst, cfg)
        assert {k: t.data_ptr() for k, t in tst.items()} == ptrs
        _close(tout, jout, RWKV_TOL, f"step {pos}")
        _states(tst, jst, RWKV_TOL, f"step {pos}")


def test_rwkv_split_prefill_equals_one(rwkv):
    _, cfg, _, tp, _, tcm = rwkv
    x = torch.from_numpy(_x(cfg, seed=14))
    out, state = trwkv.rwkv_time_mix(tp, x, cfg)
    cm, cm_state = trwkv.channel_mix(tcm, x)
    a, st = trwkv.rwkv_time_mix(tp, x[:, :T // 2], cfg, chunk=16)
    b, st = trwkv.rwkv_time_mix(tp, x[:, T // 2:], cfg, state=st, chunk=16)
    _close(torch.cat([a, b], 1), out, RWKV_TOL, "time mix")
    for k in state:
        _close(st[k], state[k], RWKV_TOL, k)
    c1, cs = trwkv.channel_mix(tcm, x[:, :T // 2])
    c2, cs = trwkv.channel_mix(tcm, x[:, T // 2:], cs)
    assert torch.equal(torch.cat([c1, c2], 1), cm)
    assert torch.equal(cs["cm_shift"], cm_state["cm_shift"])


# --------------------------------------------------------------------------- #
# the stacks
# --------------------------------------------------------------------------- #
def test_serve_path_all_subquadratic_archs():
    """The two long_500k-capable archs decode beyond their cache warm-up."""
    for arch in ("rwkv6-1.6b", "jamba-v0.1-52b"):
        cfg = get_config(arch).reduced()
        assert cfg.sub_quadratic
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        cache = model.init_cache(1, 16)
        tok = torch.zeros((1, 1), dtype=torch.int32)
        for pos in range(4):
            logits, cache = model.decode_step(params, cache, tok, pos)
            tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
        assert bool(torch.isfinite(logits.float()).all())


def test_tuple_structured_params():
    """Optimizers must survive tuple-containing trees (jamba)."""
    params = {"layers": ({"w": torch.ones(2)}, {"w": torch.ones(3)})}
    state = momentum_sgd_init(params)
    grads = {"layers": tuple({"w": torch.ones_like(s["w"])}
                             for s in params["layers"])}
    new, _ = momentum_sgd_update(params, grads, state, lr=0.1, gamma=0.0)
    assert isinstance(new["layers"], tuple)
    np.testing.assert_allclose(new["layers"][0]["w"].numpy(), 0.9)
    np.testing.assert_allclose(new["layers"][1]["w"].numpy(), 0.9)


def _named(tree):
    return tree_flatten_with_path(tree)[0]


def _layout(named):
    return [(n, tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for n, a in named]


def test_jamba_tree_is_the_references():
    jcfg = j_get_config("jamba-v0.1-52b").reduced()
    cfg = get_config("jamba-v0.1-52b").reduced()
    jmodel = j_build_model(jcfg)                      # bf16, as served
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    model = build_model(cfg, device="cpu")
    tparams = model.init(torch.Generator().manual_seed(0))
    assert isinstance(tparams["layers"], tuple) and len(
        tparams["layers"]) == cfg.group_size == 8
    assert tparams["layers"][3]["mix"]["wq"].shape[0] == cfg.n_groups == 2
    assert "router" in tparams["layers"][1]["mlp"]          # odd: experts
    assert "gate" in tparams["layers"][0]["mlp"]            # even: dense

    def jlayout(tree):
        # the checkpoint's names; its arrays are bf16 widened to f32
        names = [n for n, _ in j_names(tree)]
        return [(n, a.shape, str(a.dtype)) for n, a in
                zip(names, jax.tree_util.tree_leaves(tree))]

    assert _layout(_named(tparams)) == jlayout(jparams)
    assert _layout(_named(model.init_cache(2, 16))) == \
        jlayout(jmodel.init_cache(2, 16))
    # interop both ways: bf16 travels as f32, f32 leaves stay f32
    back = to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    assert _layout(_named(back)) == jlayout(jparams)
    for name in ("a_log", "dt_bias", "d_skip"):
        assert back["layers"][0]["mix"][name].dtype == torch.float32
    assert back["layers"][1]["mlp"]["router"].dtype == torch.float32
    assert back["layers"][0]["mix"]["in_x"].dtype == torch.bfloat16
    for a, j in zip(jax.tree_util.tree_leaves(to_numpy(back)),
                    jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(j, np.float32))
