"""The model families of slice 7 on the port, against the JAX package:
qwen2-7b (dense, 28/4 heads), phi-3-vision-4.2b (dense with the stubbed
patch-embedding prefix) and granite-moe-1b-a400m (sparse experts on every
layer), each at its reduced size.

* Twins of ``tests/test_configs_smoke.py``'s ``test_train_step_smoke``,
  ``test_prefill_decode_smoke`` and ``test_decode_matches_prefill`` for the
  three configs, in bf16 as the reference runs them, with its tolerances
  (rtol 0.15 / atol 0.35 for prefill against teacher-forced decode).  The
  MoE check runs at a drop-free capacity, as the reference's does: a
  prefill chunk and a one-token step have other capacities.  The reference
  skips the vision config there (the prefix shifts positions); the twin
  holds its text-only prefill, what ``serve`` runs, against decode.
* Port against JAX on params initialized in JAX and converted through
  numpy, in f32: total loss, the loss and the aux loss within 1e-5, grads
  within rtol 1e-4 / atol 1e-6 (as ``test_torch_model.py``: the same f32
  math summed in other orders), prefill logits and cache and four decode
  steps' logits within atol 2e-5 / rtol 1e-5 (as ``test_torch_serve.py``).
* The flash kernel's plain version at head dim 96 (phi-3-vision's) against
  the Pallas kernel in interpret mode: f32 within atol 2e-6, bf16 within
  one bf16 ulp (rtol 2^-7), as ``test_torch_serve.py`` holds D 32.
* The mixed-dtype tree (an f32 router beside bf16 experts): ``interop``
  keeps each leaf's type, the flat int8 wire decodes to the reference's
  values bit for bit, and two eq.-2 pushes at the server agree within
  rtol 1e-6 / atol 1e-8 (f32 leaves, the momentum) and one bf16 ulp (bf16
  leaves): XLA fuses an FMA where PyTorch rounds twice.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.dist.flatbuf import flat_compress_roundtrip as j_roundtrip
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import build_model as j_build_model
from repro.models import transformer as jtf
from repro.models.api import text_len as j_text_len
from repro.ps.server import ParameterServer as JServer
from repro_torch.configs import get_config
from repro_torch.dist.flatbuf import flat_compress_roundtrip
from repro_torch.interop import to_numpy, to_torch
from repro_torch.kernels import flash_attention_op
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import build_model, text_len, value_and_grad
from repro_torch.models import transformer as ttf
from repro_torch.ps.server import ParameterServer
from repro_torch.tree import tree_leaves

ARCHS = ["qwen2-7b", "phi-3-vision-4.2b", "granite-moe-1b-a400m"]
BATCH, SEQ = 2, 64


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _batch_np(cfg, seq, *, labels=True, seed=1):
    rng = np.random.default_rng(seed)
    st = text_len(cfg, seq)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, st))
         .astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab_size, (BATCH, st)
                                   ).astype(np.int32)
    if cfg.frontend == "vision":
        b["frontend_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return b


def _torch(b, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in b.items()}


def _jax(b, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in b.items()}


def test_registered_configs_match_reference():
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            j_get_config(arch))
        assert text_len(get_config(arch), 4096) == j_text_len(
            j_get_config(arch), 4096)
    assert get_config("phi-3-vision-4.2b").head_dim == 96
    assert ttf.AUX_LOSS_COEF == jtf.AUX_LOSS_COEF


# --------------------------------------------------------------------------- #
# twins of tests/test_configs_smoke.py
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def built():
    """Build and init each reduced arch (bf16) once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_config(arch).reduced()
            model = build_model(cfg, device="cpu")
            params = model.init(torch.Generator().manual_seed(0))
            cache[arch] = (cfg, model, params)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke(arch, built):
    cfg, model, params = built(arch)
    batch = _torch(_batch_np(cfg, SEQ, seed=1), torch.bfloat16)
    (loss, metrics), grads = value_and_grad(model.loss_fn, params, batch,
                                            has_aux=True)
    assert loss.shape == ()
    assert np.isfinite(float(loss.detach())), f"{arch}: loss={loss}"
    leaves = tree_leaves(grads)
    assert len(leaves) == len(tree_leaves(params))
    gnorm = sum(float(torch.sum(torch.square(g.float()))) for g in leaves)
    assert np.isfinite(gnorm) and gnorm > 0.0, f"{arch}: grad norm {gnorm}"
    assert (float(metrics["aux_loss"]) > 0.0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_smoke(arch, built):
    cfg, model, params = built(arch)
    batch = _torch(_batch_np(cfg, SEQ, labels=False, seed=2),
                   torch.bfloat16)
    logits, cache = model.prefill(params, batch)
    assert logits.shape == (BATCH, cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all()
    assert cache["layers"]["k"].shape[2] == SEQ    # the prefix is cached
    dec_cache = model.init_cache(BATCH, SEQ + 8)
    tok = torch.full((BATCH, 1), 3, dtype=torch.int32)
    for step in range(2):
        logits, dec_cache = model.decode_step(params, dec_cache, tok, step)
        assert logits.shape == (BATCH, cfg.padded_vocab)
        assert torch.isfinite(logits.float()).all(), arch
        tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, built):
    cfg, model, params = built(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        model = build_model(cfg, device="cpu")
    seq = 8
    toks = torch.from_numpy(_batch_np(cfg, seq + cfg.n_frontend_tokens,
                                      labels=False, seed=3)["tokens"])
    # text only: a vision config serves text requests with no prefix
    logits_pre, _ = model.prefill(params, {"tokens": toks})
    dec_cache = model.init_cache(BATCH, seq)
    logits = None
    for step in range(seq):
        logits, dec_cache = model.decode_step(params, dec_cache,
                                              toks[:, step:step + 1], step)
    np.testing.assert_allclose(_np(logits), _np(logits_pre), rtol=0.15,
                               atol=0.35)


# --------------------------------------------------------------------------- #
# against the JAX package, f32
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = j_get_config(arch).reduced()
            jmodel = j_build_model(jcfg, dtype=jnp.float32)
            jparams = jax.jit(jmodel.init)(jax.random.key(0))
            cfg = get_config(arch).reduced()
            tmodel = build_model(cfg, dtype=torch.float32, device="cpu")
            tparams = to_torch(jax.tree.map(np.asarray, jparams),
                               device="cpu")
            cache[arch] = (cfg, jmodel, jparams, tmodel, tparams)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match(arch, pairs):
    cfg, jmodel, jparams, tmodel, tparams = pairs(arch)
    b = _batch_np(cfg, SEQ, seed=4)
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(jparams, _jax(b))
    (ttotal, tm), tgrads = value_and_grad(tmodel.loss_fn, tparams, _torch(b),
                                          has_aux=True)
    for t, j in ((ttotal, jtotal), (tm["loss"], jm["loss"]),
                 (tm["aux_loss"], jm["aux_loss"])):
        assert abs(float(t) - float(j)) <= 1e-5, (float(t), float(j))
    assert (float(tm["aux_loss"]) > 0) == (cfg.moe is not None)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    tleaves = tree_leaves(tgrads)
    assert len(jleaves) == len(tleaves)
    for tg, jg in zip(tleaves, jleaves):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, pairs):
    cfg, jmodel, jparams, tmodel, tparams = pairs(arch)
    b = _batch_np(cfg, 32, labels=False, seed=5)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, _jax(b))
    tlogits, tcache = tmodel.prefill(tparams, _torch(b))
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=1e-5,
                               atol=2e-5)
    for k in ("k", "v"):
        assert tuple(tcache["layers"][k].shape) == jcache["layers"][k].shape
        np.testing.assert_allclose(_np(tcache["layers"][k]),
                                   _np(jcache["layers"][k]), rtol=1e-5,
                                   atol=2e-5)
    jc, tc = jmodel.init_cache(BATCH, 8), tmodel.init_cache(BATCH, 8)
    decode = jax.jit(jmodel.decode_step)
    toks = b["tokens"]
    for pos in range(4):
        jl, jc = decode(jparams, jc, jnp.asarray(toks[:, pos:pos + 1]),
                        jnp.asarray(pos, jnp.int32))
        tl, tc = tmodel.decode_step(tparams, tc,
                                    torch.from_numpy(toks[:, pos:pos + 1]),
                                    pos)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=2e-5,
                                   err_msg=f"decode step {pos}")


def test_vision_prefix_is_embedded_and_not_scored(pairs):
    """The patch embeddings come first and move the text's positions; the
    loss is over the text positions only."""
    cfg, _, _, tmodel, tparams = pairs("phi-3-vision-4.2b")
    b = _torch(_batch_np(cfg, SEQ, seed=6))
    h = ttf.embed_inputs(tparams, b, cfg)
    n = cfg.n_frontend_tokens
    assert h.shape == (BATCH, SEQ, cfg.d_model)
    assert torch.equal(h[:, :n], b["frontend_embeds"])
    text_only = {k: v for k, v in b.items() if k != "frontend_embeds"}
    with torch.no_grad():
        with_prefix = tmodel.loss_fn(tparams, b)[1]["loss"]
        without = tmodel.loss_fn(tparams, text_only)[1]["loss"]
    assert float(with_prefix) != float(without)


# --------------------------------------------------------------------------- #
# the flash kernel's plain version at head dim 96
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_d96_matches_pallas_interpret(causal, dtype):
    rng = np.random.default_rng(96 + causal)
    b, h, kvh, s, d = 1, 4, 2, 64, 96
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = _np(j_flash(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                       causal=causal, block_q=32, block_k=16,
                       interpret=True))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    before = flash_attention_op.launches
    outs = {"plain": flash_attention_plain(tq, tk, tv, causal=causal,
                                           block_k=16),
            "op": flash_attention_op(tq, tk, tv, causal=causal)}
    assert flash_attention_op.launches == before
    for name, out in outs.items():
        assert out.dtype == tdt and out.shape == (b, h, s, d), name
        if dtype == "float32":
            np.testing.assert_allclose(_np(out), want, rtol=0, atol=2e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(_np(out), want, rtol=2 ** -7,
                                       atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------- #
# the mixed-dtype tree on the wire and at the server
# --------------------------------------------------------------------------- #
def test_mixed_dtype_tree_wire_and_push_match_reference():
    jcfg = j_get_config("granite-moe-1b-a400m").reduced()
    jparams = jax.jit(j_build_model(jcfg).init)(jax.random.key(0))  # bf16
    tparams = to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    jl = jax.tree_util.tree_leaves(jparams)
    tl = tree_leaves(tparams)
    assert [str(j.dtype) for j in jl] == [
        str(t.dtype).removeprefix("torch.") for t in tl]
    assert tparams["layers"]["mlp"]["router"].dtype == torch.float32
    assert tparams["layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert tuple(tparams["layers"]["mlp"]["w_up"].shape) == (
        jcfg.n_layers, jcfg.moe.n_experts, jcfg.d_model, jcfg.moe.d_expert)
    back = to_numpy(tparams)
    for a, j in zip(jax.tree_util.tree_leaves(back), jl):
        np.testing.assert_array_equal(a, np.asarray(j, np.float32))

    rng = np.random.default_rng(7)
    server_t = ParameterServer(tparams, gamma=0.9)
    server_j = JServer(jparams, gamma=0.9)
    for step in range(2):
        u_np = jax.tree.map(lambda j: (rng.standard_normal(j.shape) * 1e-2)
                            .astype(np.float32), jl)
        ju = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams),
            [jnp.asarray(x) for x in u_np])
        tu = to_torch(jax.tree.map(np.asarray, ju), device="cpu")
        jdec, jnorm = j_roundtrip(ju)
        tdec, tnorm = flat_compress_roundtrip(tu)
        for a, b in zip(tree_leaves(tdec), jax.tree_util.tree_leaves(jdec)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert abs(tnorm - float(jnorm)) <= 1e-5 * float(jnorm)
        server_t.push(tdec, step)
        server_j.push(jdec, step)
    # eq. 2 in f32 on both sides, but XLA's CPU backend fuses u + gamma * h
    # into an FMA (one rounding, where PyTorch rounds twice: the difference
    # PERF.md notes for grad_aggregate), so h may differ in its last bit and
    # a bf16 param that lands on a rounding tie by one bf16 ulp.  One
    # rounding of gamma * h (|h| < 0.1 here) is below 1e-8
    for a, b in zip(tree_leaves(server_t.history),
                    jax.tree_util.tree_leaves(server_j.history)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-8)
    for a, b in zip(tree_leaves(server_t.params),
                    jax.tree_util.tree_leaves(server_j.params)):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        if a.dtype == torch.float32:
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-8)
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=2 ** -7, atol=0)
