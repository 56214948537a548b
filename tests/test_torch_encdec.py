"""Whisper's encoder-decoder on the port against the JAX package, on the
CPU: the same numpy inputs and params initialized in JAX and converted
through ``interop.to_torch``, in f32 at the reduced size (2 + 2 layers,
d 128, 4/2 heads of 32, 16 frames) unless stated.

Tolerances (f32, rtol 1e-5 / atol 2e-5 unless stated):

* ``sinusoidal_positions`` against the reference's jitted table: atol 2e-6
  at 16 positions, 2.5e-4 at 1,500 (XLA's fused ``pow`` differs from
  ``torch.pow`` in the last bit, and one f32 ulp of an angle near 1,500 is
  1.2e-4; 1.2e-4 measured), and against its eager table within 1e-5
  (3.8e-6 measured).  At 32,768 positions the jitted table differs by up
  to 1.95e-3 (an ulp of the angle there is 2e-3), pinned below 4e-3;
* the encoder at 16 frames and at 1,500 (d 128: the blockwise loop with
  ``kv_block`` 500), with the position table's difference in its input
  (atol 2e-4 at 1,500: those 1.2e-4 through two layers and the norm,
  9.9e-5 measured);
* bf16 frames into an f32 model against the reference's own layer
  functions applied layer by layer, eagerly, with JAX's promotion (its
  ``lax.scan`` refuses a carry that turns from bf16 to f32; 1.6e-5
  measured);
* the loss within 1e-5, grads within rtol 1e-4 / atol 1e-6 (as
  ``test_torch_families.py``);
* prefill logits and cache (self k, v and ``cross_kv``) under "blockwise"
  and "pallas" (the Pallas kernel in interpret mode), 12 decode steps
  against the jitted ``decode_step``, and ``serve``'s greedy tokens
  identical to the reference's loop;
* checkpoints and ``interop`` exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint.checkpoint import _flatten_with_names as j_names
from repro.configs import get_config as j_get_config
from repro.launch.serve import Request as JRequest
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import encdec as jencdec
from repro.models.layers import apply_mlp as j_apply_mlp
from repro.models.layers import apply_norm as j_apply_norm
from repro.models.layers import sinusoidal_positions as j_positions
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpoint import _flatten_with_names
from repro_torch.configs import get_config, get_shape
from repro_torch.interop import to_numpy, to_torch
from repro_torch.kernels import flash_attention_op
from repro_torch.launch import build_step, make_host_mesh
from repro_torch.launch.serve import Request, serve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, value_and_grad
from repro_torch.models import encdec
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.tree import tree_flatten_with_path, tree_leaves

ARCH = "whisper-tiny"
BATCH = 2


@pytest.fixture(autouse=True)
def _restore_impl():
    yield
    jattn.set_attention_impl("blockwise")
    tattn.set_attention_impl("blockwise")


def _cfgs(n_frames=None):
    """(the reference's, the port's) reduced config, ``n_frames`` frames."""
    out = []
    for get in (j_get_config, get_config):
        cfg = get(ARCH).reduced()
        if n_frames is not None:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, n_frames=n_frames))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def pair():
    """(cfg, reference model, its f32 params, port model, converted
    params), memoized by frame count."""
    cache = {}

    def get(n_frames=None):
        if n_frames not in cache:
            jcfg, cfg = _cfgs(n_frames)
            jmodel = j_build_model(jcfg, dtype=jnp.float32)
            jparams = jax.jit(jmodel.init)(jax.random.key(0))
            tmodel = build_model(cfg, dtype=torch.float32, device="cpu")
            tparams = to_torch(jax.tree.map(np.asarray, jparams),
                               device="cpu")
            cache[n_frames] = (cfg, jmodel, jparams, tmodel, tparams)
        return cache[n_frames]

    return get


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _batch(cfg, seq, *, seed, labels=True):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, seq))
         .astype(np.int32),
         "frontend_embeds": rng.standard_normal(
             (BATCH, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab_size, (BATCH, seq)
                                   ).astype(np.int32)
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(t, j, err_msg="", atol=2e-5):
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=atol,
                               err_msg=err_msg)


# --------------------------------------------------------------------------- #
# positions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n, d, atol", [(16, 128, 2e-6), (1500, 384, 2.5e-4),
                                        (32768, 384, 4e-3)])
def test_sinusoidal_positions_match_reference(n, d, atol):
    t = sinusoidal_positions(n, d)
    assert t.dtype == torch.float32 and tuple(t.shape) == (n, d)
    jitted = np.asarray(jax.jit(j_positions, static_argnums=(0, 1))(n, d))
    np.testing.assert_allclose(t.numpy(), jitted, rtol=0, atol=atol)
    if n <= 1500:
        np.testing.assert_allclose(t.numpy(), np.asarray(j_positions(n, d)),
                                   rtol=0, atol=1e-5)


def test_decode_positions_are_the_prefill_table_rows():
    """A decode step's position row is the prefill table's, bit for bit,
    at the first and the last of 32,768 positions."""
    _, cfg = _cfgs()
    params = {"embeds": {"embed": torch.zeros((8, cfg.d_model))}}
    tokens = torch.zeros((1, 1), dtype=torch.int32)
    table = sinusoidal_positions(32768, cfg.d_model)
    for pos in (0, 1, 4095, 32767):
        row = encdec.decoder_embed(params, tokens, pos, cfg)[0, 0]
        assert torch.equal(row, table[pos]), pos


# --------------------------------------------------------------------------- #
# the encoder
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_frames, atol", [(None, 2e-5), (1500, 2e-4)])
def test_encode_matches_reference(pair, n_frames, atol):
    cfg, _, jparams, _, tparams = pair(n_frames)
    frames = _batch(cfg, 8, seed=1)["frontend_embeds"]
    want = jax.jit(jencdec.encode, static_argnums=2)(
        jparams, jnp.asarray(frames), cfg)
    got = encdec.encode(tparams, torch.from_numpy(frames), cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, atol=atol)


def _j_encode_promoted(jparams, frames, cfg):
    """The reference's ``encode`` with its layer loop unrolled, so JAX's
    promotion can widen the bf16 carry (its ``lax.scan`` refuses).  Run
    eagerly, op by op: under ``jit`` XLA's excess precision drops the
    first norm's rounding to bf16 (0.009 apart)."""
    enc = jparams["encoder"]
    h = frames + j_positions(frames.shape[1], cfg.d_model).astype(
        frames.dtype)
    for i in range(cfg.encoder.n_layers):
        p = jax.tree.map(lambda x: x[i], enc["layers"])
        hn = j_apply_norm(cfg.norm, p["norm1"], h)
        h = h + jattn.gqa_forward(p["attn"], hn, cfg, causal=False)[0]
        hn = j_apply_norm(cfg.norm, p["norm2"], h)
        h = h + j_apply_mlp(p["mlp"], hn, act=cfg.act)
    return j_apply_norm(cfg.norm, enc["final_norm"], h)


def test_bf16_frames_in_an_f32_model_promote_as_jax(pair):
    cfg, _, jparams, _, tparams = pair()
    frames = _batch(cfg, 8, seed=2)["frontend_embeds"]
    jf = jnp.asarray(frames, jnp.bfloat16)
    tf_ = torch.from_numpy(frames).to(torch.bfloat16)
    assert np.array_equal(np.asarray(jf, np.float32), _np(tf_))
    want = _j_encode_promoted(jparams, jf, cfg)      # eager: see below
    got = encdec.encode(tparams, tf_, cfg)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want)
    with pytest.raises(TypeError, match="carry"):
        jencdec.encode(jparams, jf, cfg)


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def test_loss_and_grads_match(pair):
    cfg, jmodel, jparams, tmodel, tparams = pair()
    b = _batch(cfg, 32, seed=3)
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(jparams, _jax(b))
    (ttotal, tm), tgrads = value_and_grad(tmodel.loss_fn, tparams,
                                          _torch(b), has_aux=True)
    assert abs(float(ttotal) - float(jtotal)) <= 1e-5
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    jnamed = [n for n, _ in j_names(jgrads)]
    tnamed = tree_flatten_with_path(tgrads)[0]
    assert [n for n, _ in tnamed] == jnamed
    assert any(n.startswith("encoder/") for n in jnamed)
    for (name, tg), jg in zip(tnamed, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    # the gradient reaches the encoder through the cross-attention
    enc = [float(torch.sum(torch.square(g))) for name, g in tnamed
           if name.startswith("encoder/layers/mlp/")]
    assert all(x > 0 for x in enc)


def test_remat_changes_nothing(pair):
    cfg, _, _, tmodel, tparams = pair()
    b = _torch(_batch(cfg, 16, seed=4))
    out = [value_and_grad(lambda p, x, r=r: tmodel.loss_fn(p, x, remat=r),
                          tparams, b, has_aux=True) for r in (True, False)]
    assert torch.equal(out[0][0][0], out[1][0][0])
    for a, g in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert torch.equal(a, g)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seq", [16, 32])
@pytest.mark.parametrize("impl", ["blockwise", "pallas"])
def test_prefill_matches_reference(pair, impl, seq):
    """At 16 tokens against 16 frames all three attentions reach the flash
    kernel under "pallas" (the decoder's causal, the encoder's and the
    cross-attention not); at 32 the cross-attention does not."""
    cfg, jmodel, jparams, tmodel, tparams = pair()
    b = _batch(cfg, seq, seed=5, labels=False)
    jattn.set_attention_impl(impl)
    tattn.set_attention_impl(impl)
    jl, jc = jmodel.prefill(jparams, _jax(b))
    before = flash_attention_op.launches
    tl, tc = tmodel.prefill(tparams, _torch(b))
    assert flash_attention_op.launches == before     # the plain version
    _close(tl, jl)
    tnamed = tree_flatten_with_path(tc)[0]
    assert [n for n, _ in tnamed] == ["cross_kv/0", "cross_kv/1",
                                      "layers/k", "layers/v"]
    assert isinstance(tc["cross_kv"], tuple)
    for (name, t), j in zip(tnamed, jax.tree_util.tree_leaves(jc)):
        assert tuple(t.shape) == j.shape, name
        _close(t, j, name)
    assert tuple(tc["cross_kv"][0].shape) == (
        cfg.n_layers, BATCH, cfg.encoder.n_frames, cfg.n_kv_heads,
        cfg.head_dim)


def test_decode_matches_jitted_reference(pair):
    """12 steps against the reference's jitted ``decode_step``, both from
    the reference prefill's ``cross_kv``; the self cache written in place,
    ``cross_kv`` read and never written."""
    cfg, jmodel, jparams, tmodel, tparams = pair()
    b = _batch(cfg, 12, seed=6, labels=False)
    _, jpre = jax.jit(jmodel.prefill)(jparams, _jax(b))
    jc = jmodel.init_cache(BATCH, 16)
    jc["cross_kv"] = jpre["cross_kv"]
    tc = tmodel.init_cache(BATCH, 16)
    assert sorted(tc) == ["layers"]
    tc["cross_kv"] = tuple(torch.from_numpy(np.asarray(t))
                           for t in jpre["cross_kv"])
    cross = [t.clone() for t in tc["cross_kv"]]
    ptrs = [t.data_ptr() for t in tree_leaves(tc)]
    dec = jax.jit(jmodel.decode_step)
    toks = b["tokens"]
    for pos in range(12):
        tok = toks[:, pos:pos + 1]
        jl, jc = dec(jparams, jc, jnp.asarray(tok), jnp.asarray(pos,
                                                                jnp.int32))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), pos)
        _close(tl, jl, f"decode step {pos}")
    assert [t.data_ptr() for t in tree_leaves(tc)] == ptrs
    assert all(torch.equal(a, c) for a, c in zip(tc["cross_kv"], cross))
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name], name)
    with pytest.raises(KeyError, match="cross_kv"):
        tmodel.decode_step(tparams, tmodel.init_cache(BATCH, 4),
                           torch.from_numpy(toks[:, :1]), 0)


def test_serving_steps_carry_frames_and_cross_kv(pair):
    """``build_step``'s prefill carries ``frontend_embeds`` and its decode
    step a cache with ``cross_kv``: each is the model's own."""
    cfg, _, _, tmodel, tparams = pair()
    b = _torch(_batch(cfg, 16, seed=7, labels=False))
    mesh = make_host_mesh(device="cpu")
    pre = build_step(cfg, dataclasses.replace(get_shape("prefill_32k"),
                                              seq_len=16, global_batch=2),
                     mesh)
    logits, cache = pre.fn(tparams, b)
    want, want_cache = tmodel.prefill(tparams, b)
    assert torch.equal(logits, want)
    for a, w in zip(tree_leaves(cache), tree_leaves(want_cache)):
        assert torch.equal(a, w)
    dec = build_step(cfg, dataclasses.replace(get_shape("decode_32k"),
                                              seq_len=16, global_batch=2),
                     mesh)
    c1, c2 = tmodel.init_cache(2, 16), tmodel.init_cache(2, 16)
    c1["cross_kv"] = c2["cross_kv"] = cache["cross_kv"]
    for pos in range(3):
        tok = b["tokens"][:, pos:pos + 1]
        l1, c1 = dec.fn(tparams, c1, tok, pos)
        l2, c2 = tmodel.decode_step(tparams, c2, tok, pos)
        assert torch.equal(l1, l2)
    assert torch.equal(c1["layers"]["k"], c2["layers"]["k"])


def test_serve_encoder_branch_matches_reference_loop(pair):
    """The reference's serving loop (``launch/serve.py``: prompts, then per
    batch bf16 frames from the same generator, a prefill for ``cross_kv``
    and the decode loop over the jitted ``decode_step``) and the port's
    ``serve`` draw the same frames and give the same tokens.  The models
    are f32, so the reference's encoder runs layer by layer
    (``_j_encode_promoted``)."""
    cfg, jmodel, jparams, tmodel, tparams = pair()
    prompt_len, max_new, batch = 12, 8, 2
    max_len = prompt_len + max_new

    rng = np.random.default_rng(0)
    jreqs = [JRequest(i, rng.integers(0, cfg.vocab_size, prompt_len)
                      .astype(np.int32)) for i in range(3)]
    dec = jax.jit(jmodel.decode_step)
    j_frames = []
    for start in range(0, len(jreqs), batch):
        reqs = jreqs[start:start + batch]
        cache = jmodel.init_cache(len(reqs), max_len)
        embeds = jnp.asarray(rng.normal(
            size=(len(reqs), cfg.encoder.n_frames, cfg.d_model)),
            jnp.bfloat16)
        j_frames.append(np.asarray(embeds, np.float32))
        cache["cross_kv"] = jencdec._cross_kv(
            jparams["cross"], _j_encode_promoted(jparams, embeds, cfg), cfg)
        tok = jnp.asarray(np.stack([r.prompt[:1] for r in reqs]))
        for pos in range(max_len - 1):
            logits, cache = dec(jparams, cache, tok,
                                jnp.asarray(pos, jnp.int32))
            if pos + 1 < prompt_len:
                tok = jnp.asarray(np.stack([r.prompt[pos + 1:pos + 2]
                                            for r in reqs]))
            else:
                tok = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
                for i, r in enumerate(reqs):
                    r.output.append(int(tok[i, 0]))

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, prompt_len)
                    .astype(np.int32)) for i in range(3)]
    t_frames = []

    def prefill(params, b):
        t_frames.append(_np(b["frontend_embeds"]))
        assert b["frontend_embeds"].dtype == torch.bfloat16
        assert torch.equal(b["tokens"], torch.from_numpy(
            np.stack([r.prompt for r in reqs[len(t_frames) * 2 - 2:]
                      [:batch]])))
        return tmodel.prefill(params, b)

    model = dataclasses.replace(tmodel, prefill=prefill)
    done, steps, _ = serve(model, tparams, reqs, batch, max_len, rng)
    assert steps == 2 * (max_len - 1)
    assert len(t_frames) == 2
    for a, b in zip(t_frames, j_frames):
        np.testing.assert_array_equal(a, b)
    assert [r.output for r in done] == [r.output for r in jreqs]
    assert all(len(r.output) == max_new for r in done)
    with pytest.raises(ValueError, match="rng"):
        serve(tmodel, tparams, reqs, batch, max_len)


def test_serve_cli_runs_whisper_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_mod
    assert serve_mod.main(["--arch", ARCH, "--device", "cpu", "--requests",
                           "3", "--batch", "2", "--max-new", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={ARCH} served 3 requests, 28 decode "
                             "steps in ")
    assert len(out) == 4 and all("-> [" in line for line in out[1:])


# --------------------------------------------------------------------------- #
# the tree across the packages
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jparams_bf16():
    """The reference's reduced whisper params in bf16, as its CLI inits
    them."""
    return jax.jit(j_build_model(j_get_config(ARCH).reduced()).init)(
        jax.random.key(0))


def test_encoder_and_cross_trees_cross_exactly(jparams_bf16):
    tparams = to_torch(jax.tree.map(np.asarray, jparams_bf16), device="cpu")
    tnamed = _flatten_with_names(tparams)
    assert [n for n, _ in tnamed] == [n for n, _ in j_names(jparams_bf16)]
    for part in ("encoder", "cross"):
        jl = jax.tree_util.tree_leaves(jparams_bf16[part])
        tl = tree_leaves(tparams[part])
        assert len(tl) == len(jl) > 0
        for t, j in zip(tl, jl):
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
            np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))
    back = to_numpy(tparams)
    for a, j in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams_bf16)):
        np.testing.assert_array_equal(a, np.asarray(j, np.float32))
    # the port's own init builds the same tree
    own = build_model(get_config(ARCH).reduced(), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert [(n, tuple(t.shape), t.dtype) for n, t in _flatten_with_names(
        own)] == [(n, tuple(t.shape), t.dtype) for n, t in tnamed]


def test_reference_checkpoint_restores_in_the_port(jparams_bf16, tmp_path):
    JCheckpointer(str(tmp_path)).save(3, {"params": jparams_bf16},
                                      metadata={"arch": ARCH})
    tparams = to_torch(jax.tree.map(np.asarray, jparams_bf16), device="cpu")
    like = {"params": jax.tree.map(torch.zeros_like, tparams)}
    step, state, meta = Checkpointer(str(tmp_path)).restore(like)
    assert step == 3 and meta["arch"] == ARCH
    names = [n for n, _ in _flatten_with_names(state)]
    assert "params/encoder/layers/attn/wq" in names
    assert "params/cross/attn/bk" in names
    for t, j in zip(tree_leaves(state["params"]),
                    jax.tree_util.tree_leaves(jparams_bf16)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))
