"""The port's serving path against the JAX package's, on the CPU.

The same numpy inputs (or params initialized in JAX and converted through
numpy in f32) go through both packages.  On the CPU the port's flash
attention is its plain PyTorch version; the reference's Pallas kernel runs
in interpret mode.  Tolerances, all f32 unless stated:

* attention outputs within atol 2e-6 (the same f32 sums in other orders);
  in bf16 within rtol 2^-7 (one bf16 ulp: the two f32 results may round
  to neighbouring bf16 values);
* prefill logits and cache, and decode logits, within atol 2e-5 / rtol
  1e-5 (two reduced layers of f32 math summed in other orders: 4e-6 seen);
* int8 cache payloads equal and scales within rtol 1e-6 after 12 whole-
  model steps (the k and v that are quantized differ in the last bits, so
  a scale may differ by an ulp); given the same k and v, payloads and
  scales are bit-equal to the reference's, jitted and eager;
* greedy tokens identical.

The twins of ``tests/test_attention_impls.py`` and ``tests/test_kv_int8.py``
keep those tests' own claims and tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro.launch.serve import Request as JRequest
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import transformer as jtf
from repro_torch.configs import get_config, get_shape
from repro_torch.interop import to_torch
from repro_torch.kernels import flash_attention_op
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import build_step, make_host_mesh
from repro_torch.launch.serve import Request, serve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import transformer as ttf

ARCHS = ["qwen2-0.5b", "stablelm-1.6b"]


@pytest.fixture(autouse=True)
def _restore_impl():
    yield
    jattn.set_attention_impl("blockwise")
    tattn.set_attention_impl("blockwise")


def _set_impl(impl):
    jattn.set_attention_impl(impl)
    tattn.set_attention_impl(impl)


def _models(arch, dtype=jnp.float32):
    cfg = j_get_config(arch).reduced()
    jmodel = j_build_model(cfg, dtype=dtype)
    jparams = jmodel.init(jax.random.key(0))
    tmodel = build_model(get_config(arch).reduced(),
                         dtype=torch.float32 if dtype == jnp.float32
                         else torch.bfloat16, device="cpu")
    tparams = to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, tmodel, tparams


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# --------------------------------------------------------------------------- #
# the kernel's plain version and the wrapper on the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2])
def test_flash_plain_matches_pallas_interpret(g, causal, dtype):
    rng = np.random.default_rng(g * 10 + causal)
    b, h, s, d = 2, 4, 64, 32
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, s, d), (b, h // g, s, d),
                             (b, h // g, s, d)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    want = _np(j_flash(jq, jk, jv, causal=causal, block_q=32, block_k=16,
                       interpret=True))
    want_ref = _np(j_flash_ref(jq, jk, jv, causal=causal))
    before = flash_attention_op.launches
    outs = {"plain": flash_attention_plain(tq, tk, tv, causal=causal,
                                           block_k=16),
            "op": flash_attention_op(tq, tk, tv, causal=causal),
            "ref": flash_attention_ref(tq, tk, tv, causal=causal)}
    assert flash_attention_op.launches == before  # the CPU takes no kernel
    for name, out in outs.items():
        assert out.dtype == tdt and out.shape == (b, h, s, d), name
        for w in (want, want_ref):
            if dtype == "float32":
                np.testing.assert_allclose(_np(out), w, rtol=0, atol=2e-6,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(_np(out), w, rtol=2 ** -7,
                                           atol=1e-6, err_msg=name)


def test_flash_plain_on_strided_views_and_ragged_keys():
    """[B, S, H, D] tensors through transposed views, and a key count that
    is no multiple of the key block, give the dense oracle's answer."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, h, 32))
                                .astype(np.float32))
               for h in (4, 2, 2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = flash_attention_plain(qt, kt, vt, block_k=16)
    ref = flash_attention_ref(qt.contiguous(), kt.contiguous(),
                              vt.contiguous())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=2e-6)


def test_flash_op_raises_under_autograd():
    q = torch.zeros((1, 2, 16, 32), requires_grad=True)
    k = torch.zeros((1, 1, 16, 32))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_op(q, k, k)
    with torch.no_grad():
        assert flash_attention_op(q, k, k).shape == q.shape


def test_impl_switch_refuses_unknown_names():
    with pytest.raises(ValueError, match="blockwise"):
        tattn.set_attention_impl("cudnn")
    tattn.set_attention_impl("pallas")
    assert tattn.get_attention_impl() == "pallas"


# --------------------------------------------------------------------------- #
# twins of tests/test_attention_impls.py
# --------------------------------------------------------------------------- #
def _qkv_np(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, kvh, kvh)]


def test_blockwise_matches_plain():
    """Online-softmax scan == single-block plain attention, and both ==
    the reference's."""
    q, k, v = _qkv_np(0, 2, 128, 4, 2, 32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    small = tattn.blockwise_attention(*t, causal=True, kv_block=32)
    big = tattn.blockwise_attention(*t, causal=True, kv_block=128)
    np.testing.assert_allclose(small.numpy(), big.numpy(), rtol=2e-4,
                               atol=2e-4)
    j = jattn.blockwise_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=True, kv_block=32)
    np.testing.assert_allclose(small.numpy(), np.asarray(j), rtol=0,
                               atol=2e-6)


def test_blockwise_q_offset_matches_reference():
    """A q block that starts past the first key (``q_offset``), one block
    and several."""
    q, _, _ = _qkv_np(5, 1, 32, 4, 2, 32)
    _, k, v = _qkv_np(6, 1, 96, 4, 2, 32)
    for kv_block in (512, 32):
        t = tattn.blockwise_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
            q_offset=64, kv_block=kv_block)
        j = jattn.blockwise_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      causal=True, q_offset=64,
                                      kv_block=kv_block)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=2e-6)


def test_pallas_impl_matches_blockwise():
    q, k, v = _qkv_np(1, 1, 64, 4, 2, 32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    ref = tattn.blockwise_attention(*t, causal=True, kv_block=32)
    _set_impl("pallas")
    out = tattn.blockwise_attention(*t, causal=True, kv_block=32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-2,
                               atol=2e-2)
    j = jattn.blockwise_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=True, kv_block=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=0, atol=2e-6)


def test_model_forward_same_under_both_impls():
    """A whole reduced model gives the same loss with either impl, in the
    port and against the reference under each impl."""
    cfg, jmodel, jparams, tmodel, tparams = _models("stablelm-1.6b")
    toks, labels = _tokens(cfg, 2, 64, 1), _tokens(cfg, 2, 64, 2)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    losses = {}
    for impl in ("blockwise", "pallas"):
        _set_impl(impl)
        with torch.no_grad():
            losses[impl] = float(tmodel.loss_fn(tparams, tb)[0])
        assert abs(losses[impl] - float(jmodel.loss_fn(jparams, jb)[0])) \
            <= 1e-5, impl
    assert abs(losses["blockwise"] - losses["pallas"]) < 0.05


# --------------------------------------------------------------------------- #
# twins of tests/test_kv_int8.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-0.5b"])
def test_int8_cache_matches_bf16(arch):
    """bf16 params (the reference test's), int8 against the bf16 cache."""
    cfg, _, _, tmodel, tparams = _models(arch, dtype=jnp.bfloat16)
    seq = 12
    toks = torch.from_numpy(_tokens(cfg, 2, seq))
    outs = {}
    for kv_int8 in (False, True):
        cache = ttf.init_cache(tmodel.config, 2, seq, kv_int8=kv_int8)
        logits = None
        for step in range(seq):
            logits, cache = tmodel.decode_step(tparams, cache,
                                               toks[:, step:step + 1], step)
        outs[kv_int8] = logits.float().numpy()
    denom = np.maximum(np.abs(outs[False]).max(), 1.0)
    rel = np.abs(outs[True] - outs[False]).max() / denom
    assert rel < 0.05, rel
    agree = (outs[True].argmax(-1) == outs[False].argmax(-1)).mean()
    assert agree >= 0.5, agree


def test_int8_cache_half_the_bytes():
    cfg = get_config("minicpm-2b").reduced()
    c_bf16 = ttf.init_cache(cfg, 2, 64)
    c_int8 = ttf.init_cache(cfg, 2, 64, kv_int8=True)
    nbytes = lambda c: sum(t.numel() * t.element_size()  # noqa: E731
                           for t in c["layers"].values())
    assert nbytes(c_int8) < 0.6 * nbytes(c_bf16)
    # the reference's layout, leaf by leaf
    jcfg = j_get_config("minicpm-2b").reduced()
    for kv_int8, c in ((False, c_bf16), (True, c_int8)):
        j = jtf.init_cache(jcfg, 2, 64, kv_int8=kv_int8)["layers"]
        assert sorted(j) == sorted(c["layers"])
        for name, t in c["layers"].items():
            assert tuple(t.shape) == j[name].shape, name
            assert str(t.dtype).removeprefix("torch.") == str(j[name].dtype)


def test_quantize_kv_bit_equal_to_reference_jitted_and_eager():
    """Given the reference's own k and v, the port's int8 payloads and
    scales are the reference's bit for bit: ``reciprocal=True`` against its
    jitted decode (``amax * f32(1/127)``), ``False`` against its eager one
    (``amax / 127``).  Both roundings occur in these inputs."""
    cfg, _, jparams, _, _ = _models("qwen2-0.5b")
    p = jax.tree.map(lambda x: x[0], jparams["layers"]["mix"])
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((64, 1, cfg.d_model)) * 3,
                    jnp.float32)
    cache = jtf.init_cache(cfg, 64, 8, kv_int8=True)
    cache = jax.tree.map(lambda c: c[0], cache["layers"])

    def step(p, x, cache, pos):
        q, k, v = jattn._qkv(p, x, cfg)
        k = jattn.apply_rope(k, jnp.full((1,), pos), cfg.rope_theta)
        _, new = jattn.gqa_decode_q8(p, x, cache, pos, cfg)
        return k, v, new

    scales = {}
    for name, fn, recip in (("jit", jax.jit(step), True),
                            ("eager", step, False)):
        k, v, new = fn(p, x, cache, jnp.asarray(3, jnp.int32))
        for t, tag in ((k, "k"), (v, "v")):
            qv, sv = tattn.quantize_kv(torch.from_numpy(np.array(t)),
                                       reciprocal=recip)
            np.testing.assert_array_equal(
                qv[:, 0].numpy(), np.asarray(new[f"{tag}_q"])[:, 3])
            np.testing.assert_array_equal(
                sv[:, 0].numpy(), np.asarray(new[f"{tag}_s"])[:, 3])
            scales[name, tag] = sv.numpy()
    assert any(not np.array_equal(scales["jit", t], scales["eager", t])
               for t in "kv")


# --------------------------------------------------------------------------- #
# prefill, decode and serve against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["blockwise", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, impl):
    cfg, jmodel, jparams, tmodel, tparams = _models(arch)
    toks = _tokens(cfg, 2, 32)
    _set_impl(impl)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=2e-5)
    assert sorted(tc["layers"]) == ["k", "v"]
    for name in ("k", "v"):
        assert tuple(tc["layers"][name].shape) == jc["layers"][name].shape
        np.testing.assert_allclose(_np(tc["layers"][name]),
                                   _np(jc["layers"][name]), rtol=1e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jitted_reference(arch, kv_int8):
    """12 steps of ``decode_step`` against the reference's jitted one, the
    cache in the model's dtype or int8."""
    cfg, jmodel, jparams, tmodel, tparams = _models(arch)
    toks = _tokens(cfg, 2, 12)
    dec = jax.jit(jmodel.decode_step)
    jc = jmodel.init_cache(2, 16, kv_int8=kv_int8)
    tc = tmodel.init_cache(2, 16, kv_int8=kv_int8)
    ptrs = {k: t.data_ptr() for k, t in tc["layers"].items()}
    for pos in range(12):
        tok = toks[:, pos:pos + 1]
        jl, jc = dec(jparams, jc, jnp.asarray(tok), jnp.asarray(pos,
                                                                jnp.int32))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=2e-5)
    assert {k: t.data_ptr() for k, t in tc["layers"].items()} == ptrs
    for name, t in tc["layers"].items():
        j = np.asarray(jc["layers"][name])
        if name.endswith("_q"):
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            np.testing.assert_allclose(_np(t), j.astype(np.float32),
                                       rtol=1e-6 if kv_int8 else 1e-5,
                                       atol=0 if kv_int8 else 2e-5)


def test_serving_steps_match_the_model():
    """``build_step`` for the serving shapes on a world of one: the prefill
    step is ``prefill``; the decode step is ``decode_step`` and writes its
    cache in place."""
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    mesh = make_host_mesh(device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 16))
    pre = build_step(cfg, dataclasses.replace(get_shape("prefill_32k"),
                                              seq_len=16, global_batch=2),
                     mesh)
    logits, cache = pre.fn(params, {"tokens": toks})
    want, want_cache = model.prefill(params, {"tokens": toks})
    assert torch.equal(logits, want)
    assert torch.equal(cache["layers"]["k"], want_cache["layers"]["k"])
    dec = build_step(cfg, dataclasses.replace(get_shape("decode_32k"),
                                              seq_len=16, global_batch=2),
                     mesh)
    c1, c2 = model.init_cache(2, 16), model.init_cache(2, 16)
    ptr = c1["layers"]["k"].data_ptr()
    for pos in range(3):
        l1, c1 = dec.fn(params, c1, toks[:, pos:pos + 1], pos)
        l2, c2 = model.decode_step(params, c2, toks[:, pos:pos + 1], pos)
        assert torch.equal(l1, l2)
    assert c1["layers"]["k"].data_ptr() == ptr
    assert torch.equal(c1["layers"]["k"], c2["layers"]["k"])


def test_serve_matches_reference_loop():
    """The port's ``serve`` and the reference's loop (``launch/serve.py``,
    over its jitted ``decode_step``) give the same tokens."""
    cfg, jmodel, jparams, tmodel, tparams = _models("qwen2-0.5b")
    prompt_len, max_new, batch = 12, 8, 2
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
               for _ in range(3)]
    max_len = prompt_len + max_new

    dec = jax.jit(jmodel.decode_step)
    jreqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    for start in range(0, len(jreqs), batch):
        reqs = jreqs[start:start + batch]
        cache = jmodel.init_cache(len(reqs), max_len)
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

    done, steps, _ = serve(tmodel, tparams,
                           [Request(i, p) for i, p in enumerate(prompts)],
                           batch, max_len)
    assert steps == 2 * (max_len - 1)
    assert [r.rid for r in done] == [0, 1, 2]
    assert [r.output for r in done] == [r.output for r in jreqs]
    assert all(len(r.output) == max_new for r in done)


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_mod
    assert serve_mod.main(["--device", "cpu", "--requests", "3",
                           "--batch", "2", "--max-new", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen2-0.5b served 3 requests, 28 decode "
                             "steps in ")
    assert out[0].endswith(" steps/s on cpu)")
    assert len(out) == 4 and all("-> [" in line for line in out[1:])
