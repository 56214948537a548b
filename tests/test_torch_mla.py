"""DeepSeek-V2's latent attention (MLA) in the port against the JAX
package's (``repro/models/attention.py``), on the reduced deepseek-v2-236b
(4 heads, latent rank 32, nope/rope/v head dims 32/16/32) with the
reference's params converted through numpy.

* ``mla_forward``: output and the latent cache {ckv, krope} in f32 within
  atol 2e-5 / rtol 1e-5 (f32 sums in other orders); q and k have head dim
  48 and v 32, so it takes the blockwise loop under either impl and never
  launches the flash kernel.
* ``mla_decode``, the absorbed form: 8 steps against the reference's,
  output and cache, same limits; the cache is written in place.
* Teacher-forced absorbed decode against the forward's last position, in
  f32 (the two forms differ by the order of the products: 2e-5 / 1e-5)
  and in bf16 at the reference's own limits for prefill against decode
  (rtol 0.15 / atol 0.35, ``tests/test_configs_smoke.py``).
* The score product widened a slice of positions at a time gives the
  unsliced product bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro_torch.configs import get_config
from repro_torch.interop import to_torch
from repro_torch.kernels import flash_attention_op
from repro_torch.models import attention as tattn

ARCH = "deepseek-v2-236b"
B, S = 2, 24


@pytest.fixture(scope="module")
def mla():
    jcfg = j_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jattn.init_mla(jax.random.key(3), jcfg, dtype=jnp.float32)
    tp = to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(a, b, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=2e-5,
                               err_msg=msg)


@pytest.mark.parametrize("impl", ["blockwise", "pallas"])
def test_mla_forward_matches_reference(mla, impl):
    jcfg, cfg, jp, tp, x = mla
    jout, jcache = jax.jit(lambda p, x: jattn.mla_forward(p, x, jcfg))(
        jp, jnp.asarray(x))
    before = flash_attention_op.launches
    tattn.set_attention_impl(impl)
    try:
        tout, tcache = tattn.mla_forward(tp, torch.from_numpy(x), cfg,
                                         kv_block=8)
    finally:
        tattn.set_attention_impl("blockwise")
    assert flash_attention_op.launches == before
    _close(tout, jout, "out")
    assert sorted(tcache) == sorted(jcache) == ["ckv", "krope"]
    for k in tcache:
        assert tuple(tcache[k].shape) == jcache[k].shape
        _close(tcache[k], jcache[k], k)
    m = cfg.mla
    assert tcache["ckv"].shape == (B, S, m.kv_lora_rank)
    assert tcache["krope"].shape == (B, S, m.qk_rope_head_dim)


def test_mla_decode_matches_reference(mla):
    jcfg, cfg, jp, tp, x = mla
    m = cfg.mla
    jc = {"ckv": jnp.zeros((B, S, m.kv_lora_rank), jnp.float32),
          "krope": jnp.zeros((B, S, m.qk_rope_head_dim), jnp.float32)}
    tc = {k: torch.zeros(v.shape) for k, v in jc.items()}
    ptrs = {k: t.data_ptr() for k, t in tc.items()}
    step = jax.jit(lambda p, x, c, pos: jattn.mla_decode(p, x, c, pos, jcfg))
    for pos in range(8):
        xt = x[:, pos:pos + 1]
        jout, jc = step(jp, jnp.asarray(xt), jc, jnp.asarray(pos, jnp.int32))
        tout, tc = tattn.mla_decode(tp, torch.from_numpy(xt), tc, pos, cfg)
        _close(tout, jout, f"decode step {pos}")
        for k in tc:
            assert tc[k].data_ptr() == ptrs[k]      # written in place
            _close(tc[k], jc[k], f"cache {k} at step {pos}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_matches_forward(mla, dtype):
    """Teacher-forced absorbed decode reads the forward's outputs at every
    position, and builds the forward's latent cache."""
    _, cfg, _, tp, x = mla
    dt = getattr(torch, dtype)
    p = {k: v.to(dt) for k, v in tp.items()}
    xt = torch.from_numpy(x).to(dt)
    out, cache = tattn.mla_forward(p, xt, cfg)
    dec = {k: torch.zeros(v.shape, dtype=dt) for k, v in cache.items()}
    steps = []
    for pos in range(S):
        o, dec = tattn.mla_decode(p, xt[:, pos:pos + 1], dec, pos, cfg)
        steps.append(o)
    steps = torch.cat(steps, dim=1)
    if dtype == "float32":
        _close(steps, out, "outputs")
        for k in cache:
            _close(dec[k], cache[k], k)
    else:
        np.testing.assert_allclose(_np(steps), _np(out), rtol=0.15,
                                   atol=0.35)
        for k in cache:
            np.testing.assert_allclose(_np(dec[k]), _np(cache[k]),
                                       rtol=0.15, atol=0.35)


def test_score_slices_equal_one_product(monkeypatch):
    g = torch.Generator().manual_seed(5)
    q = torch.randn((3, 4, 32), generator=g).to(torch.bfloat16)
    c = torch.randn((3, 50, 32), generator=g).to(torch.bfloat16)
    whole = tattn._f32_scores(q, c)
    assert whole.dtype == torch.float32 and whole.shape == (3, 4, 50)
    torch.testing.assert_close(
        whole, torch.matmul(q.float(), c.float().transpose(1, 2)),
        rtol=0, atol=0)
    # 7 positions a slice: seven slices, the last ragged
    monkeypatch.setattr(tattn, "_MLA_SCORE_ELEMS", 3 * 32 * 7)
    assert torch.equal(tattn._f32_scores(q, c), whole)
