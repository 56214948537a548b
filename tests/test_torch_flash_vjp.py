"""The port's blockwise attention backward (``_FlashAttention``) against
autograd through plain attention and against the reference's flash VJP.

The twin of ``tests/test_flash_vjp.py`` at its tolerances (forward rtol /
atol 2e-4, grads 2e-3), then the port's grads against ``jax.grad`` of the
reference's ``blockwise_attention`` on the same numpy inputs, and the bytes
the forward keeps for the backward: exactly (q, k, v, out, lse), as the
reference's ``_flash_vjp_fwd`` keeps them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn


def _qkv(seed, b, sq, skv, h, kvh, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d))]
    return arrs, [torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in arrs]


def plain(q, k, v, causal, q_offset=0):
    scale = 1.0 / math.sqrt(q.shape[-1])
    mask = tattn._causal_bias(q.shape[1], k.shape[1], q_offset, causal,
                              q.device)
    return tattn._plain_attention(q, k, v, mask, scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,h,kvh,d", [(2, 64, 4, 2, 16),
                                          (1, 128, 2, 2, 32)])
def test_forward_matches(causal, b, sq, h, kvh, d):
    _, (q, k, v) = _qkv(0, b, sq, sq, h, kvh, d)
    with torch.no_grad():
        out = tattn.blockwise_attention(q, k, v, causal=causal, kv_block=32)
        want = plain(q, k, v, causal)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match(causal):
    """The flash backward == autograd through plain attention."""
    b, sq, h, kvh, d = 1, 64, 4, 2, 16
    _, tf = _qkv(1, b, sq, sq, h, kvh, d)
    _, tp = _qkv(1, b, sq, sq, h, kvh, d)
    torch.sin(tattn.blockwise_attention(*tf, causal=causal, kv_block=16)
              ).sum().backward()
    torch.sin(plain(*tp, causal)).sum().backward()
    for a, p, name in zip(tf, tp, "qkv"):
        np.testing.assert_allclose(a.grad.numpy(), p.grad.numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"d{name} mismatch")


def test_gradients_bf16_path():
    _, (q, k, v) = _qkv(2, 1, 64, 64, 2, 2, 16, dtype=torch.bfloat16)
    o = tattn.blockwise_attention(q, k, v, causal=True, kv_block=16)
    (o.float() ** 2).sum().backward()
    for t in (q, k, v):
        assert t.grad.dtype == torch.bfloat16
        assert bool(torch.isfinite(t.grad.float()).all())


@pytest.mark.parametrize("causal,q_offset,sq,skv", [
    (True, 0, 64, 64), (False, 0, 64, 64), (True, 32, 32, 96),
    (False, 16, 48, 80)])
def test_gradients_match_reference_jax_grad(causal, q_offset, sq, skv):
    """The port's grads against ``jax.grad`` of the reference's custom VJP,
    on the same inputs and cotangent weights (both f32 blockwise loops,
    summed in other orders)."""
    b, h, kvh, d, kv_block = 2, 4, 2, 16, 16
    arrs, t = _qkv(3 + sq + skv, b, sq, skv, h, kvh, d)
    wt = np.random.default_rng(9).standard_normal((b, sq, h, d)
                                                  ).astype(np.float32)

    def jloss(q, k, v):
        o = jattn.blockwise_attention(q, k, v, causal=causal,
                                      q_offset=q_offset, kv_block=kv_block)
        return jnp.sum(jnp.sin(o) * wt)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    o = tattn.blockwise_attention(*t, causal=causal, q_offset=q_offset,
                                  kv_block=kv_block)
    (torch.sin(o) * torch.from_numpy(wt)).sum().backward()
    for a, j, name in zip(t, jg, "qkv"):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name} mismatch")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_saved_bytes_are_the_residuals(dtype):
    """One call keeps q, k, v, out and the f32 lse [B, KVH, G, Sq] for the
    backward, and nothing else (no per-block scores or probabilities)."""
    b, s, h, kvh, d = 1, 256, 4, 2, 16
    _, (q, k, v) = _qkv(4, b, s, s, h, kvh, d, dtype=dtype)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tattn.blockwise_attention(q, k, v, causal=True, kv_block=32)
    size = torch.tensor([], dtype=dtype).element_size()
    want = (size * (2 * b * s * h * d + 2 * b * s * kvh * d)
            + 4 * b * kvh * (h // kvh) * s)
    assert sum(saved) == want, (saved, want)
    out.float().sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
