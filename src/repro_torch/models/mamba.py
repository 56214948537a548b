"""Mamba (S6 selective SSM), the Jamba hybrid's recurrent layer: the
reference's ``repro/models/mamba.py`` in PyTorch.

The diagonal recurrence ``h_t = a_t * h_{t-1} + b_t`` runs in time chunks
of ``chunk`` (128) tokens, the state carried from chunk to chunk.  The
reference scans inside a chunk with ``jax.lax.associative_scan``; here the
chunk is scanned by doubling (Hillis-Steele: log2(chunk) steps, each
combining every position with the one ``2^i`` before it), so a chunk is a
handful of whole-tensor operations and not a loop over tokens.  Both are
f32 and differ only in the order of the products.  Under autograd each
chunk is rematerialized (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does: the backward otherwise keeps ``[n_chunks, B,
chunk, d_inner, d_state]`` f32 residuals.

Decode is ``mamba_forward`` with ``chunk=1`` and the state ``{conv: [B,
K-1, d_inner], ssm: [B, d_inner, d_state] f32}``; ``mamba_decode`` writes
the new state into the state tensors in place, as the port's attention
decode writes its cache.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import MambaConfig, ModelConfig
from .layers import (Params, dense, dense_init, draw_device, is_dtensor,
                     local_zeros, normal, on_local_blocks, whole_rows)


def init_mamba(gen: torch.Generator, cfg: ModelConfig, n: int, *,
               dtype: torch.dtype, device: torch.device) -> Params:
    """``n`` stacked layers' params, the reference's distributions: A in
    the S4D-real initialization (``a_log[d, i] = log(i + 1)``, f32), dt's
    bias the inverse softplus of U(1e-4, 0.1) (f32), D ones (f32)."""
    m: MambaConfig = cfg.mamba
    d = cfg.d_model
    di, ns, r = m.inner(d), m.d_state, m.rank(d)
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.arange(1, ns + 1, **f32)).expand(n, di, ns)
    dt = torch.rand((n, di), generator=gen, device=draw_device(gen)) * 0.1
    dt_bias = torch.log(torch.exp(torch.clamp_min(dt, 1e-4)) - 1.0 + 1e-6)
    return {
        "in_x": dense_init(gen, (n, d, di), **kw),
        "in_z": dense_init(gen, (n, d, di), **kw),
        "conv_w": normal(gen, (n, m.d_conv, di), 1.0 / math.sqrt(m.d_conv),
                         **kw),
        "conv_b": torch.zeros((n, di), **kw),
        "x_proj": dense_init(gen, (n, di, r + 2 * ns), **kw),
        "dt_proj": dense_init(gen, (n, r, di), **kw),
        "dt_bias": dt_bias.to(**f32),
        "a_log": a_log.contiguous(),
        "d_skip": torch.ones((n, di), **f32),
        "out_proj": dense_init(gen, (n, di, d), **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time as shifted adds.  x: [B, T, di];
    w: [K, di]; history: [B, K-1, di], the tokens before x."""
    k = w.shape[0]
    ext = torch.cat([history.to(x.dtype), x], dim=1)       # [B, T+K-1, di]
    t = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + ext[:, i:i + t] * w[i]
    return out + b


def _shifted(z: torch.Tensor, off: int, fill: float) -> torch.Tensor:
    """``z[:, t - off]`` along time (dim 1 of [B, T, di, n]), ``fill``
    where ``t < off``."""
    return F.pad(z[:, :-off], (0, 0, 0, 0, off, 0), value=fill)


def _ssm_chunk(h0: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` within one chunk by
    doubling.  h0: [B, di, n]; a, b: [B, T, di, n].  Returns (h_all [B, T,
    di, n], h_T)."""
    off = 1
    while off < a.shape[1]:
        # (a, b) at t composed after (a, b) at t - off
        b = torch.addcmul(b, a, _shifted(b, off, 0.0))
        a = a * _shifted(a, off, 1.0)
        off *= 2
    h_all = a * h0[:, None] + b
    return h_all, h_all[:, -1]


def _chunk_body(h: torch.Tensor, xc: torch.Tensor, dtc: torch.Tensor,
                bc: torch.Tensor, cc: torch.Tensor, a: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: (h at its end, y [B, tc, di])."""
    a_bar = torch.exp(dtc[..., None] * a)                      # [B,tc,di,n]
    b_bar = (dtc * xc)[..., None] * bc[:, :, None, :]          # [B,tc,di,n]
    h_all, h_next = _ssm_chunk(h, a_bar, b_bar)
    return h_next, torch.einsum("btdn,btn->btd", h_all, cc)


def mamba_scan(x_in: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
               b_ssm: torch.Tensor, c_ssm: torch.Tensor,
               d_skip: torch.Tensor, h0: torch.Tensor, *, chunk: int = 128
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective-scan core.  x_in, dt: [B, T, di]; b_ssm, c_ssm: [B, T, n].
    Returns (y [B, T, di] in x_in's dtype, h_final [B, di, n] f32)."""
    t = x_in.shape[1]
    a = -torch.exp(a_log)                                      # [di, n]
    xf, dtf, bf, cf = (z.to(torch.float32)
                       for z in (x_in, dt, b_ssm, c_ssm))
    tc = min(chunk, t)
    if t % tc:
        raise ValueError(f"sequence {t} is not a multiple of the chunk {tc}")
    if t == tc:
        h_final, y = _chunk_body(h0, xf, dtf, bf, cf, a)
    else:
        remat = torch.is_grad_enabled()
        h_final, ys = h0, []
        for s in range(0, t, tc):
            args = (h_final, xf[:, s:s + tc], dtf[:, s:s + tc],
                    bf[:, s:s + tc], cf[:, s:s + tc], a)
            h_final, y = (checkpoint(_chunk_body, *args, use_reentrant=False)
                          if remat else _chunk_body(*args))
            ys.append(y)
        y = torch.cat(ys, dim=1)
    y = y + xf * d_skip
    return y.to(x_in.dtype), h_final


def mamba_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  chunk: int = 128,
                  state: Optional[Dict[str, torch.Tensor]] = None,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence mamba block over [B, T, d], from ``state`` or zeros.
    Returns (out, the state after the last token)."""
    m: MambaConfig = cfg.mamba
    bsz, t, d = x.shape
    di, n, r = m.inner(d), m.d_state, m.rank(d)
    if state is None:
        # laid out as x_in and the scan take them: a rank's block only
        conv_hist = local_zeros(x, (bsz, m.d_conv - 1, di),
                                ("B", None, "model"), x.dtype)
        h0 = local_zeros(x, (bsz, di, n), ("B", "model", None),
                         torch.float32)
    else:
        conv_hist, h0 = state["conv"], state["ssm"]

    x = whole_rows(x)                   # once for the two
    x_in = dense(x, p["in_x"])
    z = dense(x, p["in_z"])
    x_act = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"], conv_hist))
    dt_r, b_ssm, c_ssm = torch.split(dense(x_act, p["x_proj"]), [r, n, n],
                                     dim=-1)
    dt = F.softplus(dense(dt_r, p["dt_proj"]) + p["dt_bias"].to(dt_r.dtype))
    args = (x_act, dt, p["a_log"], b_ssm, c_ssm, p["d_skip"], h0)
    if is_dtensor(x_act):
        # each rank's batch rows and channels
        y, h_final = on_local_blocks(
            functools.partial(mamba_scan, chunk=chunk), args,
            (("B", None, "model"),) * 2 + (("model", None),)
            + (("B", None, None),) * 2 + (("model",), ("B", "model", None)),
            out_like=(0, 6))
    else:
        y, h_final = mamba_scan(*args, chunk=chunk)
    out = dense(y * F.silu(z), p["out_proj"])
    conv = torch.cat([conv_hist, x_in], dim=1)[:, t:]
    return out, {"conv": conv, "ssm": h_final}


def mamba_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step.  x: [B, 1, d]; the state is written in place and
    returned."""
    out, new = mamba_forward(p, x, cfg, chunk=1, state=state)
    for k, t in new.items():
        state[k].copy_(t)
    return out, state


def init_mamba_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device="cpu") -> Dict[str, torch.Tensor]:
    m: MambaConfig = cfg.mamba
    di = m.inner(cfg.d_model)
    return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                               device=device)}
