"""RWKV6 ("Finch") time mix and channel mix: the reference's
``repro/models/rwkv.py`` in PyTorch.

Per head, with the state S [Dk, Dv]::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (diag(u) k_t^T v_t + S_{t-1})

evaluated in time chunks of ``chunk`` (32) tokens in f32, as the reference
does: inside a chunk the quadratic form ``A[t, s] = (r_t P_{t-1} / P_s) .
k_s`` (P the running product of the decays) is built at [chunk, chunk]
size, and the state is carried from chunk to chunk.  The reference scans
its chunk function over the chunks; everything in it but the state's own
recurrence depends on one chunk's inputs only, so here ``_wkv_chunk``
computes those parts for every chunk at once and only ``S_{c+1} =
diag(P_c) S_c + K_c^T V_c`` runs as a loop over the chunks (one fused
multiply-add each).  The arithmetic is the reference's term for term,
``1/P`` factors included, which is why the chunks stay short.

Token shift (the Finch ddlerp) mixes each token with the one before it
through a 5-way data-dependent interpolation with a low-rank adapter.
The channel mix is the RWKV FFN: token shift and a squared ReLU.  Decode
is the time mix with ``chunk=1`` from the state ``{shift, wkv}``, the
channel mix from ``{cm_shift}``; the decode functions write the new state
into the state tensors in place.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, RWKVConfig
from .layers import (Params, activation, dense, dense_init, draw_device,
                     is_dtensor, local_zeros, normal, on_local_blocks,
                     whole_last_dim, whole_rows)


def _uniform(gen: torch.Generator, shape, scale: float, shift: float, *,
             dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    x = torch.rand(tuple(shape), generator=gen, device=draw_device(gen))
    return (x * scale + shift).to(device=device, dtype=dtype)


def init_rwkv(gen: torch.Generator, cfg: ModelConfig, n: int, *,
              dtype: torch.dtype, device: torch.device) -> Params:
    """``n`` stacked layers' time-mix params, the reference's
    distributions; the decay base ``w_base`` and the bonus ``u`` are f32."""
    r: RWKVConfig = cfg.rwkv
    d, lo = cfg.d_model, r.tokenshift_lora
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu_x": _uniform(gen, (n, 5, d), 0.5, 0.0, **kw),
        "ts_down": dense_init(gen, (n, d, 5 * lo), **kw),
        "ts_up": normal(gen, (n, 5, lo, d), 0.01, **kw),
        "wr": dense_init(gen, (n, d, d), **kw),
        "wk": dense_init(gen, (n, d, d), **kw),
        "wv": dense_init(gen, (n, d, d), **kw),
        "wg": dense_init(gen, (n, d, d), **kw),
        "wo": dense_init(gen, (n, d, d),
                         scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
        "w_base": _uniform(gen, (n, d), 2.0, -6.0, **f32),
        "wd_down": dense_init(gen, (n, d, r.decay_lora), **kw),
        "wd_up": dense_init(gen, (n, r.decay_lora, d), **kw),
        "u": normal(gen, (n, d), 0.1, **f32),
        "ln_x_scale": torch.ones((n, d), **kw),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """[B, T, d] -> the previous token's [B, T, d] (prev: [B, 1, d], the
    token before x)."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Finch's data-dependent lerp -> [5, B, T, d] mixed inputs (r, k, v,
    w, g)."""
    delta = xx - x
    base = x[None] + delta[None] * p["mu_x"][:, None, None, :]
    b, t, _ = x.shape
    # the 5 mixes' adapters side by side: whole over ``model`` before they
    # are told apart (5 * 32 split over 2 or 4 holds no whole mix)
    lora = torch.tanh(whole_last_dim(dense(x, p["ts_down"])).reshape(
        b, t, 5, -1))
    adj = torch.einsum("btnl,nld->nbtd", lora, p["ts_up"].to(x.dtype))
    return base + adj * delta[None]


def _wkv_chunk(r, k, v, w, u, s0):
    """The reference's chunk function for every chunk at once.

    r, k, v, w: [B, H, n, T, D] (n chunks of T tokens; w the per-step decay
    in (0, 1)), f32; u: [H, D]; s0: [B, H, Dk, Dv], the state before the
    first chunk.  Returns (y [B, H, n, T, D], the state after the last)."""
    logw = torch.log(torch.clamp_min(w, 1e-8))
    logp = torch.cumsum(logw, dim=-2)                      # log P_t
    p_t = torch.exp(logp)
    rp = r * torch.exp(logp - logw)                        # r_t P_{t-1}
    k_div = k * torch.exp(-logp)                           # k_s / P_s
    t = r.shape[-2]
    att = torch.einsum("bhntd,bhnsd->bhnts", rp, k_div)
    att = att.masked_fill(
        ~torch.ones((t, t), dtype=torch.bool, device=r.device).tril(-1), 0.0)
    diag = torch.einsum("bhntd,bhntd->bhnt", r * u[None, :, None, None], k)
    # the carried state: S_{c+1} = diag(P_c at its end) S_c + sum_s
    # (k_s P_T / P_s)^T v_s
    decay = p_t[..., -1, :, None]                          # [B,H,n,Dk,1]
    kv = torch.einsum("bhnsd,bhnse->bhnde", k_div * p_t[..., -1:, :], v)
    states = [s0]
    for c in range(r.shape[2]):
        states.append(decay[:, :, c] * states[-1] + kv[:, :, c])
    y_state = torch.einsum("bhntd,bhnde->bhnte", rp,
                           torch.stack(states[:-1], dim=2))
    y = y_state + torch.einsum("bhnts,bhnse->bhnte", att, v) \
        + diag[..., None] * v
    return y, states[-1]


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[Dict[str, torch.Tensor]] = None,
                  chunk: int = 32
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Finch time mix over [B, T, d], from ``state`` ({shift, wkv}) or
    zeros.  Returns (out, the state after the last token)."""
    r_cfg: RWKVConfig = cfg.rwkv
    b, t, d = x.shape
    h, hd = r_cfg.n_heads(d), r_cfg.head_dim
    x = whole_rows(x)           # the token shift and the chunks need it
    if state is None:
        # laid out as x and the scan take them: a rank's block only
        prev_x = local_zeros(x, (b, 1, d), ("B", None, None), x.dtype)
        s0 = local_zeros(x, (b, h, hd, hd), ("B", "model", None, None),
                         torch.float32)
    else:
        prev_x, s0 = state["shift"], state["wkv"]

    mr, mk, mv, mw, mg = _ddlerp(p, x, _token_shift(x, prev_x))
    tc = min(chunk, t)
    if t % tc:
        raise ValueError(f"sequence {t} is not a multiple of the chunk {tc}")

    def chunks(z):  # [B, T, d] -> [B, H, n, tc, D] f32
        return z.reshape(b, t // tc, tc, h, hd).permute(0, 3, 1, 2, 4).to(
            torch.float32)

    w_log = p["w_base"] + dense(torch.tanh(dense(mw, p["wd_down"])),
                                p["wd_up"]
                           ).to(torch.float32)
    w = torch.exp(-torch.exp(w_log))                       # decay in (0, 1)
    args = (chunks(dense(mr, p["wr"])), chunks(dense(mk, p["wk"])),
            chunks(dense(mv, p["wv"])), chunks(w), p["u"].reshape(h, hd), s0)
    if is_dtensor(x):
        # each rank's batch rows and heads
        y, s_final = on_local_blocks(
            _wkv_chunk, args, (("B", "model", None, None, None),) * 4
            + (("model", None), ("B", "model", None, None)), out_like=(0, 5))
    else:
        y, s_final = _wkv_chunk(*args)
    y = y.reshape(b, h, t, hd)
    # per-head group norm, then the gate
    mean = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = y.transpose(1, 2).reshape(b, t, d).to(x.dtype) * p["ln_x_scale"]
    out = dense(y * F.silu(dense(mg, p["wg"])), p["wo"])
    return out, {"shift": x[:, -1:], "wkv": s_final}


def rwkv_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token time mix; ``state["shift"]`` and ``state["wkv"]`` are
    written in place."""
    out, new = rwkv_time_mix(p, x, cfg, state=state, chunk=1)
    for k, t in new.items():
        state[k].copy_(t)
    return out, state


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device="cpu") -> Dict[str, torch.Tensor]:
    r = cfg.rwkv
    h = r.n_heads(cfg.d_model)
    return {"shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                 device=device),
            "wkv": torch.zeros((batch, h, r.head_dim, r.head_dim),
                               dtype=torch.float32, device=device)}


# --------------------------------------------------------------------------- #
# channel mix: the RWKV FFN, token shift and squared ReLU
# --------------------------------------------------------------------------- #
def init_channel_mix(gen: torch.Generator, cfg: ModelConfig, n: int, *,
                     dtype: torch.dtype, device: torch.device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {"mu": _uniform(gen, (n, d), 0.5, 0.0, **kw),
            "wk": dense_init(gen, (n, d, f), **kw),
            "wv": dense_init(gen, (n, f, d), **kw)}


def channel_mix(p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (out, {"cm_shift": the last token})."""
    x = whole_rows(x)
    prev = state["cm_shift"] if state is not None \
        else torch.zeros_like(x[:, :1])
    mixed = x + (_token_shift(x, prev) - x) * p["mu"]
    k = activation("relu_sq")(dense(mixed, p["wk"]))
    return dense(k, p["wv"]), {"cm_shift": x[:, -1:]}
