"""Learning-rate schedules, including MiniCPM's WSD (warmup-stable-decay)
and the paper's step-decay (ResNet-style /10 at fixed epochs).

The reference computes every schedule in f32 ``jnp`` ops, one op at a
time (``repro/optim/schedule.py``), and the training CLI hands the f32
value to the optimizer and, through ``float(lr)``, to the replica's norm.
These do the same arithmetic on 0-d f32 tensors, constant by constant, so
the learning rates are the reference's bit for bit.  The one op that needs
care is the cosine: ``jnp.cos`` on the CPU calls glibc's ``cosf``, which
evaluates a double-precision polynomial and so differs from PyTorch's f32
cosine in the last bit now and then; ``_cosf`` is that routine.

A schedule takes one step (an int or a 0-d tensor) and returns a 0-d f32
tensor on the CPU.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32)


def _step(step) -> torch.Tensor:
    s = torch.as_tensor(step).detach().cpu()
    if s.dim() != 0:
        raise ValueError(f"a schedule takes one step, got shape "
                         f"{tuple(s.shape)}")
    return s


# glibc's sincosf table (the first half; the second negates the cosine
# coefficients), for |x| < 120, the range a schedule's cosine sees
_HPI_INV = float.fromhex("0x1.45F306DC9C883p-1")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
      float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"),
      float.fromhex("0x1.99343027bf8c3p-16"))
_S = (float.fromhex("-0x1.555545995a603p-3"),
      float.fromhex("0x1.1107605230bc4p-7"),
      float.fromhex("-0x1.994eb3774cf24p-13"))
_PIO4 = float(np.float32(math.pi / 4))


def _poly(x: float, x2: float, odd: bool, neg: bool) -> float:
    if not odd:
        x3 = x * x2
        s1 = _S[1] + x2 * _S[2]
        return (x + x3 * _S[0]) + (x3 * x2) * s1
    c = [-v for v in _C] if neg else _C
    x4 = x2 * x2
    c2 = c[3] + x2 * c[4]
    c1 = c[0] + x2 * c[1]
    return (c1 + x4 * c[2]) + (x4 * x2) * c2


def _cosf(y: float) -> float:
    """cos of an f32 value, rounded to f32, as glibc's ``cosf`` gives it."""
    x = float(np.float32(y))
    if abs(x) >= 120.0:
        raise ValueError(f"_cosf covers |x| < 120, got {x}")
    if abs(x) < _PIO4:
        if abs(x) < 2.0 ** -12:
            return 1.0
        return float(np.float32(_poly(x, x * x, True, False)))
    n = round(x * _HPI_INV)
    x = x - n * _HPI
    sign = (1.0, -1.0, -1.0, 1.0)[n & 3]
    return float(np.float32(_poly(x * sign, x * x, bool((n ^ 1) & 1),
                                  bool(n & 2))))


def constant_lr(lr: float) -> Callable:
    return lambda step: _f32(lr)


def wsd_schedule(peak_lr: float, warmup: int, stable: int,
                 decay: int, *, min_ratio: float = 0.1) -> Callable:
    """MiniCPM WSD: linear warmup -> constant -> exponential-ish decay."""
    def fn(step):
        s = _step(step).to(_F32)
        warm = _f32(peak_lr) * torch.minimum(s / _f32(max(warmup, 1)),
                                             _f32(1.0))
        in_decay = torch.clamp((s - _f32(warmup) - _f32(stable))
                               / _f32(max(decay, 1)), 0.0, 1.0)
        factor = torch.pow(_f32(min_ratio), in_decay)
        return torch.where(s < _f32(warmup + stable), warm,
                           _f32(peak_lr) * factor)
    return fn


def cosine_schedule(peak_lr: float, warmup: int, total: int, *,
                    min_ratio: float = 0.1) -> Callable:
    def fn(step):
        s = _step(step).to(_F32)
        warm = _f32(peak_lr) * torch.minimum(s / _f32(max(warmup, 1)),
                                             _f32(1.0))
        t = torch.clamp((s - _f32(warmup)) / _f32(max(total - warmup, 1)),
                        0.0, 1.0)
        cos_t = _f32(_cosf(_f32(math.pi) * t))
        cos = _f32(min_ratio) + _f32((1 - min_ratio) * 0.5) * (_f32(1.0)
                                                              + cos_t)
        return torch.where(s < _f32(warmup), warm, _f32(peak_lr) * cos)
    return fn


def step_decay_schedule(base_lr: float, boundaries: Sequence[int],
                        factor: float = 0.1) -> Callable:
    """The paper's deep-learning schedule: /10 at epochs 30/60/90 (§7.1)."""
    def fn(step):
        s = _step(step)
        mult = _f32(1.0)
        for b in boundaries:
            mult = torch.where(s >= b, mult * _f32(factor), mult)
        return _f32(base_lr) * mult
    return fn
