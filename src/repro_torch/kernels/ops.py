"""Public wrappers for the port's kernels.

A tensor on the card goes to the hand-written CUDA kernel; a tensor on the
CPU goes to the kernel's plain PyTorch version (that is how the CPU tests
run); any other device raises.  There is no fallback: a CUDA tensor that the
kernel refuses raises.  Each wrapper counts its kernel launches in a plain
integer attribute, ``<wrapper>.launches``, so a run can show that its main
path went through the kernels.

A ``FakeTensor`` (under ``FakeTensorMode``, on any device; it holds no
data) goes to the kernel's shape rule instead: a ``torch.library`` custom
op ``repro_torch::<kernel>`` whose fake implementation gives outputs of
the kernel's shapes and dtypes, and whose real implementation is never
called.  A plain ``meta`` tensor is another device, and raises.  No kernel
runs there, so ``<wrapper>.launches`` does not move: the dry-run
(``launch/op_analysis.py``) sees each rule as one ``repro_torch::`` op with
its inputs and outputs, and counts those calls itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .dequant_aggregate import dequant_aggregate, dequant_aggregate_plain
from .flash_attention import flash_attention, flash_attention_plain
from .grad_aggregate import grad_aggregate, grad_aggregate_plain
from .quantize import (dequantize, dequantize_plain, quantize,
                       quantize_plain)
from .scatter_aggregate import scatter_aggregate, scatter_aggregate_plain
from .switch_sum import switch_sum, switch_sum_plain


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


KERNEL, PLAIN, SHAPE = "kernel", "plain", "shape"


def _route(t: torch.Tensor, what: str, *others: torch.Tensor) -> str:
    """``KERNEL``, ``PLAIN`` or ``SHAPE`` (the shape rule), by ``t``'s
    device and whether it is a ``FakeTensor``.  A DTensor among ``t`` and
    ``others`` raises: a kernel and its plain version take one rank's local
    tensors, and nothing here gathers a sharded one (the model hands the
    kernels its local shards, ``models/attention.py:blockwise_attention``)."""
    if any(_is_dtensor(x) for x in (t, *others)):
        raise TypeError(f"{what}: got a DTensor; pass this rank's local "
                        "tensors (DTensor.to_local())")
    if _is_fake(t):
        return SHAPE
    if t.is_cuda:
        return KERNEL
    if t.device.type == "cpu":
        return PLAIN
    raise ValueError(f"{what}: no kernel for device {t.device}")


# --------------------------------------------------------------------------- #
# shape rules: custom ops whose fake implementations give the kernels'
# outputs; only fake tensors reach them
# --------------------------------------------------------------------------- #
def _shape_rule(name: str, schema: str):
    """A custom op ``repro_torch::name`` of ``schema`` from a function whose
    body is the fake implementation (it only allocates outputs)."""
    def wrap(fake):
        def real(*args):
            raise RuntimeError(f"repro_torch::{name} is the {name} kernel's "
                               "shape rule; tensors with data go to the "
                               "kernel through kernels.ops")
        op = torch.library.custom_op(f"repro_torch::{name}", real,
                                     mutates_args=(), schema=schema)
        op.register_fake(fake)
        return op
    return wrap


@_shape_rule("quantize", "(Tensor x, int block) -> (Tensor, Tensor)")
def _quantize_shape(x: torch.Tensor, block: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((x.shape[0] // block,), dtype=torch.float32))


@_shape_rule("dequantize",
             "(Tensor q, Tensor scales, int block) -> Tensor")
def _dequantize_shape(q: torch.Tensor, scales: torch.Tensor,
                      block: int) -> torch.Tensor:
    return q.new_empty(q.shape, dtype=torch.float32)


@_shape_rule("dequant_aggregate", "(Tensor q, Tensor scales, Tensor weights, "
             "int block, int d_out) -> (Tensor, Tensor)")
def _dequant_aggregate_shape(q: torch.Tensor, scales: torch.Tensor,
                             weights: torch.Tensor, block: int, d_out: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (q.new_empty((d_out,), dtype=torch.float32),
            q.new_empty((), dtype=torch.float32))


@_shape_rule("grad_aggregate",
             "(Tensor updates, Tensor weights) -> (Tensor, Tensor)")
def _grad_aggregate_shape(updates: torch.Tensor, weights: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (updates.new_empty(updates.shape[1:]),
            updates.new_empty((), dtype=torch.float32))


@_shape_rule("switch_sum", "(Tensor q, int window, int d_out) -> Tensor")
def _switch_sum_shape(q: torch.Tensor, window: int, d_out: int
                      ) -> torch.Tensor:
    return q.new_empty((d_out,), dtype=torch.int32)


@_shape_rule("scatter_aggregate", "(Tensor idx, Tensor q, Tensor scales, "
             "Tensor weights, int d_out) -> (Tensor, Tensor)")
def _scatter_aggregate_shape(idx: torch.Tensor, q: torch.Tensor,
                             scales: torch.Tensor, weights: torch.Tensor,
                             d_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return (q.new_empty((d_out,), dtype=torch.float32),
            q.new_empty((), dtype=torch.float32))


@_shape_rule("flash_attention",
             "(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor")
def _flash_attention_shape(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool) -> torch.Tensor:
    return torch.empty_like(q)      # laid out as q is, as the kernel does


def _flash_flops(q_shape, k_shape, v_shape, causal, *, out_shape=None,
                 **kw) -> int:
    """Both products of the (q, k) pairs the kernel computes: under the
    causal mask only those at or below the diagonal, as its tiles skip the
    rest."""
    b, h, sq, d = q_shape
    skv = k_shape[2]
    pairs = (sum(max(0, min(skv, skv - sq + i + 1)) for i in range(sq))
             if causal else sq * skv)
    return 4 * b * h * d * pairs


def register_flop_formulas() -> None:
    """Teach ``torch.utils.flop_counter``'s registry the flash kernel's
    FLOPs (the only kernel with matmul work)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    op = torch.ops.repro_torch.flash_attention
    if op not in flop_registry:
        register_flop_formula(op)(_flash_flops)


def quantize_op(x: torch.Tensor, *, block: int = 256
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [D] -> (q int8 [D_pad], scales f32 [D_pad/block]); x is zero-padded
    to a ``block`` multiple first."""
    pad = (-x.shape[0]) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    route = _route(x, "quantize_op")
    if route == PLAIN:
        return quantize_plain(x, block=block)
    if route == SHAPE:
        return _quantize_shape(x, block)
    out = quantize(x.contiguous(), block=block)
    quantize_op.launches += 1
    return out


def dequantize_op(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256,
                  orig_len: Optional[int] = None) -> torch.Tensor:
    """Unfused decode of one int8 payload: q [D_pad], scales [D_pad/block]
    -> x f32 [orig_len or D_pad].  With ``orig_len`` the result is a view
    of the decoded buffer."""
    route = _route(q, "dequantize_op", scales)
    if route == PLAIN:
        x = dequantize_plain(q, scales, block=block)
    elif route == SHAPE:
        x = _dequantize_shape(q, scales, block)
    else:
        x = dequantize(q, scales, block=block)
        dequantize_op.launches += 1
    return x[:orig_len] if orig_len is not None else x


def compress_update(update_flat: torch.Tensor, *, block: int = 256
                    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], float]:
    """Round-trip helper of the PS path: ``((q, scales), ratio)``, the ratio
    being the update's bytes over the padded payload's and scales'."""
    q, s = quantize_op(update_flat, block=block)
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    return (q, s), nbytes(update_flat) / (nbytes(q) + nbytes(s))


def dequant_aggregate_op(q: torch.Tensor, scales: torch.Tensor,
                         weights: torch.Tensor, *, block: int = 256,
                         orig_len: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused receive path: int8 payloads [N, D_pad] -> dequantize ->
    weighted sum -> (agg f32 [orig_len or D_pad], ||agg||^2).  The unfused
    composition is ``dequantize_op`` per row, stacked, then
    ``grad_aggregate_op``, which writes and reads N decoded f32 copies."""
    route = _route(q, "dequant_aggregate_op", scales, weights)
    if route == PLAIN:
        return dequant_aggregate_plain(q, scales, weights, block=block,
                                       orig_len=orig_len)
    if route == SHAPE:
        return _dequant_aggregate_shape(
            q, scales, weights, block,
            orig_len if orig_len is not None else q.shape[1])
    out = dequant_aggregate(q, scales, weights, block=block,
                            orig_len=orig_len)
    dequant_aggregate_op.launches += 1
    return out


def grad_aggregate_op(updates: torch.Tensor, weights: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregator compute: updates [N, D] (f32 or bf16) -> weighted sum in
    f32 -> (agg [D] of updates' dtype, ||agg||^2 f32).  A ragged D is
    masked inside the kernel, with no pad copy."""
    route = _route(updates, "grad_aggregate_op", weights)
    if route == PLAIN:
        return grad_aggregate_plain(updates, weights)
    if route == SHAPE:
        return _grad_aggregate_shape(updates, weights)
    out = grad_aggregate(updates, weights)
    grad_aggregate_op.launches += 1
    return out


def switch_sum_op(q: torch.Tensor, *, window: int = 256,
                  orig_len: Optional[int] = None) -> torch.Tensor:
    """In-network switch aggregation: the pod's int8 payloads [N, D_pad]
    (one shared scale, D_pad a whole number of ``window`` slots) -> exact
    int32 sums [orig_len or D_pad]."""
    route = _route(q, "switch_sum_op")
    if route == PLAIN:
        return switch_sum_plain(q, window=window, orig_len=orig_len)
    if route == SHAPE:
        return _switch_sum_shape(
            q, window, orig_len if orig_len is not None else q.shape[1])
    out = switch_sum(q, window=window, orig_len=orig_len)
    switch_sum_op.launches += 1
    return out


def scatter_aggregate_op(idx: torch.Tensor, q: torch.Tensor,
                         scales: torch.Tensor, weights: torch.Tensor, *,
                         d_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse receive path of the bounded-loss tier: scatter-add N top-k
    int8 chunks (idx [N, K] int32, -1 = dropped slot) into the dense bucket
    -> (agg f32 [d_out], ||agg||^2), with no dense buffer per sender."""
    route = _route(idx, "scatter_aggregate_op", q, scales, weights)
    if route == PLAIN:
        return scatter_aggregate_plain(idx, q, scales, weights, d_out=d_out)
    if route == SHAPE:
        return _scatter_aggregate_shape(idx, q, scales, weights, d_out)
    out = scatter_aggregate(idx, q, scales, weights, d_out=d_out)
    scatter_aggregate_op.launches += 1
    return out


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, scale: Optional[float] = None,
                       block_q: int = 128, block_k: int = 128
                       ) -> torch.Tensor:
    """Forward attention, q [B, H, Sq, D] against k, v [B, KVH, Skv, D] ->
    [B, H, Sq, D] in q's dtype (the reference's ``flash_attention``
    arguments; ``block_q``/``block_k`` do not set the CUDA kernel's tiles).
    Forward only: it raises where autograd would record it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_op has no backward: the reference's Pallas "
            "flash kernel is forward-only and the port carries no backward "
            "kernel; call it under torch.no_grad() or on tensors that do not "
            "require grad (training takes the blockwise attention)")
    kw = dict(causal=causal, scale=scale, block_q=block_q, block_k=block_k)
    route = _route(q, "flash_attention_op", k, v)
    if route == PLAIN:
        return flash_attention_plain(q, k, v, **kw)
    if route == SHAPE:
        return _flash_attention_shape(q, k, v, causal)
    out = flash_attention(q, k, v, **kw)
    flash_attention_op.launches += 1
    return out


quantize_op.launches = 0
dequantize_op.launches = 0
dequant_aggregate_op.launches = 0
grad_aggregate_op.launches = 0
switch_sum_op.launches = 0
scatter_aggregate_op.launches = 0
flash_attention_op.launches = 0


# the oracles, re-exported as the reference does
flash_attention_ref = ref.flash_attention_ref
grad_aggregate_ref = ref.grad_aggregate_ref
quantize_ref = ref.quantize_ref
dequantize_ref = ref.dequantize_ref
scatter_aggregate_ref = ref.scatter_aggregate_ref
switch_sum_ref = ref.switch_sum_ref
