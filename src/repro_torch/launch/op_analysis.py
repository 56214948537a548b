"""Op-level analysis of one rank's step: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference reads the post-SPMD HLO of a compiled step and multiplies the
``while`` bodies of its scan over layers by their trip counts.  Eager
PyTorch has no HLO and no loop to multiply: every layer's ops run in turn.
So :class:`OpAnalysis`, a ``TorchDispatchMode``, counts the ops one rank
dispatches while a step is traced (on ``FakeTensor``s, which hold no data,
in the dry-run; on real tensors it counts the same):

* ``flops``: matmul and attention FLOPs from ``torch.utils.flop_counter``'s
  registry (the reference's dot FLOPs, ``hlo_analysis.py``), including the
  flash kernel's (``kernels.ops.register_flop_formulas``);
* ``bytes``: the bytes every op reads (its tensor inputs) and writes (its
  tensor outputs), views and metadata excepted: an unfused upper bound on
  HBM traffic, the counterpart of ``cost_analysis()["bytes accessed"]``;
* ``collective_by_kind``: the bytes this rank contributes to each
  collective (its operands, the reference's convention), in the
  reference's five kinds, from the c10d ops DTensor's functional
  collectives and ``torch.distributed`` issue;
* ``launches``: the port's kernels (``repro_torch::`` ops, the shape rules
  of ``kernels/ops.py``) by name;
* ``peak_bytes``: the most bytes held at once by the storages the step's
  arguments and its ops' outputs hold, each counted from its first sight
  until it is freed: the counterpart of argument plus temp bytes;
  ``peak_holders`` says which ops made them.

DTensor ops are not counted themselves: the mode defers them to DTensor,
whose local ops and collectives it then sees, so every number is one
rank's.  Nor are the ops DTensor runs on global-shape fake tensors to
infer an output's shape (its sharding propagation): they are no work of
the rank's.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d op -> (kind, index of the argument holding this rank's operands)
_COLLECTIVES = {
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::send": ("collective-permute", 0),
}

# ops that move no data: the bytes count skips them
_NO_TRAFFIC = {"aten::detach", "aten::alias", "aten::empty",
               "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided",
               "aten::_local_scalar_dense", "aten::lift_fresh",
               "_c10d_functional::wait_tensor",
               "_c10d_functional::_wrap_tensor_autograd"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x: Any) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(x) if isinstance(t, torch.Tensor))


def storages(tree: Any) -> Dict[int, torch.UntypedStorage]:
    """The storages ``tree``'s tensors hold (a DTensor's: its local
    shard's), by ``id``."""
    from torch.distributed.tensor import DTensor
    out = {}
    for t in _tensors(tree):
        st = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
        out[id(st)] = st
    return out


def _is_dtensor_type(t: type) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


class OpAnalysis(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collective bytes, kernel launches
    and peak live bytes while active (see the module note).  ``track(tree)``
    first counts tensors that are live before the step (its arguments).
    At each new peak it keeps the live bytes by the op that made them
    (``"argument"`` for those live before the step)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        from ..kernels.ops import register_flop_formulas
        register_flop_formulas()
        self._flop_registry = flop_registry
        self.flops = 0
        self.flops_by_op: Counter = Counter()
        self.bytes = 0
        self.collective_by_kind: Dict[str, int] = {}
        self.launches: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held: Dict[int, tuple] = {}     # id -> (bytes, made by)
        self.peak_holders: Dict[str, int] = {}
        self._shadow = 0             # inside DTensor's shape inference
        self._restore = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        infer = ShardingPropagator._propagate_tensor_meta_non_cached

        def shadowed(prop, op_schema):
            self._shadow += 1
            try:
                return infer(prop, op_schema)
            finally:
                self._shadow -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = shadowed
        self._restore = infer
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._restore
        return super().__exit__(*exc)

    # ------------------------------------------------------------------ #
    def track(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live from now until they are freed."""
        for st in storages(tree).values():
            self._hold_storage(st, "argument")

    def _hold(self, t: torch.Tensor, made_by: str) -> None:
        self._hold_storage(t.untyped_storage(), made_by)

    def _hold_storage(self, st: torch.UntypedStorage, made_by: str) -> None:
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = (n, made_by)
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            by: Counter = Counter()
            for nb, what in self._held.values():
                by[what] += nb
            self.peak_holders = dict(by.most_common())
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._held.pop(key, (0, None))[0]

    @property
    def collective_bytes(self) -> int:
        return sum(self.collective_by_kind.values())

    def summary(self) -> Dict[str, Any]:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": self.collective_bytes,
                "collective_by_kind": dict(self.collective_by_kind),
                "launches": dict(self.launches),
                "peak_bytes": self.peak_bytes,
                "peak_holders": dict(self.peak_holders),
                "flops_by_op": {k: float(v)
                                for k, v in self.flops_by_op.items()}}

    # ------------------------------------------------------------------ #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented    # DTensor runs it; its local ops count
        if self._shadow:
            return func(*args, **kwargs)
        for t in _tensors((args, kwargs)):
            self._hold(t, "argument")   # live before the step, seen now
        out = func(*args, **kwargs)
        name = func._schema.name
        if func.namespace == "repro_torch":
            self.launches[name.split("::", 1)[1]] += 1
        packet = func._overloadpacket
        if packet in self._flop_registry:
            n = self._flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_op[str(packet)] += n
        if name in _COLLECTIVES:
            kind, i = _COLLECTIVES[name]
            n = sum(_nbytes(t) for t in _tensors(args[i]))
            self.collective_by_kind[kind] = \
                self.collective_by_kind.get(kind, 0) + n
        if not (func.is_view or name in _NO_TRAFFIC
                or func.namespace == "prim"):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._hold(t, str(packet))
        return out
