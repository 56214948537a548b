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
  ``peak_holders`` says which ops made them;
* ``scope_peaks``: for the ops run inside a :func:`scope` (the decode
  cache's layout runs in ``scope("cache")``), the most bytes each op's
  storages held at once at any time, keyed ``"{scope}/{op}"``.

* ``ops``: every op counted, keyed ``"{op} {operands}"`` (the overload
  and each tensor operand's dtype and shape), with its count, FLOPs and
  bytes: the op listing the dry-run writes (:func:`op_listing`), the
  counterpart of the reference's HLO text.

DTensor ops are not counted themselves: the mode defers them to DTensor,
whose local ops and collectives it then sees, so every number is one
rank's.  Nor are the ops DTensor runs on global-shape tensors to choose a
sharding, which are no work of the rank's: while one of
:data:`SHADOWED` runs, its ops run uncounted.  They are the two places in
``torch/distributed/tensor/_sharding_prop.py`` (torch 2.11 and 2.13)
where DTensor runs ops on tensors of the global shape: the shape
inference of every op's output, on fake tensors
(``ShardingPropagator._propagate_tensor_meta_non_cached``), and, for an
op without a sharding rule of its own (``softplus_backward``), the
search through its decomposition for one, on ``meta`` tensors
(``DecompShardingStrategy.propagate_strategy``; a static method in 2.11).
Both run only where DTensor's sharding cache misses, so a count that took
them in would also hang on what the process had traced before.
"""

from __future__ import annotations

import contextlib
import importlib
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


# (module, class, method) of each of DTensor's searches over global-shape
# tensors (see the module note)
SHADOWED = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor._decompositions", "DecompShardingStrategy",
     "propagate_strategy"),
)

_SCOPES: list = []


@contextlib.contextmanager
def scope(name: str):
    """The ops run inside are ``name``'s: :class:`OpAnalysis` names the
    storages they make ``"{name}/{op}"`` and keeps the most each held at
    once (``scope_peaks``).  Outside a trace it only marks the stack."""
    _SCOPES.append(name)
    try:
        yield
    finally:
        _SCOPES.pop()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x: Any) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(x) if isinstance(t, torch.Tensor))


def _op_tensors(x: Any, into: list) -> list:
    """The tensors of an op's arguments or outputs (in lists, tuples and
    dicts), in ``_tensors``' order, appended to ``into``: every op of a
    trace walks them, and the general pytree walk was the larger part of
    this mode's own cost."""
    if isinstance(x, torch.Tensor):
        into.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _op_tensors(y, into)
    elif isinstance(x, dict):
        for y in x.values():
            _op_tensors(y, into)
    return into


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


def _key_text(key: tuple) -> str:
    """``"{overload} {dtype}[{shape}] ..."`` of an ``OpAnalysis`` key."""
    func, operands = key
    return " ".join([str(func)] + [
        f"{str(dtype).replace('torch.', '')}[{','.join(map(str, shape))}]"
        for dtype, shape in operands])


def op_listing(ops: Dict[str, list], title: str = "") -> str:
    """The text of an op listing: ``title`` as a ``#`` line, a header, one
    line per key of ``ops`` (``OpAnalysis.ops``), largest FLOPs first and
    then largest bytes, and a ``total`` line whose FLOPs and bytes are
    ``OpAnalysis.flops`` and ``bytes``."""
    rows = sorted(ops.items(), key=lambda kv: (-kv[1][1], -kv[1][2], kv[0]))
    total = [sum(v[i] for _, v in rows) for i in range(3)]
    lines = [f"# {title}"] if title else []
    lines.append(f"# {'flops':>20} {'bytes':>16} {'count':>8} op operands")
    lines += [f"{f:>22} {b:>16} {n:>8} {key}" for key, (n, f, b) in rows]
    lines.append(f"total {total[1]} {total[2]} {total[0]}")
    return "\n".join(lines) + "\n"


def read_op_listing(text: str) -> Dict[str, Any]:
    """An op listing's rows ``{key: [count, flops, bytes]}`` and its
    ``total`` line's ``flops``, ``bytes`` and ``count``."""
    rows, total = {}, None
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        if line.startswith("total "):
            f, b, n = (int(x) for x in line.split()[1:])
            total = {"flops": f, "bytes": b, "count": n}
            continue
        f, b, n, key = line.split(None, 3)
        rows[key] = [int(n), int(f), int(b)]
    return {"rows": rows, "total": total}


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
        self._scope_live: Counter = Counter()
        self.scope_peaks: Dict[str, int] = {}
        self._ops: Dict[tuple, list] = {}  # key -> [count, flops, bytes]
        self._shadow = 0             # inside one of SHADOWED
        self._restore: list = []

    def _shadowing(self, method):
        def shadowed(*args, **kwargs):
            self._shadow += 1
            try:
                return method(*args, **kwargs)
            finally:
                self._shadow -= 1
        return shadowed

    def __enter__(self):
        for module, name, attr in SHADOWED:
            cls = getattr(importlib.import_module(module), name)
            self._restore.append((cls, attr, cls.__dict__[attr]))
            setattr(cls, attr, self._shadowing(getattr(cls, attr)))
        return super().__enter__()

    def __exit__(self, *exc):
        while self._restore:
            cls, attr, raw = self._restore.pop()
            setattr(cls, attr, raw)
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
        if "/" in made_by:
            self._scope_live[made_by] += n
            self.scope_peaks[made_by] = max(self.scope_peaks.get(made_by, 0),
                                            self._scope_live[made_by])
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            by: Counter = Counter()
            for nb, what in self._held.values():
                by[what] += nb
            self.peak_holders = dict(by.most_common())
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        n, made_by = self._held.pop(key, (0, ""))
        self.live_bytes -= n
        if "/" in made_by:
            self._scope_live[made_by] -= n

    @property
    def ops(self) -> Dict[str, list]:
        """``[count, flops, bytes]`` of each op counted, keyed by its
        overload and its tensor operands' dtypes and shapes."""
        return {_key_text(k): list(v) for k, v in self._ops.items()}

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
                "scope_peaks": dict(self.scope_peaks),
                "flops_by_op": {k: float(v)
                                for k, v in self.flops_by_op.items()},
                "ops": self.ops}

    # ------------------------------------------------------------------ #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented    # DTensor runs it; its local ops count
        if self._shadow:
            return func(*args, **kwargs)
        ins = _op_tensors((args, kwargs), [])
        for t in ins:
            self._hold(t, "argument")   # live before the step, seen now
        out = func(*args, **kwargs)
        outs = _op_tensors(out, [])
        name = func._schema.name
        if func.namespace == "repro_torch":
            self.launches[name.split("::", 1)[1]] += 1
        packet = func._overloadpacket
        flops = moved = 0
        if packet in self._flop_registry:
            flops = self._flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += flops
            self.flops_by_op[str(packet)] += flops
        if name in _COLLECTIVES:
            kind, i = _COLLECTIVES[name]
            n = sum(_nbytes(t) for t in _op_tensors(args[i], []))
            self.collective_by_kind[kind] = \
                self.collective_by_kind.get(kind, 0) + n
        if not (func.is_view or name in _NO_TRAFFIC
                or func.namespace == "prim"):
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                       for t in outs)
            self.bytes += moved
        key = (func, tuple((t.dtype, tuple(t.shape)) for t in ins))
        rec = self._ops.setdefault(key, [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += moved
        made_by = f"{_SCOPES[-1]}/{packet}" if _SCOPES else str(packet)
        for t in outs:
            self._hold(t, made_by)
        return out
