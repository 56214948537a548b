"""Mesh-aware partition policy: which axis every tensor dim lives on
(``repro/dist/sharding.py``).

One rule table covers every config (``repro_torch/configs``): parameter
leaves are matched by their innermost dict key ("wq", "w_gate", ...) and
given a spec over their *trailing* dims, so the same rule applies whether
the leaf carries a stacked leading layer dim or not.

Conventions (DESIGN.md §2):

* ``model`` — tensor / expert parallel: column dims of up-projections,
  row dims of down-projections, vocab of the (un)embedding, the expert
  dim of MoE stacks, the sequence dim of decode caches and the residual.
* ``data`` (+ ``pod`` on multi-pod meshes) — the batch dim of inputs,
  plus FSDP-style sharding of the non-model dim of large weights; the
  MLfabric gradient path strips these entries back to replicated
  (``launch/steps.py``, DESIGN.md §3).

Every spec is a *hint* validated against the actual mesh: an axis that
does not evenly divide the corresponding dim is dropped (reduced smoke
configs, odd head counts), never erroring.

The rule functions take anything with ``axis_names`` and a ``shape``
mapping of axis name to size (a ``launch.mesh.Mesh``, a :class:`MeshShape`,
or :func:`mesh_view` of a ``DeviceMesh``) and return
:class:`~repro_torch.dist.policy.PartitionSpec` trees, so specs are computed
without a process group.  :func:`placements` turns a spec into DTensor
placements, and :func:`shard_slices` names the block of a leaf a rank
holds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeConfig
from ..tree import tree_flatten_with_path, tree_map, tree_unflatten
from .policy import P, PartitionSpec, _axis_size, _fit_spec

Params = Any


@dataclass(frozen=True)
class MeshShape:
    """The named shape of a mesh, without devices or process groups."""

    axis_names: Tuple[str, ...]
    shape: Mapping[str, int]


def mesh_view(device_mesh) -> MeshShape:
    """A ``DeviceMesh``'s named shape."""
    names = tuple(device_mesh.mesh_dim_names)
    return MeshShape(names, dict(zip(names, device_mesh.shape)))


# --------------------------------------------------------------------------- #
# mesh topology helpers
# --------------------------------------------------------------------------- #
def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch (and gradient reduction) spans."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_spec_axes(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    """Axes to shard the batch dim over, or None when nothing fits.

    Prefers the full ``(pod, data)`` hierarchy, falls back to ``data``
    alone when the batch is not divisible by the pod product (small eval
    batches on the multi-pod mesh).
    """
    for axes in (data_axes(mesh), ("data",)):
        if set(axes) <= set(mesh.axis_names) \
                and global_batch % _axis_size(mesh, tuple(axes)) == 0:
            return tuple(axes)
    return None


def head_policy(cfg: ModelConfig, mesh) -> bool:
    """True when attention heads split evenly over the model axis, i.e.
    head-parallel attention is available without padding/resharding."""
    m = mesh.shape.get("model", 1)
    heads = max(cfg.n_heads, 1)
    kv_heads = max(cfg.n_kv_heads, 1)
    return heads % m == 0 and kv_heads % m == 0


# --------------------------------------------------------------------------- #
# specs -> DTensor placements and per-rank blocks
# --------------------------------------------------------------------------- #
def _spec_axes(mesh, spec: PartitionSpec) -> Dict[int, Tuple[str, ...]]:
    """{tensor dim: the mesh axes that split it, major first}."""
    out = {}
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] = entry if isinstance(entry, tuple) else (entry,)
    return out


def placements(mesh, spec: PartitionSpec) -> list:
    """DTensor placements for ``spec``, one per mesh axis above 1 in
    ``mesh.axis_names`` order (the axes a ``launch.mesh.Mesh`` builds its
    ``DeviceMesh`` over; an axis of one splits nothing): ``Shard(d)`` on
    every axis that splits dim ``d``, ``Replicate()`` elsewhere.  A dim
    split over several axes (``("pod", "data")``) is ``Shard(d)`` on each;
    DTensor splits it over the mesh axes in mesh order, the first one
    major, which is JAX's order for the tuple when its axes come in mesh
    order.  Raises where they do not, or where one axis would split two
    dims."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    out: list = [Replicate() for _ in names]
    for dim, axes in _spec_axes(mesh, spec).items():
        idx = [names.index(a) for a in axes if mesh.shape[a] > 1]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in mesh "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]} splits two "
                                 "dims")
            out[i] = Shard(dim)
    return out


def shard_slices(mesh, spec: PartitionSpec, shape: Sequence[int],
                 coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The block of a ``shape`` leaf laid out by ``spec`` that the rank at
    ``coords`` (axis name -> index) holds: along a dim split over axes
    ``(a, b)`` block ``coords[a] * size[b] + coords[b]`` of ``size[a] *
    size[b]``, as :func:`placements` lays it out."""
    out = [slice(None)] * len(shape)
    for dim, axes in _spec_axes(mesh, spec).items():
        n = _axis_size(mesh, axes)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {axes}")
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coords[a]
        step = shape[dim] // n
        out[dim] = slice(i * step, (i + 1) * step)
    return tuple(out)


def on_axes(spec: PartitionSpec, names) -> PartitionSpec:
    """``spec`` with the axes not in ``names`` dropped (an entry left with
    none is None): a spec of the whole mesh on a DeviceMesh that lacks its
    axes of one, or on the model submesh."""
    out = []
    for entry in spec:
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a in names)
        out.append(None if entry is None or not kept else
                   kept if isinstance(entry, tuple) else kept[0])
    return P(*out)


def spec_shards(mesh, spec: PartitionSpec) -> int:
    """Number of blocks ``spec`` cuts a leaf into (1 when replicated)."""
    return math.prod(_axis_size(mesh, axes)
                     for axes in _spec_axes(mesh, spec).values())


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
_COL = ("data", "model")    # [d_in, d_out]: FSDP the input, TP the output
_ROW = ("model", "data")    # [d_in, d_out]: TP the input, FSDP the output
_EXP = ("model", "data", None)  # [E, d_in, d_out]: expert parallel + FSDP

_PARAM_RULES: Dict[str, Tuple] = {
    # embeddings
    "embed": ("model", "data"), "lm_head": _COL,
    # dense MLP
    "up": _COL, "gate": _COL, "down": _ROW,
    # attention (GQA) — wk/wv/wr/wg double as the RWKV projections
    "wq": _COL, "wk": _COL, "wv": _COL, "wg": _COL, "wr": _COL, "wo": _ROW,
    # MLA
    "q_down": _COL, "kv_down": _COL,
    "q_up": _COL, "k_up": _COL, "v_up": _COL,
    # mamba
    "in_x": _COL, "in_z": _COL, "x_proj": ("model", None), "dt_proj": _COL,
    "conv_w": (None, "model"), "a_log": ("model", None), "out_proj": _ROW,
    # rwkv extras
    "ts_down": _COL, "ts_up": (None, None, "model"),
    "wd_down": _COL, "wd_up": _COL,
    # MoE expert stacks; the router is tiny and stays replicated (f32)
    "w_gate": _EXP, "w_up": _EXP, "w_down": _EXP,
    "router": (None, None),
}


def _leaf_name(path: str) -> str:
    """The innermost dict key of a ``tree_flatten_with_path`` name: not a
    NamedTuple field (``.history``) and not a sequence index."""
    for entry in reversed(path.split("/")):
        if entry and not entry.startswith(".") and not entry.isdigit():
            return entry
    return ""


def _rule_sharding(mesh, rule: Tuple, shape: Tuple[int, ...]
                   ) -> PartitionSpec:
    rule = tuple(rule)[-len(shape):] if rule else ()
    spec = (None,) * (len(shape) - len(rule)) + rule
    return _fit_spec(mesh, P(*spec), shape)


def _map_with_path(fn, tree):
    named, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [fn(path, leaf) for path, leaf in named])


def param_shardings(cfg: ModelConfig, mesh, abstract: Params) -> Params:
    """Full-rank spec per param leaf, for every arch.

    ``abstract`` is a tree with the params' shapes (``models.api.
    params_specs``, or the params themselves); the result mirrors its
    structure leaf for leaf.
    """
    del cfg  # rules are name-based; the config shaped the abstract tree

    def one(path, leaf):
        rule = _PARAM_RULES.get(_leaf_name(path), ())
        return _rule_sharding(mesh, rule, tuple(leaf.shape))

    return _map_with_path(one, abstract)


def strip_data(spec: PartitionSpec) -> PartitionSpec:
    """``spec`` with its batch-axis entries replicated: the MLfabric step's
    params, sharded over ``model`` only (the reference's ``strip_data``)."""
    return P(*(None if e in ("data", "pod", ("pod", "data")) else e
               for e in spec))


def param_bytes_per_rank(cfg: ModelConfig, mesh, abstract: Params) -> int:
    """Bytes of ``abstract``'s leaves one rank holds under
    ``param_shardings`` (every leaf splits evenly: ``_fit_spec`` keeps only
    axes that divide)."""
    specs = param_shardings(cfg, mesh, abstract)
    return sum(leaf.numel() * leaf.element_size() // spec_shards(mesh, spec)
               for (_, leaf), (_, spec) in zip(
                   tree_flatten_with_path(abstract)[0],
                   tree_flatten_with_path(specs)[0]))


# --------------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------------- #
def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    batch_specs: Params) -> Params:
    """Batch-dim sharding for the model-input tree: dim 0 over the data
    hierarchy when it is the global batch, everything else replicated."""
    ba = batch_spec_axes(mesh, shape.global_batch)

    def one(leaf):
        if leaf.ndim and ba and leaf.shape[0] == shape.global_batch:
            return _fit_spec(mesh, P(ba, *([None] * (leaf.ndim - 1))),
                             tuple(leaf.shape))
        return P()

    return tree_map(one, batch_specs)


# --------------------------------------------------------------------------- #
# decode caches
# --------------------------------------------------------------------------- #
# Trailing-dim rules per cache leaf (after the leading stacked-layer dim);
# "B" marks the batch dim (-> data hierarchy), "model" the sequence (or
# state) dim per the cache layout contract in models/transformer.py.
_CACHE_RULES: Dict[str, Tuple] = {
    "k": ("B", "model", None, None), "v": ("B", "model", None, None),
    "k_q": ("B", "model", None, None), "v_q": ("B", "model", None, None),
    "k_s": ("B", "model", None), "v_s": ("B", "model", None),
    "ckv": ("B", "model", None), "krope": ("B", "model", None),
    "conv": ("B", None, "model"), "ssm": ("B", "model", None),
    "shift": ("B", None, "model"), "cm_shift": ("B", None, "model"),
    "wkv": ("B", "model", None, None),
    "cross_kv": ("B", "model", None, None),
}


def cache_leaf_spec(mesh, name: str, shape: Tuple[int, ...],
                    global_batch: int) -> PartitionSpec:
    """The spec of a cache leaf named ``name`` of ``shape``, stacked
    ``[L, ...]`` or one layer's: its rule over the trailing dims."""
    ba = batch_spec_axes(mesh, global_batch)
    rule = _CACHE_RULES.get(name, ("B",))
    rule = tuple(ba if e == "B" else e for e in rule) if ba else \
        tuple(None if e == "B" else e for e in rule)
    return _rule_sharding(mesh, rule, shape)


def cache_shardings(cfg: ModelConfig, mesh, cache_abs: Params,
                    global_batch: int) -> Params:
    del cfg  # rules are name-based

    def one(path, leaf):
        return cache_leaf_spec(mesh, _leaf_name(path), tuple(leaf.shape),
                               global_batch)

    return _map_with_path(one, cache_abs)


def to_cache_layout(t, name: str):
    """One layer's cache leaf ``t`` (a DTensor ``[B, S, ...]``, as the
    layer made it) laid out by ``cache_leaf_spec``, a leaf at a time, so
    that no rank ever holds more of the cache than its block: a dim split
    over ``model`` that the layout splits another way (the kv heads, where
    the cache splits the sequence) moves with one all-to-all over
    ``model``; every other change is DTensor's (a local slice where the
    leaf is replicated, as kv heads that do not divide ``model`` are)."""
    from torch.distributed.tensor import DTensor, Shard
    dm = t.device_mesh
    view = mesh_view(dm)
    want = placements(view, cache_leaf_spec(view, name, tuple(t.shape),
                                            t.shape[0]))
    mi = list(dm.mesh_dim_names).index("model")
    src, dst = t.placements[mi], want[mi]
    if not (isinstance(src, Shard) and isinstance(dst, Shard)
            and src.dim != dst.dim):
        return t.redistribute(dm, want)
    keep = [src if i == mi else pl for i, pl in enumerate(want)]
    local = _all_to_all(t.redistribute(dm, keep).to_local(), src.dim,
                        dst.dim, dm.get_group("model"), dm.size(mi))
    return DTensor.from_local(local, dm, want, run_check=False)


def _all_to_all(x, gather: int, split: int, group, n: int):
    """``x``, this rank's block along dim ``gather`` of a tensor split over
    ``group``'s ``n`` ranks, as its block along dim ``split``: x is cut
    into ``n`` pieces along ``split``, piece ``j`` goes to rank ``j``, and
    the pieces received are joined along ``gather`` in rank order."""
    import torch.distributed._functional_collectives as funcol
    pieces = x.unflatten(split, (n, x.shape[split] // n)).movedim(
        split, 0).contiguous()
    got = funcol.all_to_all_single(pieces, None, None, group)
    if isinstance(got, funcol.AsyncCollectiveTensor):
        got = got.wait()
    return got.movedim(0, gather).flatten(gather, gather + 1)


# --------------------------------------------------------------------------- #
# activations
# --------------------------------------------------------------------------- #
def activation_policy(cfg: ModelConfig, mesh,
                      global_batch: int) -> Dict[str, PartitionSpec]:
    """Named activation constraints for ``dist.policy.sharding_policy``.

    * ``residual`` [B, S, D]: batch over the data hierarchy, sequence over
      ``model`` (sequence parallel — norms act on the unsharded D).
    * ``logits``  [B, V]: vocab over ``model`` (the unembed matmul's
      natural output layout; the loss gathers per-token gold logits).
    """
    ba = batch_spec_axes(mesh, global_batch)
    b = ba if ba else None
    return {"residual": P(b, "model", None), "logits": P(b, "model")}


# --------------------------------------------------------------------------- #
# laying trees out on a mesh
# --------------------------------------------------------------------------- #
def shard_tensor(t, mesh, spec: PartitionSpec):
    """A DTensor on ``mesh.device_mesh`` laid out by ``spec``, made from
    ``t``, the whole tensor (or a numpy array), present on every rank:
    each rank keeps its own block (:func:`shard_slices`) on
    ``mesh.device``, with no collective.  The block owns its storage: a
    view would keep all of ``t`` alive."""
    import torch
    from torch.distributed.tensor import DTensor
    block = t[shard_slices(mesh, spec, tuple(t.shape), mesh.coords)]
    if not isinstance(block, torch.Tensor):
        block = torch.from_numpy(block.copy())
    block = block.contiguous().to(mesh.device)
    if isinstance(t, torch.Tensor) and (block.untyped_storage()._cdata
                                        == t.untyped_storage()._cdata):
        block = block.clone()
    return DTensor.from_local(block,
                              mesh.device_mesh, placements(mesh, spec),
                              run_check=False)


def shard_tree(tree, mesh, specs):
    """:func:`shard_tensor` leaf by leaf over a tree and its spec tree."""
    return tree_map(lambda t, s: shard_tensor(t, mesh, s), tree, specs)


def redistribute_tree(tree, mesh, specs):
    """Every DTensor leaf of ``tree`` laid out by its spec."""
    return tree_map(lambda t, s: t.redistribute(
        mesh.device_mesh, placements(mesh, s)), tree, specs)
