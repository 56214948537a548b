"""Step builders: the training, prefill and decode steps of
``repro/launch/steps.py`` over a :class:`~repro_torch.launch.mesh.Mesh`.

On a mesh without a ``model`` axis above 1, every rank of the mesh calls
the step with the same params, optimizer state and *global* batch; each
takes its own contiguous slice of the batch, in rank order (row-major over
``("pod", "data")``, as the reference's ``P(("pod", "data"))`` batch
sharding lays it out), and every rank ends with the same new params.
Params are replicated.  The serving steps issue no collective: each rank
prefills or decodes its own slice of the batch and keeps that slice's
logits and cache, as the reference's outputs are sharded over the batch.

On a mesh whose ``model`` axis is above 1 (tensor parallelism, ROADMAP
queue A item 3) the steps take and return DTensors on the mesh's
``DeviceMesh``, laid out as the reference's ``in_shardings`` and
``out_shardings`` lay its arrays out (``dist/sharding.py``): params and
optimizer state per ``param_shardings`` (FSDP over ``data``, tensor
parallel over ``model``; the MLfabric step strips the data entries),
caches per ``cache_shardings`` (the sequence over ``model``), logits with
the vocab over ``model``.  The batch is still the global batch on every
rank, as plain tensors; each rank keeps its block per
``batch_shardings``.  The forward runs under ``sharding_policy(mesh,
activation_policy(...))`` and under DTensor's ``implicit_replication``:
the plain tensors the model makes inside (rope tables, masks, the loss's
accumulator) are taken as replicated.  Attention runs on each rank's local
heads (``models/attention.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeConfig
from ..dist import sharding as shd
from ..dist.collectives import plan_reduce, reduce_packed, unpack_reduced
from ..dist.flatbuf import pack_leaves
from ..dist.policy import P, sharding_policy
from ..dist.sharding import data_axes
from ..models import transformer as tf
from ..models import api as model_api
from ..models.api import value_and_grad
from ..models.layers import is_dtensor
from ..models.moe import global_batch_stats
from ..obs.trace import region
from ..optim.sgd import (MomentumState, momentum_sgd_init,
                         momentum_sgd_update, momentum_sgd_update_)
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .mesh import Mesh
from .op_analysis import scope

Params = Any
Batch = Dict[str, torch.Tensor]


@dataclass
class StepBundle:
    """A step, the mesh it runs on, its abstract args and its donation.

    ``fn`` is the functional step (``fn(params, opt_state, batch) ->
    (params, opt_state, metrics)`` for training): it leaves its inputs as
    they are.  ``args`` are the reference's abstract args as ``meta``
    tensors of the global shapes (``models.api.params_specs``, the
    optimizer's init on them, ``input_specs``); the dry-run lays them out
    on the mesh.  ``donate_argnums`` are the reference's: params and
    history in training, the cache in decode.  :meth:`donating` is the
    counterpart of the reference's ``jitted()``: a call that honours the
    donation, updating the donated params and history in place
    (``optim.sgd.momentum_sgd_update_``, bit-equal to ``fn``) and
    returning them, the same tensors; the caller reads nothing of their
    old values after it.  Decode writes its cache in place in both; the
    reference's shardings have no counterpart here (DTensor leaves carry
    their own)."""

    fn: Callable
    mesh: Mesh
    args: Tuple = ()
    donate_argnums: Tuple[int, ...] = ()
    donating_fn: Optional[Callable] = None

    def donating(self) -> Callable:
        """The step with its donation honoured (``fn`` where it has none
        or where ``fn`` already writes in place)."""
        return self.donating_fn if self.donating_fn is not None else self.fn


def _train_bundle(step: Callable, mesh: Mesh, cfg: ModelConfig,
                  shape: ShapeConfig) -> StepBundle:
    """A training bundle of ``step(params, opt_state, batch, *, update)``:
    ``fn`` with the functional update (its default), the donating call
    with the in-place one."""
    params = model_api.params_specs(cfg)
    return StepBundle(
        fn=step, mesh=mesh,
        args=(params, momentum_sgd_init(params),
              model_api.input_specs(cfg, shape)),
        donate_argnums=(0, 1),
        donating_fn=functools.partial(step, update=momentum_sgd_update_))


def _local_batch(batch: Batch, mesh: Mesh, axes) -> Batch:
    """This rank's contiguous slice of the global batch, on its device."""
    n = math.prod(mesh.shape[a] for a in axes)
    size = next(iter(batch.values())).shape[0]
    if size % n:
        raise ValueError(f"global batch {size} does not split over {n} "
                         "ranks")
    b, i = size // n, mesh.index(axes)
    return {k: v[i * b:(i + 1) * b].to(mesh.device) for k, v in batch.items()}


def _split(batch: Batch, n: int):
    """``n`` equal consecutive slices of a batch."""
    size = next(iter(batch.values())).shape[0]
    b = size // n
    return [{k: v[c * b:(c + 1) * b] for k, v in batch.items()}
            for c in range(n)]


def _metrics_and_grads(params: Params, batch: Batch, cfg: ModelConfig,
                       remat: bool) -> Tuple[Dict[str, torch.Tensor], Params]:
    """(detached metrics, grads tree) of ``tf.loss_fn`` at ``params``."""
    with region("mlfabric.fwd_bwd"):
        (_, metrics), grads = value_and_grad(
            functools.partial(tf.loss_fn, cfg=cfg, remat=remat), params,
            batch, has_aux=True)
    return {k: v.detach() for k, v in metrics.items()}, grads


def _mean_over(t: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``t`` averaged over ``axes`` of the mesh, one all-reduce per axis
    (the reference's ``pmean``)."""
    t = t.reshape(1).clone()
    for a in axes:
        if mesh.shape[a] > 1:
            dist.all_reduce(t, group=mesh.groups[a])
            t = t / mesh.shape[a]
    return t.reshape(())


# --------------------------------------------------------------------------- #
# train
# --------------------------------------------------------------------------- #
def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
                     lr: float = 1e-3, gamma: float = 0.9,
                     remat: bool = True, microbatches: int = 1) -> StepBundle:
    """The "auto" step: gradients averaged over the whole world with one
    all-reduce per leaf, which is what GSPMD does implicitly in the
    reference.  The MoE load-balance loss is taken over the global batch
    (``models.moe.global_batch_stats``), as the reference takes it, and
    the reported ``loss`` and ``aux_loss`` are the global ones on every
    rank.  ``microbatches > 1`` accumulates in f32 the gradients of
    sequential slices of the global batch, as the reference cuts them:
    microbatch i is global rows ``[i B/m, (i+1) B/m)``, of which each rank
    takes its share."""
    if mesh.device_mesh is not None:
        return _sharded_train_step(cfg, shape, mesh, lr=lr, gamma=gamma,
                                   remat=remat, microbatches=microbatches)
    axes = data_axes(mesh)
    world = math.prod(mesh.shape[a] for a in axes)
    if shape.global_batch % (world * microbatches):
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {microbatches} microbatches on {world} ranks")

    def train_step(params, opt_state, batch, *, update=momentum_sgd_update):
        if microbatches == 1:
            with global_batch_stats(world):
                metrics, grads = _metrics_and_grads(
                    params, _local_batch(batch, mesh, axes), cfg, remat)
        else:
            grads = None
            loss = aux = 0.0
            for mb in _split(batch, microbatches):
                with global_batch_stats(world):
                    m, g = _metrics_and_grads(
                        params, _local_batch(mb, mesh, axes), cfg, remat)
                g = [x.to(torch.float32) for x in tree_leaves(g)]
                grads = g if grads is None else [a + b
                                                 for a, b in zip(grads, g)]
                loss, aux = loss + m["loss"], aux + m["aux_loss"]
            grads = tree_unflatten(tree_flatten(params)[1],
                                   [g / microbatches for g in grads])
            metrics = {"loss": loss / microbatches,
                       "aux_loss": aux / microbatches}
        if world > 1:
            with torch.no_grad():
                for g in tree_leaves(grads):
                    dist.all_reduce(g)
                    g.div_(world)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in tree_leaves(grads)))
        new_params, new_opt = update(params, grads, opt_state, lr=lr,
                                     gamma=gamma)
        loss = metrics["loss"]
        if world > 1:
            loss = _mean_over(loss, mesh, axes)
        return new_params, new_opt, {"loss": loss,
                                     "aux_loss": metrics["aux_loss"],
                                     "grad_norm": gnorm}

    return _train_bundle(train_step, mesh, cfg, shape)


# --------------------------------------------------------------------------- #
# train with the MLfabric gradient path (explicit scheduled collectives)
# --------------------------------------------------------------------------- #
def build_mlfabric_train_step(cfg: ModelConfig, shape: ShapeConfig,
                              mesh: Mesh, *, lr: float = 1e-3,
                              gamma: float = 0.9, remat: bool = True,
                              bucket_bytes: int = 4 * 2 ** 20,
                              shortest_first: bool = True,
                              compress_inter: bool = False,
                              overlap_chunks: int = 1) -> StepBundle:
    """Training step whose gradient reduction is the explicit MLfabric
    schedule (flat-bucketed, shortest-first, hierarchical, optionally int8
    across pods) of ``dist/collectives.py``.

    ``overlap_chunks > 1`` is the chunked backward: the local batch is split
    into chunks, and each chunk's buckets are issued as soon as its
    gradients exist, before the next chunk's backward; the per-bucket
    results are summed as flat vectors, divided by the chunk count and
    unpacked once.  Collective volume grows with the chunk count.

    As in the reference, ``grad_norm`` is 0 on this path, and the loss is
    averaged over the pod and data axes.
    """
    if mesh.device_mesh is not None:
        return _sharded_mlfabric_step(
            cfg, shape, mesh, lr=lr, gamma=gamma, remat=remat,
            bucket_bytes=bucket_bytes, shortest_first=shortest_first,
            compress_inter=compress_inter, overlap_chunks=overlap_chunks)
    axes = data_axes(mesh)
    inter = "pod" if "pod" in mesh.axis_names else None
    n_data_shards = math.prod(mesh.shape[a] for a in axes)
    if overlap_chunks < 1 or shape.global_batch % (n_data_shards
                                                   * overlap_chunks):
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {overlap_chunks} chunks on {n_data_shards} "
                         "ranks")
    reduce_kw = dict(mesh=mesh, intra_axis="data", inter_axis=inter,
                     compress_inter=compress_inter, mean_over=n_data_shards)

    calls = itertools.count()

    def train_step(params, opt_state, batch, *, update=momentum_sgd_update):
        with region("mlfabric.step", step=next(calls)):
            return _step(params, opt_state, batch, update)

    def _step(params, opt_state, batch, update):
        local = _local_batch(batch, mesh, axes)
        layout = plan_reduce(params, bucket_bytes=bucket_bytes,
                             shortest_first=shortest_first)
        reduced = None
        loss = aux = 0.0
        for chunk in _split(local, overlap_chunks):
            m, g = _metrics_and_grads(params, chunk, cfg, remat)
            with torch.no_grad():
                with region("mlfabric.pack"):
                    flat = pack_leaves(tree_leaves(g))   # the tree goes now
                del g
                with region("mlfabric.reduce"):
                    vecs = reduce_packed(flat, layout, **reduce_kw)
                del flat
                reduced = vecs if reduced is None else \
                    [r + v for r, v in zip(reduced, vecs)]
            loss, aux = loss + m["loss"], aux + m["aux_loss"]
        if overlap_chunks > 1:
            reduced = [r / overlap_chunks for r in reduced]
            loss, aux = loss / overlap_chunks, aux / overlap_chunks
        with region("mlfabric.unpack"):
            grads = unpack_reduced(reduced, layout, params)
        del reduced
        new_params, new_opt = update(params, grads, opt_state, lr=lr,
                                     gamma=gamma)
        loss = _mean_over(loss, mesh, ("data",) + ((inter,) if inter else ()))
        return new_params, new_opt, {
            "loss": loss, "aux_loss": aux,
            "grad_norm": torch.zeros((), dtype=torch.float32,
                                     device=mesh.device)}

    return _train_bundle(train_step, mesh, cfg, shape)


# --------------------------------------------------------------------------- #
# prefill and decode (serve_step)
# --------------------------------------------------------------------------- #
def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       mesh: Mesh) -> StepBundle:
    """``fn(params, batch) -> (last-position logits, cache)`` of this rank's
    slice of ``batch["tokens"]`` ([global batch, S])."""
    if mesh.device_mesh is not None:
        return _sharded_prefill_step(cfg, shape, mesh)
    axes = data_axes(mesh)

    def prefill_step(params, batch):
        return tf.prefill(params, _local_batch(batch, mesh, axes), cfg=cfg)

    return _serve_bundle(prefill_step, mesh, cfg, shape)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      mesh: Mesh, *, kv_int8: bool = False) -> StepBundle:
    """``fn(params, cache, tokens, pos) -> (logits, cache)``: one token for
    this rank's slice of ``tokens`` ([global batch, 1]) against this rank's
    cache (``init_cache`` of the local batch, bf16-typed or int8), written
    in place at ``pos``.  As in the reference, ``kv_int8`` only shapes the
    abstract cache of ``args``; the cache passed in decides the step."""
    if mesh.device_mesh is not None:
        return _sharded_decode_step(cfg, shape, mesh, kv_int8=kv_int8)
    axes = data_axes(mesh)

    def serve_step(params, cache, tokens, pos):
        local = _local_batch({"tokens": tokens}, mesh, axes)["tokens"]
        return tf.decode_step(params, cache, local, pos, cfg=cfg)

    return _serve_bundle(serve_step, mesh, cfg, shape, kv_int8=kv_int8)


def _serve_bundle(step: Callable, mesh: Mesh, cfg: ModelConfig,
                  shape: ShapeConfig, *, kv_int8: bool = False
                  ) -> StepBundle:
    """A prefill bundle (args: params, batch) or a decode bundle (args:
    params, cache, tokens, pos; the cache donated, as the step writes it
    in place)."""
    params = model_api.params_specs(cfg)
    specs = model_api.input_specs(cfg, shape, kv_int8=kv_int8)
    if shape.kind == "prefill":
        return StepBundle(fn=step, mesh=mesh, args=(params, specs))
    return StepBundle(fn=step, mesh=mesh,
                      args=(params, specs["cache"], specs["tokens"],
                            specs["pos"]),
                      donate_argnums=(1,))


# --------------------------------------------------------------------------- #
# the steps on a model axis: DTensors on the mesh's DeviceMesh
# --------------------------------------------------------------------------- #
def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    return t.full_tensor() if is_dtensor(t) else t


def _check_batch(batch: Batch, shape: ShapeConfig) -> None:
    size = next(iter(batch.values())).shape[0]
    if size != shape.global_batch:
        raise ValueError(f"batch of {size} rows; the step was built for "
                         f"the global batch {shape.global_batch}")


def _shard_batch(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                 batch: Batch) -> Batch:
    """The global batch as DTensors per ``batch_shardings``."""
    _check_batch(batch, shape)
    return shd.shard_tree(batch, mesh, shd.batch_shardings(cfg, shape, mesh,
                                                           batch))


@contextmanager
def _sharded_forward(mesh: Mesh, act):
    """The context a sharded step's forward runs in."""
    from torch.distributed.tensor.experimental import implicit_replication
    with sharding_policy(mesh, act), implicit_replication():
        yield


def _sharded_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
                        lr: float, gamma: float, remat: bool,
                        microbatches: int) -> StepBundle:
    """The "auto" step on a model axis: GSPMD's implicit reduction is
    DTensor's.  The global mean loss's gradients come back per leaf in
    whatever layout the backward gives, and are laid out as their params
    (a reduce-scatter over ``data`` for an FSDP leaf) before the update,
    which is then local to each rank."""
    if shape.global_batch % microbatches:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {microbatches} microbatches")
    act = shd.activation_policy(cfg, mesh, shape.global_batch)

    def train_step(params, opt_state, batch, *, update=momentum_sgd_update):
        _check_batch(batch, shape)
        grads, loss, aux = None, 0.0, 0.0
        for mb in _split(batch, microbatches):
            mb_shape = dataclasses.replace(
                shape, global_batch=shape.global_batch // microbatches)
            with _sharded_forward(mesh, act):
                m, g = _metrics_and_grads(
                    params, _shard_batch(cfg, mb_shape, mesh, mb), cfg,
                    remat)
            g = [gl.redistribute(p.device_mesh, p.placements)
                 for gl, p in zip(tree_leaves(g), tree_leaves(params))]
            if microbatches > 1:
                g = [gl.to(torch.float32) for gl in g]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss, aux = loss + _whole(m["loss"]), aux + _whole(m["aux_loss"])
        if microbatches > 1:
            grads = [g / microbatches for g in grads]
            loss, aux = loss / microbatches, aux / microbatches
        gnorm = _whole(torch.sqrt(sum(
            torch.sum(torch.square(g.to(torch.float32))) for g in grads)))
        grads = tree_unflatten(tree_flatten(params)[1], grads)
        new_params, new_opt = update(params, grads, opt_state, lr=lr,
                                     gamma=gamma)
        return new_params, new_opt, {"loss": loss, "aux_loss": aux,
                                     "grad_norm": gnorm}

    return _train_bundle(train_step, mesh, cfg, shape)


def _sharded_mlfabric_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                           *, lr: float, gamma: float, remat: bool,
                           bucket_bytes: int, shortest_first: bool,
                           compress_inter: bool,
                           overlap_chunks: int) -> StepBundle:
    """The MLfabric step on a model axis.  Params and history are laid out
    by ``param_shardings`` with the data entries stripped (replicated over
    the batch axes, sharded over ``model``).  Each rank runs the forward on
    its own slice of the batch over the ``model`` submesh alone, so its
    gradients are its own, unreduced over the batch axes (the reference's
    ``shard_map``, manual over them); ``dist/collectives.py`` then reduces
    them over ``(pod, data)``, among the ranks of one model index.

    * Uncompressed, the reduction is elementwise: each rank packs and
      reduces its own shard of every leaf.
    * Compressed, the int8 wire's 256-blocks span the logical flattening of
      each leaf, so each rank gathers its gradient's leaves over ``model``
      and reduces the whole tree, as the reference does, then keeps its
      shard: one whole gradient a rank (the unsharded step's size) on top
      of the sharded step's memory.

    The update is local to each rank."""
    from torch.distributed.tensor import DTensor
    axes = data_axes(mesh)
    inter = "pod" if "pod" in mesh.axis_names else None
    n_data_shards = math.prod(mesh.shape[a] for a in axes)
    if overlap_chunks < 1 or shape.global_batch % (n_data_shards
                                                   * overlap_chunks):
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {overlap_chunks} chunks on {n_data_shards} "
                         "ranks")
    reduce_kw = dict(mesh=mesh, intra_axis="data", inter_axis=inter,
                     compress_inter=compress_inter, mean_over=n_data_shards)
    # the activation policy without batch-axis entries (manual over them)
    act = {"residual": P(None, "model", None), "logits": P(None, "model")}
    sub = mesh.device_mesh["model"]
    model_dim = mesh.device_mesh.mesh_dim_names.index("model")

    def on_model(t):
        return DTensor.from_local(t.to_local(), sub, [t.placements[model_dim]],
                                  run_check=False)

    def train_step(params, opt_state, batch, *, update=momentum_sgd_update):
        local = _local_batch(batch, mesh, axes)
        p_sub = tree_map(on_model, params)
        sub_leaves = tree_leaves(p_sub)
        # the tree the flat layout is planned over: whole leaves for the
        # compressed wire, this rank's shards otherwise
        shapes = (params if compress_inter
                  else tree_map(lambda t: t.to_local(), params))
        layout = plan_reduce(shapes, bucket_bytes=bucket_bytes,
                             shortest_first=shortest_first)
        reduced = None
        loss = aux = 0.0
        for chunk in _split(local, overlap_chunks):
            with _sharded_forward(mesh, act):
                m, g = _metrics_and_grads(p_sub, chunk, cfg, remat)
            with torch.no_grad():
                g = [gl.redistribute(sub, s.placements)
                     for gl, s in zip(tree_leaves(g), sub_leaves)]
                g = [gl.full_tensor() if compress_inter else gl.to_local()
                     for gl in g]
                flat = pack_leaves(g)                # the tree goes now
                del g
                vecs = reduce_packed(flat, layout, **reduce_kw)
                del flat
                reduced = vecs if reduced is None else \
                    [r + v for r, v in zip(reduced, vecs)]
            loss = loss + _whole(m["loss"])
            aux = aux + _whole(m["aux_loss"])
        if overlap_chunks > 1:
            reduced = [r / overlap_chunks for r in reduced]
            loss, aux = loss / overlap_chunks, aux / overlap_chunks
        grads = unpack_reduced(reduced, layout, shapes)
        del reduced
        if compress_inter:
            grads = tree_map(lambda g, s: g[shd.shard_slices(
                mesh, s, tuple(g.shape), mesh.coords)], grads,
                tree_map(shd.strip_data, shd.param_shardings(cfg, mesh,
                                                             params)))
        loss = _mean_over(loss, mesh, ("data",) + ((inter,) if inter else ()))
        metrics = {"loss": loss, "aux_loss": aux,
                   "grad_norm": torch.zeros((), dtype=torch.float32,
                                            device=mesh.device)}
        local_p = tree_map(lambda t: t.to_local(), params)
        local_h = tree_map(lambda t: t.to_local(), opt_state.history)
        new_p, new_opt = update(local_p, grads, MomentumState(history=local_h),
                                lr=lr, gamma=gamma)
        rewrap = functools.partial(_like, mesh)
        return (tree_map(rewrap, new_p, params),
                MomentumState(history=tree_map(rewrap, new_opt.history,
                                               opt_state.history)),
                metrics)

    return _train_bundle(train_step, mesh, cfg, shape)


def _like(mesh: Mesh, local: torch.Tensor, ref) -> torch.Tensor:
    """``local`` as a DTensor laid out as ``ref``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              shape=ref.shape, stride=ref.stride(),
                              run_check=False)


def _sharded_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                          mesh: Mesh) -> StepBundle:
    """``fn(params, batch) -> (logits, cache)``: the global batch's
    last-position logits ([B, V_pad], the vocab over ``model``) and its
    cache laid out by ``cache_shardings``."""
    act = shd.activation_policy(cfg, mesh, shape.global_batch)

    def prefill_step(params, batch):
        with _sharded_forward(mesh, act):
            logits, cache = tf.prefill(
                params, _shard_batch(cfg, shape, mesh, batch), cfg=cfg)
        # the layers' leaves are laid out already, a layer at a time
        # (``transformer.CacheStack``); this moves whisper's ``cross_kv``
        with scope("cache"):
            cache = shd.redistribute_tree(cache, mesh, shd.cache_shardings(
                cfg, mesh, cache, shape.global_batch))
        return _logits_out(logits, mesh, shape), cache

    return _serve_bundle(prefill_step, mesh, cfg, shape)


def _logits_out(logits, mesh: Mesh, shape: ShapeConfig):
    """Logits laid out as the reference's ``out_shardings`` give them."""
    ba = shd.batch_spec_axes(mesh, shape.global_batch)
    spec = shd._fit_spec(mesh, P(ba if ba else None, "model"),
                         tuple(logits.shape))
    return logits.redistribute(mesh.device_mesh, shd.placements(mesh, spec))


def _sharded_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                         mesh: Mesh, *, kv_int8: bool) -> StepBundle:
    """``fn(params, cache, tokens, pos) -> (logits, cache)``: one token for
    the global batch (``tokens`` [B, 1], plain) against a cache laid out by
    ``cache_shardings``, written in place at ``pos`` on the rank holding
    that position; logits with the vocab over ``model``."""
    act = shd.activation_policy(cfg, mesh, shape.global_batch)

    def serve_step(params, cache, tokens, pos):
        ba = shd.batch_spec_axes(mesh, shape.global_batch)
        tok = shd.shard_tensor(tokens, mesh, shd._fit_spec(
            mesh, P(ba if ba else None, None), tuple(tokens.shape)))
        with _sharded_forward(mesh, act):
            logits, cache = tf.decode_step(params, cache, tok, pos, cfg=cfg)
        return _logits_out(logits, mesh, shape), cache

    return _serve_bundle(serve_step, mesh, cfg, shape, kv_int8=kv_int8)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               grad_path: str = "auto", **kw) -> StepBundle:
    if shape.kind == "train":
        if grad_path == "mlfabric":
            return build_mlfabric_train_step(cfg, shape, mesh, **kw)
        return build_train_step(cfg, shape, mesh, **kw)
    if shape.kind in ("prefill", "decode") and grad_path != "auto":
        raise ValueError(f"grad_path={grad_path!r} is a training option; "
                         f"{shape.kind} steps take none")
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, **kw)
    if shape.kind == "decode":
        return build_decode_step(cfg, shape, mesh, **kw)
    raise ValueError(shape.kind)
