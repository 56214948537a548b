"""Step builders: the training, prefill and decode steps of
``repro/launch/steps.py`` over a :class:`~repro_torch.launch.mesh.Mesh`.

Every rank of the mesh calls the step with the same params, optimizer
state and *global* batch; each takes its own contiguous slice of the batch,
in rank order (row-major over ``("pod", "data")``, as the reference's
``P(("pod", "data"))`` batch sharding lays it out), and every rank ends
with the same new params.  Params are replicated: there is no ``model``
axis yet (ROADMAP slice 5).  The serving steps issue no collective: each
rank prefills or decodes its own slice of the batch and keeps that slice's
logits and cache, as the reference's outputs are sharded over the batch.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeConfig
from ..dist.collectives import (plan_reduce, reduce_flat_buckets,
                                unpack_reduced)
from ..dist.sharding import data_axes
from ..models import transformer as tf
from ..models.api import value_and_grad
from ..optim.sgd import momentum_sgd_update
from ..tree import tree_flatten, tree_leaves, tree_unflatten
from .mesh import Mesh

Params = Any
Batch = Dict[str, torch.Tensor]


@dataclass
class StepBundle:
    """A step and the mesh it runs on.  The reference's bundle also carries
    abstract args, shardings and donation for ``jax.jit``; eager PyTorch
    has none of these, so ``fn(params, opt_state, batch) -> (params,
    opt_state, metrics)`` is called as it is."""

    fn: Callable
    mesh: Mesh


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
    (_, metrics), grads = value_and_grad(
        functools.partial(tf.loss_fn, cfg=cfg, remat=remat), params, batch,
        has_aux=True)
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
    reference.  ``microbatches > 1`` accumulates the gradients of
    sequential slices of each rank's batch in f32."""
    axes = data_axes(mesh)
    world = math.prod(mesh.shape[a] for a in axes)
    if shape.global_batch % (world * microbatches):
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {microbatches} microbatches on {world} ranks")

    def train_step(params, opt_state, batch):
        local = _local_batch(batch, mesh, axes)
        if microbatches == 1:
            metrics, grads = _metrics_and_grads(params, local, cfg, remat)
        else:
            grads = None
            loss = aux = 0.0
            for mb in _split(local, microbatches):
                m, g = _metrics_and_grads(params, mb, cfg, remat)
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
        new_params, new_opt = momentum_sgd_update(params, grads, opt_state,
                                                  lr=lr, gamma=gamma)
        loss = metrics["loss"]
        if world > 1:
            loss = _mean_over(loss, mesh, axes)
        return new_params, new_opt, {"loss": loss,
                                     "aux_loss": metrics["aux_loss"],
                                     "grad_norm": gnorm}

    return StepBundle(fn=train_step, mesh=mesh)


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

    def train_step(params, opt_state, batch):
        local = _local_batch(batch, mesh, axes)
        layout = plan_reduce(params, bucket_bytes=bucket_bytes,
                             shortest_first=shortest_first)
        reduced = None
        loss = aux = 0.0
        for chunk in _split(local, overlap_chunks):
            m, g = _metrics_and_grads(params, chunk, cfg, remat)
            with torch.no_grad():
                vecs = reduce_flat_buckets(g, layout, **reduce_kw)
                del g
                reduced = vecs if reduced is None else \
                    [r + v for r, v in zip(reduced, vecs)]
            loss, aux = loss + m["loss"], aux + m["aux_loss"]
        if overlap_chunks > 1:
            reduced = [r / overlap_chunks for r in reduced]
            loss, aux = loss / overlap_chunks, aux / overlap_chunks
        grads = unpack_reduced(reduced, layout, params)
        del reduced
        new_params, new_opt = momentum_sgd_update(params, grads, opt_state,
                                                  lr=lr, gamma=gamma)
        loss = _mean_over(loss, mesh, ("data",) + ((inter,) if inter else ()))
        return new_params, new_opt, {
            "loss": loss, "aux_loss": aux,
            "grad_norm": torch.zeros((), dtype=torch.float32,
                                     device=mesh.device)}

    return StepBundle(fn=train_step, mesh=mesh)


# --------------------------------------------------------------------------- #
# prefill and decode (serve_step)
# --------------------------------------------------------------------------- #
def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       mesh: Mesh) -> StepBundle:
    """``fn(params, batch) -> (last-position logits, cache)`` of this rank's
    slice of ``batch["tokens"]`` ([global batch, S])."""
    axes = data_axes(mesh)

    def prefill_step(params, batch):
        return tf.prefill(params, _local_batch(batch, mesh, axes), cfg=cfg)

    return StepBundle(fn=prefill_step, mesh=mesh)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      mesh: Mesh) -> StepBundle:
    """``fn(params, cache, tokens, pos) -> (logits, cache)``: one token for
    this rank's slice of ``tokens`` ([global batch, 1]) against this rank's
    cache (``init_cache`` of the local batch, bf16-typed or int8), written
    in place at ``pos``.  The reference's ``kv_int8`` flag only shapes the
    abstract cache it compiles for; here the cache passed in decides."""
    axes = data_axes(mesh)

    def serve_step(params, cache, tokens, pos):
        local = _local_batch({"tokens": tokens}, mesh, axes)["tokens"]
        return tf.decode_step(params, cache, local, pos, cfg=cfg)

    return StepBundle(fn=serve_step, mesh=mesh)


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
