"""The loss on vocab-split logits (``models/layers.py:softmax_xent``,
``chunked_loss``): no tensor of the whole vocab and none of the global
batch on a rank.

* In a world of four gloo processes on ``(data=2, model=2)`` and
  ``(data=1, model=4)``: ``softmax_xent`` of [4, 6, 64] f32 logits (60
  real ids, 4 padded) split over ``model`` along the vocab and over
  ``data`` along the batch, weighted per position; ``chunked_loss`` of a
  [4, 32, 16] residual (batch over ``data``, sequence over ``model``) in
  chunks of 8 (each recomputed in the backward), tied and untied, the
  embeddings laid out by ``param_shardings``.  Loss and gradients against
  the port's unsharded functions and the JAX package's, under
  ``jax.grad``: within 1e-6 of the largest value.
* The unsharded functions are bit-equal, loss and gradients, to the
  formulas they had before the vocab-split path (kept below).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as j_layers
from repro_torch.launch import run_local_world
from repro_torch.models import layers

MESHES = [(2, 2), (1, 4)]
B, S, VP, VOCAB, D, SEQ, CHUNK = 4, 6, 64, 60, 16, 32, 8
TOL = 1e-6


def _inputs():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"logits": f(B, S, VP) * 3, "labels": rng.integers(
        0, VOCAB, (B, S)).astype(np.int64), "w": f(B, S),
        "h": f(B, SEQ, D), "embed": f(VP, D) * 0.5,
        "lm_head": f(D, VP) * 0.5,
        "seq_labels": rng.integers(0, VOCAB, (B, SEQ)).astype(np.int64)}


_WORLD = r"""
import json, sys
import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.dist import sharding as shd
from repro_torch.dist.policy import P
from repro_torch.launch import init_rank, make_mesh
from repro_torch.models import layers

rank, world, extra = init_rank("gloo")
x = {k: np.asarray(v) for k, v in json.loads(extra[0]).items()}
x["labels"] = x["labels"].astype(np.int64)
x["seq_labels"] = x["seq_labels"].astype(np.int64)
out = {}
for shape in json.loads(extra[1]):
    mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
    tag = "x".join(map(str, shape))
    lay = lambda a, spec: shd.shard_tensor(                # noqa: E731
        torch.from_numpy(a.astype(np.float32)), mesh, spec)
    lg = lay(x["logits"], P("data", None, "model")).requires_grad_()
    w = lay(x["w"], P("data", None))
    loss = layers.softmax_xent(lg, torch.from_numpy(x["labels"]), 60)
    (loss * w).sum().backward()
    out[f"{tag}/xent/loss"] = loss.full_tensor().tolist()
    out[f"{tag}/xent/grad"] = lg.grad.full_tensor().tolist()
    for tied in (True, False):
        h = lay(x["h"], P("data", "model", None)).requires_grad_()
        emb = {"embed": lay(x["embed"], P("model", "data")).requires_grad_()}
        if not tied:
            emb["lm_head"] = lay(x["lm_head"], P(None, "model")
                                 ).requires_grad_()
        total = layers.chunked_loss(h, emb, torch.from_numpy(
            x["seq_labels"]), 60, chunk=8)
        total.backward()
        key = f"{tag}/chunked/{'tied' if tied else 'untied'}"
        out[f"{key}/loss"] = float(total.full_tensor())
        out[f"{key}/h"] = h.grad.full_tensor().tolist()
        for k, t in emb.items():    # untied: the table is not used
            if t.grad is not None:
                out[f"{key}/{k}"] = t.grad.full_tensor().tolist()
print("RESULT " + json.dumps(out))
"""


def _port_whole(x):
    """The port's unsharded loss and gradients (plain tensors)."""
    out = {}
    lg = torch.from_numpy(x["logits"]).requires_grad_()
    loss = layers.softmax_xent(lg, torch.from_numpy(x["labels"]), VOCAB)
    (loss * torch.from_numpy(x["w"])).sum().backward()
    out["xent/loss"], out["xent/grad"] = loss.detach(), lg.grad
    for tied in (True, False):
        h = torch.from_numpy(x["h"]).requires_grad_()
        emb = {"embed": torch.from_numpy(x["embed"]).requires_grad_()}
        if not tied:
            emb["lm_head"] = torch.from_numpy(x["lm_head"]).requires_grad_()
        total = layers.chunked_loss(h, emb, torch.from_numpy(
            x["seq_labels"]), VOCAB, chunk=CHUNK)
        total.backward()
        key = f"chunked/{'tied' if tied else 'untied'}"
        out[f"{key}/loss"], out[f"{key}/h"] = total.detach(), h.grad
        out.update({f"{key}/{k}": t.grad for k, t in emb.items()
                    if t.grad is not None})
    return {k: np.asarray(v.detach().numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def _reference(x):
    """The JAX package's loss and gradients under ``jax.grad``."""
    out = {}
    labels = jnp.asarray(x["labels"], jnp.int32)

    def xent(lg):
        loss = j_layers.softmax_xent(lg, labels, VOCAB)
        return jnp.sum(loss * x["w"]), loss

    (_, loss), g = jax.value_and_grad(xent, has_aux=True)(x["logits"])
    out["xent/loss"], out["xent/grad"] = loss, g
    seq_labels = jnp.asarray(x["seq_labels"], jnp.int32)
    for tied in (True, False):
        emb = {"embed": x["embed"]}
        if not tied:
            emb["lm_head"] = x["lm_head"]
        total, (gh, ge) = jax.value_and_grad(
            lambda h, e: j_layers.chunked_loss(h, e, seq_labels, VOCAB,
                                               chunk=CHUNK),
            argnums=(0, 1))(x["h"], emb)
        key = f"chunked/{'tied' if tied else 'untied'}"
        out[f"{key}/loss"], out[f"{key}/h"] = total, gh
        out.update({f"{key}/{k}": v for k, v in ge.items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs():
    x = _inputs()
    outs = run_local_world(_WORLD, 4, args=[
        json.dumps({k: v.tolist() for k, v in x.items()}),
        json.dumps(MESHES)])
    ranks = [json.loads(o.split("RESULT ", 1)[1].splitlines()[0])
             for o in outs]
    return ranks, _port_whole(x), _reference(x)


KEYS = ["xent/loss", "xent/grad"] + [
    f"chunked/{t}/{k}" for t in ("tied", "untied") for k in ("loss", "h")] + [
    "chunked/tied/embed", "chunked/untied/lm_head"]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= TOL, err


@pytest.mark.parametrize("mesh", ["x".join(map(str, m)) for m in MESHES])
@pytest.mark.parametrize("key", KEYS)
def test_vocab_split_loss_matches_whole_vocab_and_reference(runs, mesh, key):
    ranks, whole, ref = runs
    for r in ranks:
        _close(r[f"{mesh}/{key}"], whole[key])
        _close(r[f"{mesh}/{key}"], ref[key])
    _close(whole[key], ref[key])


# --------------------------------------------------------------------------- #
# the unsharded loss, bit for bit as before the vocab-split path
# --------------------------------------------------------------------------- #
def _xent_before(logits, labels, vocab_size):
    v_pad = logits.shape[-1]
    logits = logits.to(torch.float32)
    if v_pad > vocab_size:
        pad = torch.arange(v_pad, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def _chunked_before(h, embeds, labels, vocab_size, chunk):
    b, s, _ = h.shape
    if s % chunk != 0 or s <= chunk:
        return torch.mean(_xent_before(layers.unembed(embeds, h), labels,
                                       vocab_size))
    total = torch.zeros((), dtype=torch.float32)
    for i in range(0, s, chunk):
        logits = layers.unembed(embeds, h[:, i:i + chunk])
        total = total + torch.sum(_xent_before(
            logits, labels[:, i:i + chunk], vocab_size))
    return total / (b * s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [CHUNK, SEQ])
def test_unsharded_loss_is_bit_equal_to_before(dtype, chunk):
    x = _inputs()
    grads = []
    for fn in (layers.chunked_loss, _chunked_before):
        h = torch.from_numpy(x["h"]).to(dtype).requires_grad_()
        emb = {"embed": torch.from_numpy(x["embed"]).to(dtype
                                                        ).requires_grad_()}
        loss = (fn(h, emb, torch.from_numpy(x["seq_labels"]), VOCAB,
                   chunk=chunk) if fn is layers.chunked_loss else
                fn(h, emb, torch.from_numpy(x["seq_labels"]), VOCAB, chunk))
        loss.backward()
        grads.append((loss.detach(), h.grad, emb["embed"].grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    lg = torch.from_numpy(x["logits"]).to(dtype)
    labels = torch.from_numpy(x["labels"])
    assert torch.equal(layers.softmax_xent(lg, labels, VOCAB),
                       _xent_before(lg, labels, VOCAB))
