"""The port's dense decoder against the JAX package's, at converted params.

The reduced qwen2-0.5b is built in f32 in JAX, its params go through numpy
into the port, and both packages compute the loss and its gradient on the
same ``SyntheticLM`` batch.  Tolerances: loss within 1e-5 and gradients
within rtol 1e-4 / atol 1e-6 — the same f32 math summed in other orders by
XLA and by PyTorch's CPU kernels (and, for sequences past one KV block,
the reference's hand-written flash VJP against autograd through the
blockwise forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import SyntheticLM
from repro.models import build_model as j_build_model
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.interop import to_torch
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.tree import tree_flatten, tree_unflatten


def _jax_and_port(seq_len, batch):
    cfg = j_get_config("qwen2-0.5b").reduced()
    jmodel = j_build_model(cfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(0))
    tmodel = build_model(get_config("qwen2-0.5b").reduced(),
                         dtype=torch.float32, device="cpu")
    tparams = to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    b = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                    seed=1).batch(0, batch)
    return jmodel, jparams, tmodel, tparams, b


@pytest.mark.parametrize("seq_len,batch", [
    (32, 2),      # one KV block: _plain_attention
    (1024, 1),    # two 512-key blocks: the blockwise online-softmax path
])
def test_loss_and_grads_match(seq_len, batch):
    jmodel, jparams, tmodel, tparams, b = _jax_and_port(seq_len, batch)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, jbatch)

    leaves, treedef = tree_flatten(tparams)
    live = [p.requires_grad_(True) for p in leaves]
    tloss, taux = tmodel.loss_fn(tree_unflatten(treedef, live),
                                 {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    tgrads = torch.autograd.grad(tloss, live)

    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5
    assert abs(float(taux["loss"].detach()) - float(jaux["loss"])) <= 1e-5
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for tg, jg in zip(tgrads, jleaves):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6)


def test_chunked_loss_matches_past_one_chunk():
    """Sequences that are a multiple of the 1024 chunk and longer than it
    take the chunked-logits loop."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 2048, 8)).astype(np.float32)
    emb = rng.standard_normal((16, 8)).astype(np.float32)
    labels = rng.integers(0, 12, size=(2, 2048)).astype(np.int32)
    jl = jlayers.chunked_loss(jnp.asarray(h), {"embed": jnp.asarray(emb)},
                              jnp.asarray(labels), 12)
    tl = tlayers.chunked_loss(torch.from_numpy(h),
                              {"embed": torch.from_numpy(emb)},
                              torch.from_numpy(labels), 12)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def test_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9)
    jr = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    tr = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-6)


def test_init_matches_reference_shapes_and_scales():
    cfg = get_config("qwen2-0.5b").reduced()
    tparams = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    jparams = j_build_model(j_get_config("qwen2-0.5b").reduced()).init(
        jax.random.key(0))
    tl, _ = tree_flatten(tparams)
    jl = jax.tree_util.tree_leaves(jparams)
    assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
    assert all(t.dtype == torch.bfloat16 for t in tl)
    for t, j in zip(tl, jl):
        ts, js = float(t.float().std()), float(jnp.std(j.astype(jnp.float32)))
        assert abs(ts - js) <= 0.1 * js + 1e-6, (ts, js)
