"""The port's flat wire layout and int8 round-trip against the JAX package.

Both packages flatten the reduced qwen2-0.5b param tree in sorted-key
order, so the leaf sizes, the bucket plans and the flat layout must be
identical.  The round-trip decodes one f32 update through quantize and the
fused decode: per-leaf padding puts every quantization block in the same
place, so the decoded tree is bit-equal, and ``||u||`` agrees within rtol
1e-6 (the sum of squares is summed in another order: per 2048-column tile
in the reference, per 1024-column block here).  The bucket views of the
in-graph step's reduction (``bucket_slice``, ``unpack_bucket``) are
compared element for element, and a quantized bucket that starts off
alignment bit for bit.

The sparse half (bounded-loss wire): ``topk_sparsify`` gives JAX's indices
exactly, ties lower index first; ``sparse_quantize`` matches JAX bit for bit
both eagerly (a division by 127) and under ``jit`` (a multiply by
f32(1/127)), and the q bits show that ``vals / scale`` stays a division under
``jit``; ``ErrorFeedback`` gives the same chunk, delivered vector, residual
and ``flushed_total`` bit for bit (the residual norm compared with the bound
is summed in another order, which could flip only an exact tie).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.dist import flatbuf as jflat
from repro.models import build_model as j_build_model
from repro_torch.dist import flatbuf as tflat
from repro_torch.interop import to_numpy, to_torch
from repro_torch.tree import tree_flatten, tree_leaves


@pytest.fixture(scope="module")
def jax_params():
    cfg = j_get_config("qwen2-0.5b").reduced()
    return j_build_model(cfg).init(jax.random.key(0))


def _np_tree(jtree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jtree)


def test_interop_roundtrip_is_exact_and_keeps_order(jax_params):
    tparams = to_torch(_np_tree(jax_params), dtype=torch.bfloat16,
                       device="cpu")
    jleaves, _ = jax.tree_util.tree_flatten(jax_params)
    tleaves = tree_leaves(tparams)
    assert [tuple(l.shape) for l in tleaves] == [l.shape for l in jleaves]
    # stacked [L, ...] layer leaves, as init_stack builds them
    assert tparams["layers"]["mix"]["bq"].shape == (2, 4 * 32)
    for t, j in zip(tleaves, jleaves):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))
    back = to_numpy(tparams)
    for b, j in zip(tree_leaves(back), jleaves):
        np.testing.assert_array_equal(b, np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("bucket_bytes", [1, 4096, 65536, 1 << 30])
@pytest.mark.parametrize("shortest_first", [True, False])
def test_plan_flat_layout_matches(jax_params, bucket_bytes, shortest_first):
    jsizes = [int(l.size) for l in jax.tree_util.tree_leaves(jax_params)]
    tparams = to_torch(_np_tree(jax_params), device="cpu")
    tsizes = [l.numel() for l in tree_leaves(tparams)]
    assert tsizes == jsizes
    jl = jflat.plan_flat_layout(jsizes, bucket_bytes,
                                shortest_first=shortest_first)
    tl = tflat.plan_flat_layout(tsizes, bucket_bytes,
                                shortest_first=shortest_first)
    assert [dataclasses.astuple(b) for b in tl.buckets] == \
        [dataclasses.astuple(b) for b in jl.buckets]
    for f in ("leaf_sizes", "leaf_offsets", "bucket_starts", "bucket_sizes",
              "total"):
        assert getattr(tl, f) == getattr(jl, f), f


def test_pack_leaves_matches():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in [(3, 5), (7,), (2, 2, 2)]]
    jp = jflat.pack_leaves([jnp.asarray(l) for l in leaves])
    tp = tflat.pack_leaves([torch.from_numpy(l) for l in leaves])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_flat_compress_roundtrip_matches(jax_params, scale):
    rng = np.random.default_rng(3)
    update = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32),
        jax_params)
    # a tiny-magnitude leaf (a bias next to large weights) must keep its
    # own quantization blocks
    update["layers"]["mix"]["bq"] *= np.float32(1e-6)
    jdec, jnorm = jflat.flat_compress_roundtrip(
        jax.tree.map(jnp.asarray, update))
    tdec, tnorm = tflat.flat_compress_roundtrip(to_torch(update,
                                                         device="cpu"))
    jleaves, jdef = jax.tree_util.tree_flatten(jdec)
    tleaves, _ = tree_flatten(tdec)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert np.abs(tdec["layers"]["mix"]["bq"].numpy()).max() > 0
    np.testing.assert_allclose(tnorm, jnorm, rtol=1e-6)


@pytest.mark.parametrize("bucket_bytes", [1024, 64 * 1024, 4 * 2 ** 20])
@pytest.mark.parametrize("shortest_first", [True, False])
def test_bucket_views_match(jax_params, bucket_bytes, shortest_first):
    """plan_reduce, bucket_slice and unpack_bucket give JAX's buckets and
    leaves; a bucket is a view of the flat buffer, and a leaf a view of its
    bucket wherever no cast is needed."""
    from repro.dist.collectives import plan_reduce as j_plan_reduce
    from repro_torch.dist.collectives import plan_reduce

    rng = np.random.default_rng(11)
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jax_params)
    tgrads = to_torch(grads, device="cpu")
    jl = j_plan_reduce(jax.tree.map(jnp.asarray, grads),
                       bucket_bytes=bucket_bytes,
                       shortest_first=shortest_first)
    tl = plan_reduce(tgrads, bucket_bytes=bucket_bytes,
                     shortest_first=shortest_first)
    assert dataclasses.astuple(tl) == dataclasses.astuple(jl)

    jleaves = jax.tree_util.tree_leaves(grads)
    tleaves = tree_leaves(tgrads)
    jflat_pack = jflat.pack_leaves([jnp.asarray(l) for l in jleaves])
    tflat_buf = tflat.pack_leaves(tleaves)
    for k in range(len(tl.buckets)):
        tv = tflat.bucket_slice(tflat_buf, tl, k)
        jv = jflat.bucket_slice(jflat_pack, jl, k)
        assert tv.data_ptr() == tflat_buf.data_ptr() + 4 * tl.bucket_starts[k]
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jparts = jflat.unpack_bucket(jv, jl, k, jleaves)
        tparts = tflat.unpack_bucket(tv, tl, k, tleaves)
        assert [i for i, _ in tparts] == [i for i, _ in jparts]
        for (_, t), (_, j) in zip(tparts, jparts):
            assert tuple(t.shape) == j.shape
            assert t.untyped_storage().data_ptr() == \
                tflat_buf.untyped_storage().data_ptr()
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_unpack_bucket_casts_to_leaf_dtype():
    leaves = [torch.zeros(3, dtype=torch.bfloat16), torch.zeros((2, 2))]
    layout = tflat.plan_flat_layout([3, 4], 1 << 20)
    vec = torch.arange(7, dtype=torch.float32) + 0.25
    (i0, a), (i1, b) = tflat.unpack_bucket(vec, layout, 0, leaves)
    assert (i0, i1) == (0, 1)
    assert a.dtype == torch.bfloat16 and b.shape == (2, 2)
    assert torch.equal(b, vec[3:].view(2, 2))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_quantize_op_on_unaligned_slice_matches_jax(k):
    """A bucket view may start at any element: the port's quantize_op on
    flat[k:k+n] equals JAX's on the same slice, bit for bit (the CUDA
    kernel's unaligned path is held against this in
    tests/test_torch_cuda.py)."""
    from repro.kernels.ops import quantize_op as j_quantize_op
    from repro_torch.kernels.ops import quantize_op

    rng = np.random.default_rng(k)
    flat = (rng.standard_normal(4096) * 0.3).astype(np.float32)
    for n in (256, 1000):
        view = torch.from_numpy(flat)[k:k + n]
        assert view.data_ptr() % 16 != 0
        qt, st = quantize_op(view)
        qj, sj = j_quantize_op(jnp.asarray(flat[k:k + n]))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# --------------------------------------------------------------------------- #
# bounded-loss wire format
# --------------------------------------------------------------------------- #
def _tied(n=3000, seed=0):
    """Many equal magnitudes of both signs: bf16-like gradients tie often at
    the top-k boundary."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-40, 41, size=n).astype(np.float32) * np.float32(0.125)
    return x


@pytest.mark.parametrize("k", [1, 2, 7, 100, 1499, 3000])
def test_topk_sparsify_matches_jax_with_ties(k):
    x = _tied()
    ji, jv = jflat.topk_sparsify(jnp.asarray(x), k)
    ti, tv = tflat.topk_sparsify(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_topk_tie_rule_is_lower_index_first():
    ti, _ = tflat.topk_sparsify(torch.tensor([1.0, 3.0, -3.0, 2.0, 3.0]), 2)
    assert ti.tolist() == [1, 2]


@pytest.mark.parametrize("seed", range(4))
def test_sparse_quantize_matches_jax_eager_and_jitted(seed):
    rng = np.random.default_rng(seed)
    scales_differ = 0
    for i in range(200):
        v = (rng.standard_normal(97) * rng.exponential()).astype(np.float32)
        qe, se = jflat.sparse_quantize(jnp.asarray(v))
        qj, sj = jax.jit(jflat.sparse_quantize)(jnp.asarray(v))
        tqe, tse = tflat.sparse_quantize(torch.from_numpy(v))
        tqj, tsj = tflat.sparse_quantize(torch.from_numpy(v),
                                         reciprocal=True)
        assert float(tse) == float(se) and float(tsj) == float(sj)
        np.testing.assert_array_equal(tqe.numpy(), np.asarray(qe))
        np.testing.assert_array_equal(tqj.numpy(), np.asarray(qj))
        scales_differ += float(se) != float(sj)
    assert scales_differ > 0     # the two roundings really do differ


def test_sparse_quantize_all_zero_chunk():
    q, s = tflat.sparse_quantize(torch.zeros(5))
    assert float(s) == np.float32(1e-30) and not q.any()


def _ef_inputs(seed, dim, steps):
    rng = np.random.default_rng(seed)
    gs = [(rng.standard_normal(dim) * rng.exponential(2.0))
          .astype(np.float32) for _ in range(steps)]
    gs[1][rng.integers(dim)] *= 50.0          # a spike: forces flushes
    return rng, gs


@pytest.mark.parametrize("keep,drop_rate,bound_frac,short", [
    (0.1, 0.25, 0.5, False), (0.3, 0.6, 0.2, False), (1.0, 0.0, None, False),
    (0.05, 0.9, 1.0, True)])
def test_error_feedback_matches_jax(keep, drop_rate, bound_frac, short):
    dim, steps = 500, 4
    rng, gs = _ef_inputs(7, dim, steps)
    jef, tef = jflat.ErrorFeedback(dim), tflat.ErrorFeedback(dim,
                                                             device="cpu")
    for g in gs:
        k = max(1, min(dim, int(round(keep * dim))))
        drop = rng.random(k - 3 if short else k) < drop_rate
        bound = (None if bound_frac is None
                 else bound_frac * float(np.linalg.norm(g)))
        jc, jd = jef.compress(g, keep=keep, bound=bound, drop_mask=drop)
        tc, td = tef.compress(torch.from_numpy(g), keep=keep, bound=bound,
                              drop_mask=drop)
        np.testing.assert_array_equal(tc.idx.numpy(), np.asarray(jc.idx))
        np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
        assert float(tc.scale) == float(jc.scale)
        assert tc.flushed == jc.flushed
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tef.residual.numpy(),
                                      np.asarray(jef.residual))
    assert tef.flushed_total == jef.flushed_total
    if bound_frac is not None and bound_frac <= 0.5:
        assert tef.flushed_total > 0


def test_error_feedback_validation_and_no_bound():
    ef = tflat.ErrorFeedback(64, device="cpu")
    with pytest.raises(ValueError):
        ef.compress(torch.zeros(64), keep=0.0)
    g = torch.zeros(64)
    g[0] = 100.0
    chunk, _ = ef.compress(g, keep=1.0 / 64, drop_mask=np.asarray([True]))
    assert chunk.flushed == 0 and chunk.idx.tolist() == [-1]
    assert float(ef.residual.norm()) == pytest.approx(100.0)


try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:              # the properties skip without hypothesis
    st = None


if st is not None:
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), keep=st.floats(0.05, 1.0),
           drop_rate=st.floats(0.0, 0.9), bound_frac=st.floats(0.05, 2.0),
           n_steps=st.integers(1, 8), spike=st.booleans())
    def test_port_residual_never_exceeds_bound(seed, keep, drop_rate,
                                               bound_frac, n_steps, spike):
        """Twin of tests/test_loss_tolerant.py's first property: after
        every compress, ||residual|| <= bound."""
        dim = 64
        rng = np.random.default_rng(seed)
        ef = tflat.ErrorFeedback(dim, device="cpu")
        for _ in range(n_steps):
            g = (rng.standard_normal(dim)
                 * rng.exponential(scale=2.0)).astype(np.float32)
            if spike:
                g[rng.integers(dim)] *= 50.0
            bound = bound_frac * float(np.linalg.norm(g)) + 1e-6
            k = max(1, min(dim, int(round(keep * dim))))
            ef.compress(torch.from_numpy(g), keep=keep, bound=bound,
                        drop_mask=rng.random(k) < drop_rate)
            assert float(ef.residual.norm()) <= bound * (1 + 1e-4)

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), keep=st.floats(0.1, 1.0),
           drop_rate=st.floats(0.0, 0.8), n_steps=st.integers(1, 8))
    def test_port_delivered_plus_residual_conserves_mass(seed, keep,
                                                         drop_rate, n_steps):
        """Twin of the second property: sum(delivered) + residual equals
        the sum of the inputs, at that test's tolerance."""
        dim = 64
        rng = np.random.default_rng(seed)
        ef = tflat.ErrorFeedback(dim, device="cpu")
        total_in = np.zeros(dim, np.float64)
        total_out = np.zeros(dim, np.float64)
        for _ in range(n_steps):
            g = rng.standard_normal(dim).astype(np.float32)
            k = max(1, min(dim, int(round(keep * dim))))
            _, delivered = ef.compress(
                torch.from_numpy(g), keep=keep,
                bound=float(np.linalg.norm(g)),
                drop_mask=rng.random(k) < drop_rate)
            total_in += g.astype(np.float64)
            total_out += delivered.numpy().astype(np.float64)
        gap = total_in - (total_out + ef.residual.numpy().astype(np.float64))
        assert np.abs(gap).max() <= 1e-3 * max(1.0, np.abs(total_in).max())
