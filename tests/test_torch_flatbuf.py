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
