"""The port's kernels against the JAX package's, on identical numpy
inputs.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode (the kernel body itself
executes) and, jitted, through ``repro.kernels.ops`` as the main path does.
The CUDA kernels themselves are compared with the plain versions in
``tests/test_torch_cuda.py``, on the card.

Tolerances:
* quantize: q and scales bit-equal to the jitted/interpret Pallas path.
  Against the eager oracle ``quantize_ref`` the scales may differ by 1 ulp:
  under jit XLA turns ``max|x| / 127`` into a multiply by f32(1/127), which
  the port matches; the eager oracle divides.
* dequant_aggregate: agg bit-equal at N=1 (one product per column, no sum);
  rtol 1e-6 for N > 1, where the reference's ``jnp.sum`` over a row chunk
  and the port's in-order row loop round in different orders; the sum of
  squares rtol 1e-5 (per-tile partials summed in different orders).
* grad_aggregate: see ``TestGradAggregate``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dequant_aggregate import dequant_aggregate as j_dequant_aggregate
from repro.kernels.grad_aggregate import grad_aggregate as j_grad_aggregate
from repro.kernels.quantize import quantize as j_quantize
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dequant_aggregate import dequant_aggregate_plain
from repro_torch.kernels.grad_aggregate import grad_aggregate_plain
from repro_torch.kernels.quantize import quantize_plain


def _x(d, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(d) * scale).astype(np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _ties_block():
    # scale = 127 * f32(1/127) lands on 1.0 exactly, so x / scale keeps the
    # half-way values exact and round-half-to-even decides them
    x = np.zeros(256, np.float32)
    x[0] = 127.0
    x[1:11] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5, 4.5]
    return x


# --------------------------------------------------------------------------- #
# quantize
# --------------------------------------------------------------------------- #
class TestQuantize:
    @pytest.mark.parametrize("d", [256, 4096])
    def test_plain_matches_pallas_bitwise(self, d):
        x = _x(d, seed=d, scale=0.37)
        qj, sj = j_quantize(jnp.asarray(x), interpret=True)
        qp, sp = quantize_plain(torch.from_numpy(x))
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))

    @pytest.mark.parametrize("d", [256, 4096, 1000])
    def test_op_matches_jitted_op_bitwise(self, d):
        """quantize_op pads a ragged length (1000 -> 1024) like the JAX op."""
        x = _x(d, seed=d + 1, scale=2.5)
        qj, sj = jops.quantize_op(jnp.asarray(x))
        qp, sp = ops.quantize_op(torch.from_numpy(x))
        assert qp.shape[0] == -(-d // 256) * 256
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))

    def test_eager_oracle_within_one_ulp(self):
        x = _x(4000 * 256, seed=7, scale=1e-3)
        qr, sr = jref.quantize_ref(jnp.asarray(x))
        qp, sp = quantize_plain(torch.from_numpy(x))
        assert int(_ulps(sp.numpy(), np.asarray(sr)).max()) <= 1
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qr))
        # the port's own oracle twin reproduces the eager JAX oracle exactly
        qt, st = ref.quantize_ref(torch.from_numpy(x))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sr))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))

    def test_all_zero_block(self):
        x = np.concatenate([np.zeros(256, np.float32), _x(256, seed=3)])
        qj, sj = j_quantize(jnp.asarray(x), interpret=True)
        qp, sp = quantize_plain(torch.from_numpy(x))
        assert float(sp[0]) == np.float32(1e-30)
        assert not qp[:256].any()
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))

    def test_half_way_ties_round_to_even(self):
        x = _ties_block()
        qj, sj = j_quantize(jnp.asarray(x), interpret=True)
        qp, sp = quantize_plain(torch.from_numpy(x))
        assert float(sp[0]) == 1.0
        assert qp[1:11].tolist() == [0, 2, 2, 0, -2, -2, 126, -126, 4, 4]
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))

    def test_range_is_symmetric(self):
        x = _x(2048, seed=5, scale=10.0)
        qp, _ = quantize_plain(torch.from_numpy(x))
        assert int(qp.min()) >= -127 and int(qp.max()) <= 127


# --------------------------------------------------------------------------- #
# dequant_aggregate
# --------------------------------------------------------------------------- #
def _payload(n, d_pad, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(n, d_pad), dtype=np.int8)
    s = (rng.uniform(0.1, 2.0, size=(n, d_pad // 256)) * 1e-2
         ).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return q, s, w


class TestDequantAggregate:
    def test_n1_bitwise(self):
        q, s, _ = _payload(1, 256 * 13, seed=1)
        w = np.ones(1, np.float32)
        aj, ssj = j_dequant_aggregate(jnp.asarray(q), jnp.asarray(s),
                                      jnp.asarray(w), orig_len=256 * 13,
                                      interpret=True)
        ap, ssp = dequant_aggregate_plain(torch.from_numpy(q),
                                          torch.from_numpy(s),
                                          torch.from_numpy(w),
                                          orig_len=256 * 13)
        np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
        np.testing.assert_allclose(float(ssp), float(ssj), rtol=1e-5)

    @pytest.mark.parametrize("n,d_pad,orig_len", [
        (3, 256 * 13, 256 * 13 - 77),    # ragged D tile (block_d 2048)
        (9, 256 * 9, 256 * 9 - 1),       # ragged N chunk (chunk_n 8) too
    ])
    def test_weighted_ragged(self, n, d_pad, orig_len):
        q, s, w = _payload(n, d_pad, seed=n)
        aj, ssj = j_dequant_aggregate(jnp.asarray(q), jnp.asarray(s),
                                      jnp.asarray(w), orig_len=orig_len,
                                      interpret=True)
        ap, ssp = ops.dequant_aggregate_op(torch.from_numpy(q),
                                           torch.from_numpy(s),
                                           torch.from_numpy(w),
                                           orig_len=orig_len)
        assert ap.shape == (orig_len,) and ap.dtype == torch.float32
        np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(float(ssp), float(ssj), rtol=1e-5)

    def test_plain_matches_oracle_twin(self):
        q, s, w = _payload(4, 256 * 3, seed=4)
        args = (torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(w))
        ap, ssp = dequant_aggregate_plain(*args, orig_len=700)
        ar, ssr = ref.dequant_aggregate_ref(*args, orig_len=700)
        aj, ssj = jref.dequant_aggregate_ref(jnp.asarray(q), jnp.asarray(s),
                                             jnp.asarray(w), orig_len=700)
        # the oracles sum the rows inside one einsum (a matrix-vector
        # product with FMAs, in a library's order): where rows cancel, the
        # error is a few ulps of the summands (O(1) here), not of the sum
        np.testing.assert_allclose(ar.numpy(), np.asarray(aj), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ap.numpy(), ar.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(float(ssp), float(ssr), rtol=1e-5)

    def test_bad_shapes_raise(self):
        q, s, w = _payload(2, 512, seed=0)
        with pytest.raises(ValueError):
            dequant_aggregate_plain(torch.from_numpy(q),
                                    torch.from_numpy(s[:, :1]),
                                    torch.from_numpy(w))
        with pytest.raises(ValueError):
            dequant_aggregate_plain(torch.from_numpy(q), torch.from_numpy(s),
                                    torch.from_numpy(w), orig_len=513)


class TestRouting:
    def test_cpu_goes_to_plain_and_counts_nothing(self):
        before = (ops.quantize_op.launches, ops.dequant_aggregate_op.launches)
        q, s = ops.quantize_op(torch.from_numpy(_x(512)))
        ops.dequant_aggregate_op(q[None], s[None], torch.ones(1))
        assert (ops.quantize_op.launches,
                ops.dequant_aggregate_op.launches) == before

    def test_other_devices_raise(self):
        x = torch.zeros(256, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            ops.quantize_op(x)
        with pytest.raises(ValueError, match="no kernel"):
            ops.dequant_aggregate_op(torch.zeros((1, 256), dtype=torch.int8,
                                                 device="meta"),
                                     torch.zeros((1, 1), device="meta"),
                                     torch.ones(1, device="meta"))


# --------------------------------------------------------------------------- #
# grad_aggregate
# --------------------------------------------------------------------------- #
def _updates(n, d, dtype, seed):
    """f32 normals (rounded to bf16 for the bf16 cases, so both packages
    start from the same values) and weights in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "bfloat16":
        u = torch.from_numpy(u).bfloat16().float().numpy()
    return u, rng.uniform(0.5, 1.5, size=n).astype(np.float32)


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 bits of mantissa)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


class TestGradAggregate:
    """The port's plain version against the Pallas kernel in interpret mode
    at the ``block_d`` values of ``tests/test_kernels.py``.  f32 agg within
    rtol 1e-6 (atol 1e-6: the reference sums its rows inside one
    ``jnp.sum``, the port in row order, so where the rows cancel the error
    is of the summands' size).  It is not bit-equal, even at N=2: XLA's CPU
    code fuses a product into the sum (an FMA) where the port rounds the
    product first; about a quarter of the columns differ by an ulp or two.
    bf16 agg within one bf16 ulp (the two f32
    sums may fall on either side of a bf16 rounding boundary); ssq rtol
    1e-5 (per-tile partials summed in another order)."""

    @pytest.mark.parametrize("n,d,block_d", [
        (2, 256, 256), (5, 1024, 256), (8, 4096, 256), (1, 512, 256),
        (3, 1000, 256), (2, 100, 2048), (4, 2049, 1024)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_pallas(self, n, d, block_d, dtype):
        u, w = _updates(n, d, dtype, seed=n * 7919 + d)
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        aj, ssj = j_grad_aggregate(jnp.asarray(u, jdt), jnp.asarray(w),
                                   block_d=block_d, interpret=True)
        tu = torch.from_numpy(u).to(getattr(torch, dtype))
        ap, ssp = grad_aggregate_plain(tu, torch.from_numpy(w))
        assert ap.shape == (d,) and ap.dtype == tu.dtype
        got, ref = ap.float().numpy(), np.asarray(aj, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        else:
            assert np.all(np.abs(got - ref) <= _bf16_ulp(ref))
        np.testing.assert_allclose(float(ssp), float(ssj), rtol=1e-5)

    def test_plain_matches_oracle_twin(self):
        u, w = _updates(6, 777, "float32", seed=2)
        ap, ssp = grad_aggregate_plain(torch.from_numpy(u),
                                       torch.from_numpy(w))
        ar, ssr = ref.grad_aggregate_ref(torch.from_numpy(u),
                                         torch.from_numpy(w))
        aj, ssj = jref.grad_aggregate_ref(jnp.asarray(u), jnp.asarray(w))
        np.testing.assert_allclose(ar.numpy(), np.asarray(aj), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ap.numpy(), ar.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(float(ssp), float(ssj), rtol=1e-5)

    def test_uniform_weights_is_sum(self):
        agg, ssq = ops.grad_aggregate_op(torch.ones((4, 512)), torch.ones(4))
        assert torch.all(agg == 4.0) and float(ssq) == 16.0 * 512

    def test_rows_summed_in_order(self):
        # (1e8 + 1) - 1e8 is 0 in f32, but 1e8 + (1 - 1e8) is 1: the row
        # order is part of the contract the CUDA kernel reproduces
        u = torch.tensor([[1e8], [1.0], [-1e8]])
        agg, _ = ops.grad_aggregate_op(u, torch.ones(3))
        assert float(agg[0]) == 0.0

    def test_bad_shapes_raise(self):
        with pytest.raises(ValueError):
            grad_aggregate_plain(torch.ones(8), torch.ones(1))
        with pytest.raises(ValueError):
            grad_aggregate_plain(torch.ones((2, 8)), torch.ones(3))


class TestGradAggregateRouting:
    def test_cpu_goes_to_plain_and_counts_nothing(self):
        before = ops.grad_aggregate_op.launches
        ops.grad_aggregate_op(torch.ones((2, 300)), torch.ones(2))
        assert ops.grad_aggregate_op.launches == before

    def test_meta_raises(self):
        with pytest.raises(ValueError, match="no kernel"):
            ops.grad_aggregate_op(torch.zeros((2, 256), device="meta"),
                                  torch.ones(2, device="meta"))
