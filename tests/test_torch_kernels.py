"""The port's wire kernels against the JAX package's, on identical numpy
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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dequant_aggregate import dequant_aggregate as j_dequant_aggregate
from repro.kernels.quantize import quantize as j_quantize
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dequant_aggregate import dequant_aggregate_plain
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
