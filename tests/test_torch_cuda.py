"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and decides inside the test whether a
CUDA device and ``nvcc`` are present, skipping with a reason where they are
not (as on a CPU-only host).  The file imports neither JAX nor the JAX
package, so it runs on a card host that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py

The kernels round each product and sum one at a time in the plain
versions' order, so agreement is bit for bit (sums of squares rtol 1e-5:
per-block partials summed in another order), also on views that start off
alignment, as the buckets of the in-graph step do.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.dequant_aggregate import dequant_aggregate_plain
from repro_torch.kernels.grad_aggregate import grad_aggregate_plain
from repro_torch.kernels.quantize import quantize_plain


def _x(d, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(d) * scale).astype(np.float32)


def _ties_block():
    # scale = 127 * f32(1/127) lands on 1.0 exactly, so x / scale keeps the
    # half-way values exact and round-half-to-even decides them
    x = np.zeros(256, np.float32)
    x[0] = 127.0
    x[1:11] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5, 4.5]
    return x


def _payload(n, d_pad, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(n, d_pad), dtype=np.int8)
    s = (rng.uniform(0.1, 2.0, size=(n, d_pad // 256)) * 1e-2
         ).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return q, s, w


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc")):
        pytest.skip("needs nvcc to build the kernels")


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("d", [256, 4096, 1000, 256 * 4099])
    def test_quantize_kernel_bitwise(self, d):
        _need_card()
        x = torch.from_numpy(_x(d, seed=d, scale=0.1)).cuda()
        x[:256] = 0.0
        before = ops.quantize_op.launches
        qk, sk = ops.quantize_op(x)
        assert ops.quantize_op.launches == before + 1
        xp = torch.nn.functional.pad(x, (0, qk.shape[0] - d))
        qp, sp = quantize_plain(xp)
        torch.cuda.synchronize()
        assert torch.equal(qk, qp) and torch.equal(sk, sp)

    def test_quantize_ties_on_card(self):
        _need_card()
        x = torch.from_numpy(_ties_block()).cuda()
        qk, sk = ops.quantize_op(x)
        assert qk[1:11].tolist() == [0, 2, 2, 0, -2, -2, 126, -126, 4, 4]
        assert float(sk[0]) == 1.0

    @pytest.mark.parametrize("n,d_pad,orig_len", [
        (1, 256 * 13, 256 * 13), (1, 256 * 13, 256 * 13 - 3),
        (3, 256 * 13, 256 * 13 - 77), (9, 256 * 4099, 256 * 4099 - 1),
    ])
    def test_dequant_aggregate_kernel(self, n, d_pad, orig_len):
        _need_card()
        q, s, w = (torch.from_numpy(a).cuda() for a in _payload(n, d_pad, n))
        if n == 1:
            w = torch.ones(1, device="cuda")
        ak, ssk = ops.dequant_aggregate_op(q, s, w, orig_len=orig_len)
        ap, ssp = dequant_aggregate_plain(q, s, w, orig_len=orig_len)
        torch.cuda.synchronize()
        # the kernel rounds each product and sum in row order like the plain
        # loop, so it is bit-equal at every N
        assert torch.equal(ak, ap)
        np.testing.assert_allclose(float(ssk), float(ssp), rtol=1e-5)

    @pytest.mark.parametrize("k", [1, 2, 3, 4])
    def test_quantize_kernel_on_unaligned_views(self, k):
        """A bucket view starting k floats into a buffer: the kernel reads
        it in place (scalar loads off 16-byte alignment), bit-equal."""
        _need_card()
        flat = torch.from_numpy(_x(256 * 40 + 8, seed=k, scale=0.2)).cuda()
        view = flat[k:k + 256 * 40]
        assert (view.data_ptr() % 16 == 0) == (k == 4)
        before = ops.quantize_op.launches
        qk, sk = ops.quantize_op(view)
        assert ops.quantize_op.launches == before + 1
        qp, sp = quantize_plain(view.clone())
        torch.cuda.synchronize()
        assert torch.equal(qk, qp) and torch.equal(sk, sp)

    @pytest.mark.parametrize("n,d", [(1, 4096), (2, 1024 * 9),
                                     (3, 2 ** 16 + 99), (4, 5), (8, 1000)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("offset", [0, 1])
    def test_grad_aggregate_kernel(self, n, d, dtype, offset):
        """Bit-equal agg (products and sums rounded one at a time, rows in
        order, as the plain loop does) for ragged D, both dtypes, and
        updates that start one element off alignment."""
        _need_card()
        rng = np.random.default_rng(n * d)
        buf = torch.from_numpy(rng.standard_normal(n * d + offset)
                               .astype(np.float32)).to("cuda", dtype)
        u = buf[offset:].view(n, d)
        w = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)
                             ).cuda()
        before = ops.grad_aggregate_op.launches
        ak, ssk = ops.grad_aggregate_op(u, w)
        assert ops.grad_aggregate_op.launches == before + 1
        ap, ssp = grad_aggregate_plain(u, w)
        torch.cuda.synchronize()
        assert ak.dtype == dtype and ak.shape == (d,)
        assert torch.equal(ak, ap)
        np.testing.assert_allclose(float(ssk), float(ssp), rtol=1e-5)

    def test_kernels_refuse_what_they_do_not_take(self):
        _need_card()
        with pytest.raises(ValueError):
            ops.quantize_op(torch.zeros(512, device="cuda"), block=128)
        with pytest.raises(ValueError):
            ops.quantize_op(torch.zeros(512, device="cuda",
                                        dtype=torch.float64))
        with pytest.raises(ValueError):
            ops.dequant_aggregate_op(
                torch.zeros((1, 256), dtype=torch.int8, device="cuda"),
                torch.zeros((1, 1), dtype=torch.float64, device="cuda"),
                torch.ones(1, device="cuda"))
        with pytest.raises(ValueError):
            ops.grad_aggregate_op(torch.zeros((2, 8), dtype=torch.float16,
                                              device="cuda"),
                                  torch.ones(2, device="cuda"))
        with pytest.raises(ValueError):
            ops.grad_aggregate_op(torch.zeros((8, 2), device="cuda").T,
                                  torch.ones(2, device="cuda"))
        with pytest.raises(ValueError):
            ops.grad_aggregate_op(torch.zeros((2, 8), device="cuda"),
                                  torch.ones(2, dtype=torch.float64,
                                             device="cuda"))
