"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and decides inside the test whether a
CUDA device and ``nvcc`` are present, skipping with a reason where they are
not (as on a CPU-only host).  The file imports neither JAX nor the JAX
package, so it runs on a card host that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py

The kernels round each product and sum one at a time in the plain
versions' order, so agreement is bit for bit (sums of squares rtol 1e-5:
per-block partials summed in another order), also on views that start off
alignment, as the buckets of the in-graph step do.  ``switch_sum`` is exact
integer arithmetic; ``scatter_aggregate`` is bit-equal where each sender's
indices are distinct (the top-k chunks of the path), and where one sender
repeats an index its atomic adds meet in an order that varies from run to
run: within 2 m 2^-24 sum|v| of the plain version per column, for m adds.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.dequant_aggregate import dequant_aggregate_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.grad_aggregate import grad_aggregate_plain
from repro_torch.kernels.quantize import (dequantize, dequantize_plain,
                                         quantize_plain)
from repro_torch.kernels.scatter_aggregate import scatter_aggregate_plain
from repro_torch.kernels.switch_sum import switch_sum_plain


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

    @pytest.mark.parametrize("n,d_pad,orig_len", [
        (1, 256, None), (2, 4096, 4000), (11, 2048, None),
        (4, 256 * 4099, 256 * 4099 - 13), (1, 28672, 28544)])
    def test_switch_sum_kernel_bitwise(self, n, d_pad, orig_len):
        _need_card()
        rng = np.random.default_rng(n * d_pad)
        q = torch.from_numpy(rng.integers(-127, 128, size=(n, d_pad),
                                          dtype=np.int8)).cuda()
        before = ops.switch_sum_op.launches
        got = ops.switch_sum_op(q, orig_len=orig_len)
        assert ops.switch_sum_op.launches == before + 1
        want = switch_sum_plain(q, orig_len=orig_len)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want)

    def test_switch_sum_kernel_overflow_widening(self):
        _need_card()
        got = ops.switch_sum_op(torch.full((300, 512), 127, dtype=torch.int8,
                                           device="cuda"))
        assert int(got.min()) == int(got.max()) == 38100

    @pytest.mark.parametrize("n,k,d,unit", [
        (1, 1000, 5000, True), (2, 4096, 2 ** 16 + 3, True),
        (4, 777, 10_000, False), (3, 5, 7, False)])
    def test_scatter_aggregate_kernel_bitwise(self, n, k, d, unit):
        """Distinct indices within each sender, 25% dropped (-1) and a few
        past d_out: bit-equal."""
        _need_card()
        rng = np.random.default_rng(n * k)
        idx = np.stack([rng.choice(d + 3, size=min(k, d + 3), replace=False)
                        for _ in range(n)]).astype(np.int32)
        idx[rng.random(idx.shape) < 0.25] = -1
        q = rng.integers(-127, 128, size=idx.shape).astype(np.int8)
        s = rng.uniform(1e-3, 2.0, size=n).astype(np.float32)
        w = (np.ones(n, np.float32) if unit
             else rng.uniform(0.5, 1.5, size=n).astype(np.float32))
        args = [torch.from_numpy(a).cuda() for a in (idx, q, s, w)]
        before = ops.scatter_aggregate_op.launches
        ak, ssk = ops.scatter_aggregate_op(*args, d_out=d)
        assert ops.scatter_aggregate_op.launches == before + 1
        ap, ssp = scatter_aggregate_plain(*args, d_out=d)
        torch.cuda.synchronize()
        assert ak.shape == (d,) and torch.equal(ak, ap)
        np.testing.assert_allclose(float(ssk), float(ssp), rtol=1e-5)

    def test_scatter_aggregate_kernel_duplicates(self):
        _need_card()
        rng = np.random.default_rng(3)
        idx = rng.integers(0, 50, size=(4, 3000)).astype(np.int32)
        q = rng.integers(-127, 128, size=(4, 3000)).astype(np.int8)
        s = rng.uniform(1e-3, 2.0, size=4).astype(np.float32)
        w = rng.uniform(0.5, 1.5, size=4).astype(np.float32)
        args = [torch.from_numpy(a).cuda() for a in (idx, q, s, w)]
        ak, ssk = ops.scatter_aggregate_op(*args, d_out=64)
        ap, ssp = scatter_aggregate_plain(*args, d_out=64)
        v = np.abs(q.astype(np.float64) * (s * w)[:, None])
        absum = np.bincount(idx.ravel(), v.ravel(), minlength=64)
        m = np.bincount(idx.ravel(), minlength=64).max()
        assert np.all(np.abs(ak.cpu().numpy() - ap.cpu().numpy())
                      <= 2 * m * 2.0 ** -24 * absum)
        np.testing.assert_allclose(float(ssk), float(ssp), rtol=1e-5)

    def test_slice_four_kernels_refuse_what_they_do_not_take(self):
        _need_card()
        with pytest.raises(ValueError, match="int8"):
            ops.switch_sum_op(torch.zeros((2, 256), dtype=torch.int32,
                                          device="cuda"))
        with pytest.raises(ValueError, match="window"):
            ops.switch_sum_op(torch.zeros((2, 300), dtype=torch.int8,
                                          device="cuda"))
        buf = torch.zeros(2 * 256 + 1, dtype=torch.int8, device="cuda")
        with pytest.raises(ValueError, match="aligned"):
            ops.switch_sum_op(buf[1:].view(2, 256))
        with pytest.raises(ValueError, match="aligned"):
            ops.switch_sum_op(torch.zeros((2, 6), dtype=torch.int8,
                                          device="cuda"), window=2)
        with pytest.raises(ValueError, match="contiguous"):
            ops.switch_sum_op(torch.zeros((256, 2), dtype=torch.int8,
                                          device="cuda").T, window=2)
        idx = torch.zeros((2, 4), dtype=torch.int32, device="cuda")
        q = torch.ones((2, 4), dtype=torch.int8, device="cuda")
        one = torch.ones(2, device="cuda")
        with pytest.raises(ValueError):
            ops.scatter_aggregate_op(idx.long(), q, one, one, d_out=8)
        with pytest.raises(ValueError):
            ops.scatter_aggregate_op(idx, q, one.double(), one, d_out=8)
        with pytest.raises(ValueError):
            ops.scatter_aggregate_op(idx, q, one.cpu(), one, d_out=8)
        with pytest.raises(ValueError):
            ops.scatter_aggregate_op(
                torch.zeros((4, 2), dtype=torch.int32, device="cuda").T, q,
                one, one, d_out=8)


def _attn_inputs(b, h, kvh, s, d, dtype, seed=0, strided=False):
    """q [B,H,S,D], k, v [B,KVH,S,D] on the card; ``strided``: transposed
    views of [B, S, H, D] tensors, as the model hands them over."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for n in (h, kvh, kvh):
        shape = (b, s, n, d) if strided else (b, n, s, d)
        t = torch.randn(shape, generator=g, device="cuda").to(dtype)
        out.append(t.transpose(1, 2) if strided else t)
    return out


def _assert_attn_close(out, ref):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=2e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.cuda
class TestDequantizeOnCard:
    @pytest.mark.parametrize("d,block", [(256, 256), (256 * 4099, 256),
                                         (512, 16), (128 * 33, 128)])
    @pytest.mark.parametrize("offset", [0, 4, 1])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_dequantize_kernel_bitwise(self, d, block, offset, dtype):
        """Aligned and on views 1 and 4 bytes into a larger payload."""
        _need_card()
        rng = np.random.default_rng(d + offset)
        buf = torch.from_numpy(rng.integers(-127, 128, size=d + offset,
                                            dtype=np.int8)).cuda()
        q = buf[offset:]
        s = torch.from_numpy((rng.uniform(0.1, 2.0, size=d // block) * 1e-2
                              ).astype(np.float32)).cuda()
        if dtype == torch.float32:
            before = ops.dequantize_op.launches
            got = ops.dequantize_op(q, s, block=block, orig_len=d - 3)
            assert ops.dequantize_op.launches == before + 1
        else:
            got = dequantize(q, s, block=block, dtype=dtype)[:d - 3]
        torch.cuda.synchronize()
        want = dequantize_plain(q, s, block=block, dtype=dtype)[:d - 3]
        assert got.dtype == dtype and torch.equal(got, want)

    def test_dequantize_kernel_refuses_what_it_does_not_take(self):
        _need_card()
        q = torch.zeros(512, dtype=torch.int8, device="cuda")
        s = torch.ones(2, device="cuda")
        with pytest.raises(ValueError, match="block % 16"):
            ops.dequantize_op(q, torch.ones(64, device="cuda"), block=8)
        with pytest.raises(ValueError, match="one card"):
            ops.dequantize_op(q, s.cpu())
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            dequantize(q, s, dtype=torch.float16)
        with pytest.raises(ValueError, match="int8"):
            ops.dequantize_op(q.to(torch.int16), s)

    @pytest.mark.parametrize("n", [1, 2, 5])
    def test_unfused_receive_equals_dequant_aggregate(self, n):
        """dequantize each payload, stack, grad_aggregate: bit-equal to the
        fused kernel, which rounds the same products and sums in the same
        row order."""
        _need_card()
        d_pad = 256 * 37
        q, s, w = (torch.from_numpy(a).cuda() for a in _payload(n, d_pad, n))
        fused, ssq_f = ops.dequant_aggregate_op(q, s, w, orig_len=d_pad - 9)
        deq = torch.stack([ops.dequantize_op(q[i], s[i], orig_len=d_pad - 9)
                           for i in range(n)])
        unfused, ssq_u = ops.grad_aggregate_op(deq, w)
        torch.cuda.synchronize()
        assert torch.equal(fused, unfused)
        assert float(ssq_u) == pytest.approx(float(ssq_f), rel=1e-5)

    def test_checkpoint_round_trip_from_the_card(self, tmp_path):
        """bf16 and f32 leaves and a NamedTuple state saved from the card
        restore onto the card bit for bit, in their dtypes."""
        _need_card()
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.optim import momentum_sgd_init
        g = torch.Generator(device="cuda").manual_seed(0)
        params = {"w": torch.randn(300, 7, generator=g, device="cuda")
                  .bfloat16(),
                  "b": torch.randn(5, generator=g, device="cuda")}
        opt = momentum_sgd_init(params)
        opt.history["w"].normal_(generator=g)
        ck = Checkpointer(str(tmp_path))
        ck.save(3, {"params": params, "opt": opt})
        like = {"params": {k: torch.zeros_like(v) for k, v in
                           params.items()},
                "opt": momentum_sgd_init(params)}
        step, state, _ = ck.restore(like)
        assert step == 3
        for a, b in ((state["params"], params),
                     (state["opt"].history, opt.history)):
            for k in a:
                assert a[k].is_cuda and a[k].dtype == b[k].dtype
                assert torch.equal(a[k], b[k])


@pytest.mark.cuda
class TestFlashAttentionOnCard:
    @pytest.mark.parametrize("b,h,kvh,s,d,dtype,causal,strided", [
        (2, 14, 2, 4096, 64, torch.bfloat16, True, False),   # qwen2-0.5b
        (1, 4, 2, 256, 32, torch.float32, True, False),      # reduced, f32
        (1, 32, 32, 512, 64, torch.bfloat16, True, False),   # stablelm, G=1
        (1, 14, 2, 1024, 64, torch.bfloat16, False, False),  # not causal
        (1, 14, 2, 4000, 64, torch.bfloat16, True, False),   # ragged tiles
        (2, 14, 2, 1024, 64, torch.bfloat16, True, True),    # [B,S,H,D] views
        (1, 8, 2, 512, 128, torch.bfloat16, True, False),    # D 128
        (1, 8, 2, 200, 128, torch.float32, False, True),
        (1, 4, 1, 48, 32, torch.float32, True, False),       # one ragged tile
    ])
    def test_flash_attention_kernel(self, b, h, kvh, s, d, dtype, causal,
                                    strided):
        _need_card()
        q, k, v = _attn_inputs(b, h, kvh, s, d, dtype, seed=s + h,
                               strided=strided)
        before = ops.flash_attention_op.launches
        with torch.no_grad():
            out = ops.flash_attention_op(q, k, v, causal=causal)
        assert ops.flash_attention_op.launches == before + 1
        ref = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == q.dtype
        if strided:  # laid out as q is: transposing back is free
            assert out.transpose(1, 2).is_contiguous()
        _assert_attn_close(out, ref)

    def test_flash_attention_refuses_what_it_does_not_take(self):
        _need_card()
        q, k, v = _attn_inputs(1, 4, 2, 64, 32, torch.float32)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention_op(q.requires_grad_(True), k, v)
        q = q.detach()
        with pytest.raises(ValueError, match="head dims"):
            ops.flash_attention_op(q[..., :16], k[..., :16], v[..., :16])
        with pytest.raises(ValueError, match="one type"):
            ops.flash_attention_op(q, k.bfloat16(), v)
        with pytest.raises(ValueError, match="unit last stride"):
            ops.flash_attention_op(q.transpose(2, 3).contiguous()
                                   .transpose(2, 3), k, v)
        with pytest.raises(ValueError, match="group"):
            ops.flash_attention_op(q[:, :3], k, v)
        with pytest.raises(ValueError, match="one card"):
            ops.flash_attention_op(q, k.cpu(), v)

    def test_decode_writes_the_cache_in_place(self):
        """A decode step on the card writes its position into the cache
        tensors themselves: same storage before and after, the position
        filled, and the logits those of the CPU."""
        _need_card()
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        from repro_torch.tree import tree_map
        cfg = get_config("qwen2-0.5b").reduced()
        cpu = build_model(cfg, dtype=torch.float32, device="cpu")
        card = build_model(cfg, dtype=torch.float32, device="cuda")
        params = cpu.init(torch.Generator().manual_seed(0))
        params_card = tree_map(lambda t: t.cuda(), params)
        toks = torch.randint(0, cfg.vocab_size, (2, 1),
                             generator=torch.Generator().manual_seed(1))
        for kv_int8 in (False, True):
            cache = card.init_cache(2, 8, kv_int8=kv_int8)
            ptrs = {n: t.data_ptr() for n, t in cache["layers"].items()}
            logits, new = card.decode_step(params_card, cache, toks.cuda(), 3)
            assert {n: t.data_ptr() for n, t in new["layers"].items()} == ptrs
            key = "k_q" if kv_int8 else "k"
            assert bool(new["layers"][key][:, :, 3].ne(0).any())
            assert not bool(new["layers"][key][:, :, 4:].ne(0).any())
            want, _ = cpu.decode_step(params, cpu.init_cache(
                2, 8, kv_int8=kv_int8), toks, 3)
            torch.testing.assert_close(logits.cpu(), want, rtol=1e-5,
                                       atol=2e-5)


_FLASH_BF16 = [
    (d, s, causal, heads, strided)
    for d in (32, 64, 128)
    for s in (16, 48, 4000, 4096)
    for causal, heads, strided in ((True, (14, 2), True),
                                   (False, (32, 32), False))]


@pytest.mark.cuda
class TestFlashWgmmaOnCard:
    """The bf16 kernel (wgmma on the tensor cores, p split into three exact
    bf16 terms) against its plain version with ``attn_check``'s rule: one
    bf16 ulp, |out - ref| <= 1e-6 + 2^-7 |ref|."""

    @pytest.mark.parametrize("d,s,causal,heads,strided", _FLASH_BF16)
    def test_flash_attention_bf16_kernel(self, d, s, causal, heads, strided):
        _need_card()
        h, kvh = heads
        q, k, v = _attn_inputs(1, h, kvh, s, d, torch.bfloat16,
                               seed=s + d + h, strided=strided)
        before = ops.flash_attention_op.launches
        with torch.no_grad():
            out = ops.flash_attention_op(q, k, v, causal=causal)
        assert ops.flash_attention_op.launches == before + 1
        ref = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        _assert_attn_close(out, ref)

    def test_flash_attention_bf16_sq_differs_from_skv(self):
        """Sq != Skv (the mask has no offset, as in the Pallas kernel)."""
        _need_card()
        q, _, _ = _attn_inputs(2, 14, 2, 200, 64, torch.bfloat16, seed=1)
        _, k, v = _attn_inputs(2, 14, 2, 333, 64, torch.bfloat16, seed=2)
        for causal in (True, False):
            with torch.no_grad():
                out = ops.flash_attention_op(q, k, v, causal=causal)
            _assert_attn_close(out, flash_attention_plain(q, k, v,
                                                          causal=causal))


_FLASH_D96 = [
    (dtype, s, causal, heads, strided)
    for dtype in (torch.bfloat16, torch.float32)
    for s in (16, 48, 1000, 4096)
    for causal, heads, strided in ((True, (32, 32), True),
                                   (False, (8, 2), False),
                                   (True, (8, 2), False))]


@pytest.mark.cuda
class TestFlashD96OnCard:
    """Head dim 96 (phi-3-vision's 3072 / 32) in both bodies: the bf16
    ``wgmma`` body (m64n96k16 for p.v, six k16 steps for q.k^T) and the f32
    CUDA-core body, against the plain version with ``attn_check``'s rules
    (bf16 one ulp; f32 atol 2e-5 / rtol 1e-5): causal and not, grouped
    and not, ragged tiles, on transposed [B, S, H, D] views."""

    @pytest.mark.parametrize("dtype,s,causal,heads,strided", _FLASH_D96)
    def test_flash_attention_d96(self, dtype, s, causal, heads, strided):
        _need_card()
        h, kvh = heads
        q, k, v = _attn_inputs(1, h, kvh, s, 96, dtype, seed=s + h,
                               strided=strided)
        before = ops.flash_attention_op.launches
        with torch.no_grad():
            out = ops.flash_attention_op(q, k, v, causal=causal)
        assert ops.flash_attention_op.launches == before + 1
        ref = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == dtype
        if strided:
            assert out.transpose(1, 2).is_contiguous()
        _assert_attn_close(out, ref)

    def test_flash_attention_d96_batch_and_sq_differs(self):
        _need_card()
        for dtype in (torch.bfloat16, torch.float32):
            q, _, _ = _attn_inputs(2, 8, 4, 200, 96, dtype, seed=3)
            _, k, v = _attn_inputs(2, 8, 4, 333, 96, dtype, seed=4)
            for causal in (True, False):
                with torch.no_grad():
                    out = ops.flash_attention_op(q, k, v, causal=causal)
                _assert_attn_close(out, flash_attention_plain(
                    q, k, v, causal=causal))


def _scatter_args(idx, q, s, w):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (idx, q, s, w)]


@pytest.mark.cuda
class TestScatterTilesOnCard:
    """The tile-local scatter (count, scan, place, accumulate per output
    tile of 4096 columns) against its plain version: ``torch.equal`` where
    each sender's indices are distinct."""

    @pytest.mark.parametrize("n", [1, 2, 3, 4])
    @pytest.mark.parametrize("k,d", [(4097, 3 * 4096 + 5), (1, 4096),
                                     (12_345, 100_003)])
    def test_scatter_tiles_bitwise(self, n, k, d):
        """K not a multiple of the tile, a ragged d_out, indices on tile
        edges, slots past d_out and dropped ones."""
        _need_card()
        rng = np.random.default_rng(n * 7 + k)
        edges = np.array([0, 4095, 4096, 8191, 8192, d - 1, d, d + 5,
                          2 ** 31 - 1, -1, -7], np.int64)
        rows = []
        for _ in range(n):
            pool = np.union1d(rng.choice(d + 10, size=min(k, d + 10),
                                         replace=False), edges)
            rows.append(rng.permutation(pool)[:k] if len(pool) >= k else
                        np.concatenate([pool, -np.ones(k - len(pool),
                                                       np.int64)]))
        idx = np.stack(rows).astype(np.int32)
        idx[rng.random(idx.shape) < 0.25] = -1
        q = rng.integers(-127, 128, size=idx.shape).astype(np.int8)
        s = rng.uniform(1e-3, 2.0, size=n).astype(np.float32)
        w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
        args = _scatter_args(idx, q, s, w)
        before = ops.scatter_aggregate_op.launches
        ak, ssk = ops.scatter_aggregate_op(*args, d_out=d)
        assert ops.scatter_aggregate_op.launches == before + 1
        ap, ssp = scatter_aggregate_plain(*args, d_out=d)
        torch.cuda.synchronize()
        assert ak.shape == (d,) and torch.equal(ak, ap)
        np.testing.assert_allclose(float(ssk), float(ssp), rtol=1e-5)

    def test_scatter_tiles_all_dropped_or_outside(self):
        """No live slot: agg is all zeros, written once, and its norm 0."""
        _need_card()
        for fill in (-1, 10_000):
            idx = np.full((3, 777), fill, np.int32)
            q = np.ones((3, 777), np.int8)
            args = _scatter_args(idx, q, np.ones(3, np.float32),
                                 np.ones(3, np.float32))
            agg, ssq = ops.scatter_aggregate_op(*args, d_out=9000)
            torch.cuda.synchronize()
            assert torch.equal(agg, torch.zeros(9000, device="cuda"))
            assert float(ssq) == 0.0

    @pytest.mark.parametrize("n,k,d", [(1, 5000, 64), (4, 3000, 4100)])
    def test_scatter_tiles_duplicates_within_bound(self, n, k, d):
        """One sender repeating columns: its adds meet in shared-memory
        atomics in a varying order, within 2 m 2^-24 sum|v| per column."""
        _need_card()
        rng = np.random.default_rng(k)
        idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
        q = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
        s = rng.uniform(1e-3, 2.0, size=n).astype(np.float32)
        w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
        args = _scatter_args(idx, q, s, w)
        ak, ssk = ops.scatter_aggregate_op(*args, d_out=d)
        ap, ssp = scatter_aggregate_plain(*args, d_out=d)
        v = np.abs(q.astype(np.float64) * (s * w)[:, None])
        absum = np.bincount(idx.ravel(), v.ravel(), minlength=d)
        m = np.bincount(idx.ravel(), minlength=d).max()
        assert np.all(np.abs(ak.cpu().numpy() - ap.cpu().numpy())
                      <= 2 * m * 2.0 ** -24 * absum)
        np.testing.assert_allclose(float(ssk), float(ssp), rtol=1e-5)


@pytest.mark.cuda
class TestSlice8OnCard:
    """Jamba's attention layer (32/8 heads of 128: a GQA group of 4) in
    the flash kernel, and the reduced deepseek-v2 (MLA), jamba (16 layers:
    mamba, attention, experts on odd layers) and rwkv6 in f32 on the card
    against the CPU from the same params: loss, the "pallas" prefill's
    logits and every cache entry, 4 decode steps' logits and cache, within
    atol 1e-4 / rtol 1e-4 (f32 sums in other orders); one flash launch an
    attention layer (jamba 2, the others none); decode writes every cache
    tensor, the recurrent states too, in place."""

    @pytest.mark.parametrize("s", [48, 4096])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_flash_attention_group_of_four(self, s, dtype):
        _need_card()
        q, k, v = _attn_inputs(1, 32, 8, s, 128, dtype, seed=s + 8,
                               strided=True)
        before = ops.flash_attention_op.launches
        with torch.no_grad():
            out = ops.flash_attention_op(q, k, v)
        assert ops.flash_attention_op.launches == before + 1
        ref = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == dtype
        _assert_attn_close(out, ref)

    @pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b",
                                      "rwkv6-1.6b"])
    def test_reduced_family_card_matches_cpu(self, arch):
        _need_card()
        from repro_torch.configs import get_config
        from repro_torch.models import attention, build_model
        from repro_torch.tree import tree_flatten_with_path, tree_map
        cfg = get_config(arch).reduced()
        models = {d: build_model(cfg, dtype=torch.float32, device=d)
                  for d in ("cpu", "cuda")}
        params = models["cpu"].init(torch.Generator().manual_seed(0))
        params = {"cpu": params,
                  "cuda": tree_map(lambda t: t.cuda(), params)}
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        out = {}
        for dev, model in models.items():
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                loss, _ = model.loss_fn(params[dev], b)
            before = ops.flash_attention_op.launches
            attention.set_attention_impl("pallas")
            try:
                logits, cache = model.prefill(params[dev],
                                              {"tokens": b["tokens"]})
            finally:
                attention.set_attention_impl("blockwise")
            launches = ops.flash_attention_op.launches - before
            dec = model.init_cache(2, 8)
            ptrs = [t.data_ptr() for _, t in tree_flatten_with_path(dec)[0]]
            steps = []
            for pos in range(4):
                lg, dec = model.decode_step(params[dev], dec,
                                            b["tokens"][:, pos:pos + 1], pos)
                steps.append(lg)
            assert [t.data_ptr() for _, t in
                    tree_flatten_with_path(dec)[0]] == ptrs
            out[dev] = (loss, logits, cache, torch.stack(steps), dec,
                        launches)
        n_attn = sum(k == "a" for k in cfg.layer_kinds)
        assert out["cuda"][5] == n_attn and out["cpu"][5] == 0
        for i in (0, 1, 3):
            torch.testing.assert_close(out["cuda"][i].cpu(), out["cpu"][i],
                                       rtol=1e-4, atol=1e-4)
        for i in (2, 4):
            card = tree_flatten_with_path(out["cuda"][i])[0]
            cpu = tree_flatten_with_path(out["cpu"][i])[0]
            assert [n for n, _ in card] == [n for n, _ in cpu]
            for (name, a), (_, b) in zip(card, cpu):
                assert a.is_cuda
                torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4,
                                           msg=name)


@pytest.mark.cuda
class TestWhisperOnCard:
    """The reduced whisper-tiny (2 + 2 layers, 4/2 heads of 32, 16 frames)
    in f32 on the card against the CPU from the same params, with bf16
    stub frames as ``serve`` passes them: loss, the "pallas" prefill's
    logits, self cache and ``cross_kv``, 4 decode steps, within atol 1e-4
    / rtol 1e-4.  The prefill launches the flash kernel by the reference's
    dispatch rule (``Sq == Skv`` and a multiple of 16): the decoder's 2
    layers, the encoder's 2 (16 frames, not causal), and the cross
    layers' 2 only when the tokens are as many as the frames (16: 6
    launches; 64: 4).  Decode launches nothing, writes the self cache in
    place and leaves ``cross_kv`` as it was."""

    @pytest.mark.parametrize("seq, launches", [(16, 6), (64, 4)])
    def test_reduced_whisper_card_matches_cpu(self, seq, launches):
        _need_card()
        from repro_torch.configs import get_config
        from repro_torch.models import attention, build_model
        from repro_torch.tree import tree_flatten_with_path, tree_map
        cfg = get_config("whisper-tiny").reduced()
        models = {d: build_model(cfg, dtype=torch.float32, device=d)
                  for d in ("cpu", "cuda")}
        params = models["cpu"].init(torch.Generator().manual_seed(0))
        params = {"cpu": params,
                  "cuda": tree_map(lambda t: t.cuda(), params)}
        g = torch.Generator().manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=g)
        frames = torch.randn((2, cfg.encoder.n_frames, cfg.d_model),
                             generator=g).to(torch.bfloat16)
        out = {}
        for dev, model in models.items():
            b = {"tokens": toks.to(dev), "frontend_embeds": frames.to(dev)}
            with torch.no_grad():
                loss, _ = model.loss_fn(params[dev], {
                    **b, "labels": torch.roll(b["tokens"], -1, 1)})
            before = ops.flash_attention_op.launches
            attention.set_attention_impl("pallas")
            try:
                logits, cache = model.prefill(params[dev], b)
            finally:
                attention.set_attention_impl("blockwise")
            n_flash = ops.flash_attention_op.launches - before
            dec = model.init_cache(2, 8)
            dec["cross_kv"] = cache["cross_kv"]
            cross = [t.clone() for t in cache["cross_kv"]]
            ptrs = [t.data_ptr() for _, t in tree_flatten_with_path(dec)[0]]
            steps = []
            before = ops.flash_attention_op.launches
            for pos in range(4):
                lg, dec = model.decode_step(params[dev], dec,
                                            b["tokens"][:, pos:pos + 1], pos)
                steps.append(lg)
            assert ops.flash_attention_op.launches == before
            assert [t.data_ptr() for _, t in
                    tree_flatten_with_path(dec)[0]] == ptrs
            assert all(torch.equal(a, c)
                       for a, c in zip(dec["cross_kv"], cross))
            out[dev] = (loss, logits, cache, torch.stack(steps), dec,
                        n_flash)
        assert out["cuda"][5] == launches and out["cpu"][5] == 0
        for i in (0, 1, 3):
            torch.testing.assert_close(out["cuda"][i].cpu(), out["cpu"][i],
                                       rtol=1e-4, atol=1e-4)
        for i in (2, 4):
            card = tree_flatten_with_path(out["cuda"][i])[0]
            cpu = tree_flatten_with_path(out["cpu"][i])[0]
            assert [n for n, _ in card] == [n for n, _ in cpu]
            assert any(n.startswith("cross_kv/") for n, _ in card)
            for (name, a), (_, b) in zip(card, cpu):
                assert a.is_cuda
                torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4,
                                           msg=name)


@pytest.mark.cuda
class TestSlice12OnCard:
    """The kernels' routes on the card: a real CUDA tensor launches the
    kernel, a fake one on the card takes the shape rule (no kernel runs);
    and the in-place eq.-2 update bit-equal to the functional one on the
    card, in pieces that split no leaf evenly."""

    def test_real_and_fake_cuda_tensors(self):
        _need_card()
        from torch._subclasses.fake_tensor import FakeTensorMode
        x = torch.from_numpy(_x(1000, seed=3)).cuda()
        before = ops.quantize_op.launches
        q, s = ops.quantize_op(x)
        qp, sp = quantize_plain(torch.nn.functional.pad(x, (0, 24)))
        assert torch.equal(q, qp) and torch.equal(s, sp)
        assert ops.quantize_op.launches == before + 1
        with FakeTensorMode():
            xf = torch.empty(1000, device="cuda")
            assert ops._route(xf, "t") == ops.SHAPE
            qf, sf = ops.quantize_op(xf)
        assert qf.device.type == "cuda" and qf.shape == q.shape
        assert sf.shape == s.shape and qf.dtype == torch.int8
        assert ops.quantize_op.launches == before + 1   # no kernel ran

    def test_inplace_update_bitwise(self):
        _need_card()
        from repro_torch.optim import (MomentumState, momentum_sgd_update,
                                       momentum_sgd_update_)
        gen = torch.Generator(device="cuda").manual_seed(0)
        shapes = [(1000, 77), (5,), (3, 4096)]

        def tree(dtype):
            return {f"l{i}": torch.randn(s, generator=gen, device="cuda")
                    .to(dtype) for i, s in enumerate(shapes)}

        params, grads = tree(torch.bfloat16), tree(torch.bfloat16)
        state = MomentumState(history=tree(torch.float32))
        want_p, want_s = momentum_sgd_update(params, grads, state, lr=1e-3,
                                             weight_decay=1e-2)
        momentum_sgd_update_(params, grads, state, lr=1e-3,
                             weight_decay=1e-2, chunk=999)
        for k in params:
            assert torch.equal(params[k], want_p[k])
            assert torch.equal(state.history[k], want_s.history[k])
