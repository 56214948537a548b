// Fused int8 dequantize -> weighted aggregate -> sum of squares (the wire
// decode of the MLfabric-A parameter-server path and, with N > 1, the
// aggregator host's receive path).
//
// Replaces: src/repro/kernels/dequant_aggregate.py:dequant_aggregate
// (Pallas body _fused_kernel), reached from
// src/repro/dist/flatbuf.py:flat_compress_roundtrip with N=1, w=1.
//
//   agg[c] = sum_n w[n] * (q[n, c] * scales[n, c / block]),  c < orig_len
//   partial[b] = sum of agg[c]^2 over the live columns of CTA b
// The wrapper sums `partial` (the reference sums its per-tile partials
// outside the kernel the same way); no atomics, so the result is the same
// from run to run.
//
// What bounds it on an H100: bytes.  Per column it reads N int8 (+ N scales
// per block) and writes one f32; the flops are negligible.
// Design: a CUDA grid cannot carry a sum from one grid step to the next the
// way the Pallas N-chunk grid axis carries it in VMEM, so each thread owns 4
// adjacent columns and loops over all N rows itself, keeping the 4 sums in
// registers: payload is read once, agg is written once, and no f32 copy of
// a dequantized row ever reaches device memory.  Only rows n < N are read,
// so no out-of-range row (the ragged N chunk the Pallas kernel has to mask)
// can leak garbage into the sum.  Columns in [orig_len, D_pad) are neither
// written nor counted in the norm.  The products and sums are rounded one
// at a time (__fmul_rn/__fadd_rn, no FMA contraction) in row order, so the
// result is bit-equal to the plain loop in dequant_aggregate.py.  64-bit
// offsets throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                      // columns per thread
constexpr int kTile = kThreads * kCols;       // columns per CTA

__global__ void __launch_bounds__(kThreads)
dequant_aggregate_kernel(const int8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         const float* __restrict__ w, float* __restrict__ out,
                         float* __restrict__ partial, int64_t n_rows,
                         int64_t d_pad, int64_t d_out, int64_t block) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     static_cast<int64_t>(threadIdx.x) * kCols;
  float acc[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ssq = 0.0f;
  if (c0 < d_out) {
    // block % 4 == 0 and c0 % 4 == 0: the 4 columns share one scale, and
    // c0 + 3 < d_pad, so the 4-byte payload load stays in bounds
    const int64_t n_scales = d_pad / block;
    const int64_t sb = c0 / block;
    for (int64_t n = 0; n < n_rows; ++n) {
      const char4 qq = *reinterpret_cast<const char4*>(q + n * d_pad + c0);
      const float s = scales[n * n_scales + sb];
      const float wn = w[n];
      acc[0] = __fadd_rn(acc[0], __fmul_rn(__fmul_rn(float(qq.x), s), wn));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(__fmul_rn(float(qq.y), s), wn));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(__fmul_rn(float(qq.z), s), wn));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(__fmul_rn(float(qq.w), s), wn));
    }
    if (c0 + kCols <= d_out) {
      *reinterpret_cast<float4*>(out + c0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) ssq += acc[j] * acc[j];
    } else {
      for (int j = 0; j < kCols && c0 + j < d_out; ++j) {
        out[c0 + j] = acc[j];
        ssq += acc[j] * acc[j];
      }
    }
  }

  // CTA-wide sum of ssq: warp shuffles, then one warp over the warp sums
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ssq += __shfl_xor_sync(0xffffffffu, ssq, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ssq;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) partial[blockIdx.x] = v;
  }
}

}  // namespace

// q: int8 [n_rows, d_pad], 4-byte aligned; scales: f32 [n_rows, d_pad/block];
// w: f32 [n_rows]; out: f32 [d_out], 16-byte aligned; partial: f32
// [ceil(d_out / 1024)].  block % 4 == 0, d_pad % block == 0,
// 0 < d_out <= d_pad.  Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_dequant_aggregate(const int8_t* q, const float* scales,
                                       const float* w, float* out,
                                       float* partial, int64_t n_rows,
                                       int64_t d_pad, int64_t d_out,
                                       int64_t block, void* stream) {
  if (d_out <= 0) return 0;
  const int64_t grid = (d_out + kTile - 1) / kTile;
  dequant_aggregate_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q, scales, w, out, partial, n_rows, d_pad, d_out, block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t repro_dequant_aggregate_tile() { return kTile; }

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
