// Sparse int8 chunks -> dense weighted aggregate -> sum of squares (the
// receiving end of the bounded-loss cross-pod stage, `keep_inter`: every pod
// ships its top-k coordinates as (idx int32, q int8, one f32 scale)).
//
// Replaces: src/repro/kernels/scatter_aggregate.py:scatter_aggregate (Pallas
// body _scatter_kernel), reached from
// src/repro/dist/collectives.py:_inter_pod_aggregate_sparse.
//
//   agg[c]     = sum over senders n, in order, and slots k with idx[n,k] == c
//                of q[n,k] * (scale[n] * w[n])
//   partial[b] = sum of agg[c]^2 over the columns of CTA b
// Slots with idx < 0 (transport-dropped) or idx >= d_out add nothing.  The
// wrapper sums `partial`.
//
// What bounds it on an H100: bytes.  The least traffic is each slot read
// once (5 bytes), the scales and weights once, and agg written once:
// 5*N*K + 8*N + 4*d_out bytes.  At K = 13,624,934 and d_out = 136,249,344
// (the full-width embedding bucket at keep 0.1) that is 0.183, 0.203 and
// 0.244 ms at 3.35 TB/s for N = 1, 2 and 4.  This simple design sits well
// above it: every random 4-byte read-modify-write costs a 32-byte sector,
// and the zero fill and the norm pass each cost a pass over d_out.
// Design: the TPU kernel scatters by a one-hot matmul on the MXU, comparing
// every slot with every column (N*K*D multiply-adds, 1.9e15 per sender on
// that bucket); Hopper has a scatter, so the work here is O(N*K + d_out):
//   1. cudaMemsetAsync zeroes agg;
//   2. one launch per sender, in order on the stream (N is the pod count),
//      one slot per thread: atomicAdd(&agg[idx], q * (scale * w));
//   3. one pass over agg writes per-CTA partials of agg^2, 4 columns a
//      thread, as grad_aggregate.cu does.
// Within one pass a column with one contributor gets exactly agg + v, and
// the passes run in sender order, so where idx is distinct within a sender
// (top-k indices are) agg is bit-equal to the plain in-order loop.
// Duplicates within one sender meet in an order that varies from run to
// run.  Float atomics flush subnormal inputs and results to zero, so
// bit-equality also needs every product and sum to be 0 or normal; it is
// where scale * w >= 2^-100 (the scale floor 1e-30 with w = 1, as on the
// path), since every value is then a multiple of 2^-123.
// The product is formed as the Pallas kernel forms it, q * (scale * w), each
// rounded apart (__fmul_rn: no contraction), not as the oracle's
// (q * scale) * w.  64-bit offsets throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                      // norm pass: columns per thread
constexpr int kTile = kThreads * kCols;       // norm pass: columns per CTA

__global__ void __launch_bounds__(kThreads)
scatter_pass_kernel(const int32_t* __restrict__ idx,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    const float* __restrict__ weights, float* agg,
                    int64_t sender, int64_t k, int64_t d_out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= k) return;
  const int64_t slot = sender * k + t;
  const int32_t c = idx[slot];
  if (c < 0 || c >= d_out) return;
  const float sw = __fmul_rn(scales[sender], weights[sender]);
  atomicAdd(agg + c, __fmul_rn(static_cast<float>(q[slot]), sw));
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const float* __restrict__ agg, float* __restrict__ partial,
             int64_t d_out) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     static_cast<int64_t>(threadIdx.x) * kCols;
  float ssq = 0.0f;
  if (c0 + kCols <= d_out) {
    const float4 v = *reinterpret_cast<const float4*>(agg + c0);  // aligned
    ssq = v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  } else {
    for (int64_t c = c0; c < d_out; ++c) ssq += agg[c] * agg[c];
  }
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

// idx: int32 [n, k]; q: int8 [n, k]; scales, weights: f32 [n], all
// contiguous on the card; agg: f32 [d_out], 16-byte aligned; partial: f32
// [ceil(d_out / 1024)].  Launches on `stream` (a fill, n scatter passes and
// a norm pass) and returns the first CUDA error (0 when all were accepted).
extern "C" int repro_scatter_aggregate(const int32_t* idx, const int8_t* q,
                                       const float* scales,
                                       const float* weights, float* agg,
                                       float* partial, int64_t n, int64_t k,
                                       int64_t d_out, void* stream) {
  if (d_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(agg, 0, d_out * sizeof(float), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t grid = (k + kThreads - 1) / kThreads;
  for (int64_t j = 0; j < n && k > 0; ++j) {
    scatter_pass_kernel<<<static_cast<unsigned int>(grid), kThreads, 0, s>>>(
        idx, q, scales, weights, agg, j, k, d_out);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int64_t norm_grid = (d_out + kTile - 1) / kTile;
  sumsq_kernel<<<static_cast<unsigned int>(norm_grid), kThreads, 0, s>>>(
      agg, partial, d_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t repro_scatter_aggregate_tile() { return kTile; }

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
