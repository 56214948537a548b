// Fused weighted gradient aggregation + sum of squares (the aggregator's
// compute of the in-graph MLfabric step: the cross-pod stage of every
// bucket without compression, N = number of pods).
//
// Replaces: src/repro/kernels/grad_aggregate.py:grad_aggregate (Pallas body
// _agg_kernel), reached from src/repro/dist/collectives.py:_inter_pod_aggregate.
//
//   agg[c]     = sum_n w[n] * u[n, c]   in f32, rows in order, then cast to
//                                        u's dtype (f32 or bf16)
//   partial[b] = sum of agg[c]^2 of the f32 agg over the columns of CTA b
// The wrapper sums `partial`, as the reference sums its per-tile partials
// outside the kernel; no atomics, so the norm repeats from run to run.
//
// What bounds it on an H100: bytes.  It reads N*D inputs and writes D
// outputs with two flops per input; at N=1, f32 and the full-width
// embedding bucket (D = 136,249,344) that is 1.09 GB, about 0.33 ms at
// 3.35 TB/s.
// Design: a CUDA grid cannot carry the row sum from one grid step to the
// next the way the Pallas kernel keeps its [N, block_d] tile in VMEM, so
// each thread owns 4 adjacent columns and loops over the N rows itself,
// keeping the 4 sums in registers: every input is read once and agg is
// written once.  Products and sums are rounded one at a time
// (__fmul_rn/__fadd_rn: nvcc may not contract them into an FMA), in row
// order, so agg is bit-equal to the plain loop in grad_aggregate.py.  A
// ragged last tile is masked here, with no pad copy.  Rows are read with
// one 16-byte (f32) or 8-byte (bf16) load per thread when the input and
// every row start are aligned for it, and element by element otherwise,
// chosen at launch: a bucket is a view into the flat gradient and may
// start anywhere.  64-bit offsets: [4, 136M] f32 is 2.2 GB, past INT32_MAX.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                      // columns per thread
constexpr int kTile = kThreads * kCols;       // columns per CTA

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static void load4(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static float load1(const float* p) { return *p; }
  __device__ static void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static void store1(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  // bf16 -> f32 is exact: the 16 bits are the top half of the f32
  __device__ static float widen(uint32_t bits16) {
    return __uint_as_float(bits16 << 16);
  }
  __device__ static uint32_t narrow(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static void load4(const __nv_bfloat16* p, float* v) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = widen(x.x & 0xffffu); v[1] = widen(x.x >> 16);
    v[2] = widen(x.y & 0xffffu); v[3] = widen(x.y >> 16);
  }
  __device__ static float load1(const __nv_bfloat16* p) {
    return widen(__bfloat16_as_ushort(*p));
  }
  __device__ static void store4(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(narrow(v[0]) | (narrow(v[1]) << 16),
                   narrow(v[2]) | (narrow(v[3]) << 16));
  }
  __device__ static void store1(__nv_bfloat16* p, float v) {
    *p = __ushort_as_bfloat16(static_cast<unsigned short>(narrow(v)));
  }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
grad_aggregate_kernel(const T* __restrict__ u, const float* __restrict__ w,
                      T* __restrict__ out, float* __restrict__ partial,
                      int64_t n_rows, int64_t d) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     static_cast<int64_t>(threadIdx.x) * kCols;
  float ssq = 0.0f;
  if (c0 < d) {
    float acc[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
    // kVec: d % 4 == 0, so c0 < d means all 4 columns are live
    const bool full = kVec || c0 + kCols <= d;
    for (int64_t n = 0; n < n_rows; ++n) {
      const T* row = u + n * d + c0;
      const float wn = w[n];
      float v[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kVec) {
        Io<T>::load4(row, v);
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (c0 + j < d) v[j] = Io<T>::load1(row + j);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], wn));
    }
    if (full) {
      Io<T>::store4(out + c0, acc);   // out is a fresh, aligned buffer
#pragma unroll
      for (int j = 0; j < kCols; ++j) ssq += acc[j] * acc[j];
    } else {
      for (int j = 0; j < kCols && c0 + j < d; ++j) {
        Io<T>::store1(out + c0 + j, acc[j]);
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

template <typename T>
int launch(const void* u, const float* w, void* out, float* partial,
           int64_t n_rows, int64_t d, cudaStream_t stream) {
  const int64_t grid = (d + kTile - 1) / kTile;
  const bool vec = d % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(u) % (kCols * sizeof(T)) == 0;
  const T* uu = static_cast<const T*>(u);
  T* oo = static_cast<T*>(out);
  if (vec)
    grad_aggregate_kernel<T, true><<<static_cast<unsigned int>(grid),
                                     kThreads, 0, stream>>>(
        uu, w, oo, partial, n_rows, d);
  else
    grad_aggregate_kernel<T, false><<<static_cast<unsigned int>(grid),
                                      kThreads, 0, stream>>>(
        uu, w, oo, partial, n_rows, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u: [n_rows, d] contiguous, f32 (dtype 0) or bf16 (dtype 1), aligned to its
// element; w: f32 [n_rows]; out: [d] of u's dtype, 16-byte aligned;
// partial: f32 [ceil(d / 1024)].  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int repro_grad_aggregate(const void* u, const float* w, void* out,
                                    float* partial, int64_t n_rows, int64_t d,
                                    int dtype, void* stream) {
  if (d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(u, w, out, partial, n_rows, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, w, out, partial, n_rows, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t repro_grad_aggregate_tile() { return kTile; }

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
