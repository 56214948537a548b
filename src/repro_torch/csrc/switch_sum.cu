// Exact int32 column sums of int8 rows that share one scale (the in-network
// switch of the MLfabric step's "switch" and "hierarchical" backends: the
// pod's members quantize against one shared scale, and the switch adds
// their int8 payloads in fixed point).
//
// Replaces: src/repro/kernels/switch_sum.py:switch_sum (Pallas body
// _switch_sum_kernel), reached from
// src/repro/dist/collectives.py:_intra_pod_switch_sum.
//
//   out[c] = sum_n q[n, c]   in int32, for c < orig_len
//
// Integer sums are exact in any order (N * 127 fits int32 for N < 2^24), so
// the output is bit-equal to the plain version at every N.
//
// What bounds it on an H100: bytes.  It reads N * D_pad int8 and writes
// 4 * orig_len bytes with one add per input byte; on the full-width
// embedding bucket (D_pad = orig_len = 136,249,344) that is 0.203, 0.244 and
// 0.325 ms at 3.35 TB/s for N = 1, 2 and 4; at N=1 the int32 writes are
// four-fifths of the traffic.
// Design: each thread owns 4 adjacent columns.  It walks the N rows in
// order with one 4-byte load per row (a warp reads 128 contiguous bytes),
// widens the 4 bytes into 4 int32 sums held in registers, and writes them
// with one 16-byte store (a warp writes 512 contiguous bytes).  Every input
// byte is read once and every output written once.  A first version gave
// each thread 16 columns (one 16-byte load per row, four 16-byte stores);
// its lanes stored 64 bytes apart, and at N=1, where the writes are most of
// the traffic, it took 1.8x as long on an H100 (see PERF.md).  The Pallas
// kernel's `window` (switch slot) tiling has no role here: a row is 4-byte
// aligned because D_pad is a multiple of the window and the wrapper refuses
// rows that are not.  The orig_len tail is masked element by element.
// 64-bit offsets: a [4, 136M] payload is 545 MB, and larger fan-ins pass
// INT32_MAX.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                       // columns per thread

// byte i of `w` as a signed value
__device__ __forceinline__ int32_t sbyte(uint32_t w, int i) {
  return static_cast<int32_t>(w << (24 - 8 * i)) >> 24;
}

__global__ void __launch_bounds__(kThreads)
switch_sum_kernel(const int8_t* __restrict__ q, int32_t* __restrict__ out,
                  int64_t n_rows, int64_t d_pad, int64_t d_out) {
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x) * kCols;
  if (c0 >= d_out) return;
  int32_t acc[kCols] = {0, 0, 0, 0};
  for (int64_t n = 0; n < n_rows; ++n) {
    // c0 + 4 <= d_pad: d_pad is a multiple of 4 and c0 < d_out <= d_pad
    const uint32_t w = *reinterpret_cast<const uint32_t*>(q + n * d_pad + c0);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] += sbyte(w, j);
  }
  if (c0 + kCols <= d_out) {
    // out is a fresh, 16-byte aligned buffer and c0 % 4 == 0
    *reinterpret_cast<int4*>(out + c0) =
        make_int4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    for (int j = 0; j < kCols && c0 + j < d_out; ++j) out[c0 + j] = acc[j];
  }
}

}  // namespace

// q: int8 [n_rows, d_pad] contiguous, 4-byte aligned, d_pad % 4 == 0;
// out: int32 [d_out], 16-byte aligned, 0 < d_out <= d_pad.  Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int repro_switch_sum(const int8_t* q, int32_t* out, int64_t n_rows,
                                int64_t d_pad, int64_t d_out, void* stream) {
  if (d_out <= 0) return 0;
  const int64_t per_cta = static_cast<int64_t>(kThreads) * kCols;
  const int64_t grid = (d_out + per_cta - 1) / per_cta;
  switch_sum_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(q, out, n_rows,
                                                            d_pad, d_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
