// Block-wise symmetric int8 quantization of a flat f32 update (the wire
// encode of the MLfabric-A parameter-server path).
//
// Replaces: src/repro/kernels/quantize.py:quantize (Pallas body
// _quant_kernel), reached from src/repro/dist/flatbuf.py:flat_compress_roundtrip.
//
// Per 256-element block:
//   scale = max(max|x| * f32(1/127), 1e-30)
//   q     = clip(rint(x / scale), -127, 127)      (half to even, never -128)
// The scale is a multiply by the f32 reciprocal of 127, not a division:
// under jit XLA rewrites the reference's `max|x| / 127.0` into that multiply,
// so this is what the reference's main path computes.  `x / scale` stays a
// true IEEE division: build without --use_fast_math, -prec-div=false or
// -ftz=true, any of which breaks bit-equality of q.
//
// What bounds it on an H100: bytes.  Per element it reads 4 bytes and writes
// 1 (+ 4 bytes of scale per 256 elements) and does a handful of flops, far
// below the ~295 flops/byte where the card stops being memory-bound.
// Design: one warp per quantization block.  Each lane reads its 8 floats as
// two 16-byte loads (a warp reads its 1 KiB block in 8 fully coalesced
// 128-byte transactions), keeps them in registers, reduces max|x| with warp
// shuffles (no shared memory, no second read of x) and writes its 8 int8 as
// one 8-byte store.  Each block is read exactly once and written once.
// x may be any contiguous f32 view (the in-graph step quantizes bucket views
// of the flat gradient, which start wherever the bucket's first leaf does):
// where x is not 16-byte aligned the launch picks the same kernel with
// scalar loads instead, lane l taking elements l, l+32, ... of its block (a
// warp still reads 128 contiguous bytes per load), and byte stores.  Both
// variants compute the same values; x is never copied to align it.
// All offsets are 64-bit: a full-width qwen2-0.5b update is ~4.9e8 floats,
// within 8% of INT32_MAX in bytes, and larger models pass it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;               // elements per quantization block
constexpr int kWarpsPerCta = 8;           // quantization blocks per CTA
constexpr int kPerLane = kBlock / 32;     // 8 floats = two float4 per lane

__device__ __forceinline__ uint32_t quant4(const float* v, float scale) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float r = fminf(fmaxf(rintf(v[i] / scale), -127.0f), 127.0f);
    word |= static_cast<uint32_t>(static_cast<uint8_t>(
                static_cast<int8_t>(static_cast<int>(r))))
            << (8 * i);
  }
  return word;
}

__device__ __forceinline__ int8_t quant1(float v, float scale) {
  return static_cast<int8_t>(
      static_cast<int>(fminf(fmaxf(rintf(v / scale), -127.0f), 127.0f)));
}

template <bool kAligned>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // whole warp leaves together
  // aligned: lane owns elements [8*lane, 8*lane + 8) of the block;
  // unaligned: lane owns elements lane, lane + 32, ..., lane + 224
  const int64_t base = blk * kBlock +
                       (kAligned ? static_cast<int64_t>(lane) * kPerLane
                                 : static_cast<int64_t>(lane));

  float v[kPerLane];
  if (kAligned) {
    const float4* src = reinterpret_cast<const float4*>(x + base);
    const float4 a = src[0];
    const float4 b = src[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = x[base + 32 * i];
  }

  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  const float scale = fmaxf(m * (1.0f / 127.0f), 1e-30f);
  if (kAligned) {
    const uint2 packed = make_uint2(quant4(v, scale), quant4(v + 4, scale));
    *reinterpret_cast<uint2*>(q + base) = packed;
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) q[base + 32 * i] = quant1(v[i], scale);
  }
  if (lane == 0) scales[blk] = scale;
}

}  // namespace

// x: f32 [n_blocks * 256], 4-byte aligned (16-byte aligned takes the
// vector loads); q: int8 [n_blocks * 256], 8-byte aligned; scales: f32
// [n_blocks].  Launches on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int repro_quantize(const float* x, int8_t* q, float* scales,
                              int64_t n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  const int64_t grid = (n_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0)
    quantize_kernel<true><<<static_cast<unsigned int>(grid),
                            32 * kWarpsPerCta, 0, s>>>(x, q, scales, n_blocks);
  else
    quantize_kernel<false><<<static_cast<unsigned int>(grid),
                             32 * kWarpsPerCta, 0, s>>>(x, q, scales,
                                                        n_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_quantize_block() { return kBlock; }

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
