// Block-wise symmetric int8 quantization of a flat f32 update (the wire
// encode of the MLfabric-A parameter-server path), and its inverse.  The
// reference keeps both Pallas kernels in one module; so does this file.
//
// ---- quantize --------------------------------------------------------------
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

#include <cuda_bf16.h>
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


// ---- dequantize ------------------------------------------------------------
// Replaces: src/repro/kernels/quantize.py:dequantize (Pallas body
// _dequant_kernel), reached from src/repro/kernels/ops.py:dequantize_op: the
// unfused receive composition dequantize -> stack -> grad_aggregate that
// the fused dequant_aggregate kernel stands against.
//
//   x[i] = float(q[i]) * scales[i / block]     (one product, IEEE-rounded)
//
// cast to bf16 (round to nearest even) for a bf16 output.
//
// What bounds it on an H100: bytes.  It reads D int8 and D/block f32 scales
// (D + D/64 bytes at block 256) and writes 4D bytes (2D for bf16), one
// multiply per element.  At D = 494,147,584 that is 2.478 GB, 0.740 ms at
// 3.35 TB/s, the same bound as quantize's.
// Design: each thread loads 16 values of q with one 16-byte load (a warp
// reads 512 contiguous bytes) and stores 16 results with four float4
// stores (four 8-byte stores of bf16 pairs).  A store instruction must
// write contiguous bytes across the warp to run at the memory's rate; a
// thread's own 16 results span 64 bytes, so storing them itself would
// scatter every store instruction over 2 KiB (the first version did that
// and ran at half the bound).  So the warp stages its 512 payload bytes in
// shared memory, and store j of lane l converts the 4 values at
// 128 j + 4 l of the warp's span: each store instruction then writes
// 512 (bf16: 256) contiguous bytes.  Every 4 values lie in one block
// (block is a multiple of 16), whose scale the lane reads once for them.
// Where q is not 16-byte aligned (a view into a larger payload) the launch
// picks the same kernel with byte loads, lane l loading bytes l, l + 32,
// ... of the span, so those loads stay coalesced too; q is never copied to
// align it.  The output is the wrapper's fresh allocation, 16-byte
// aligned.  64-bit offsets throughout.

constexpr int kDqPerThread = 16;                  // payload bytes a lane loads
constexpr int kDqWarpSpan = 32 * kDqPerThread;    // 512 values a warp
constexpr int kDqWarps = 8;

template <bool kAligned, bool kBf16>
__global__ void __launch_bounds__(32 * kDqWarps)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, void* __restrict__ out,
                  int64_t d, int64_t block) {
  __shared__ __align__(16) int8_t stage[kDqWarps][kDqWarpSpan];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t span0 =
      (static_cast<int64_t>(blockIdx.x) * kDqWarps + warp) * kDqWarpSpan;
  if (span0 >= d) return;                 // whole warp leaves together
  const int64_t valid = d - span0 < kDqWarpSpan ? d - span0 : kDqWarpSpan;
  int8_t* st = stage[warp];

  if (kAligned) {                         // d % 16 == 0: whole 16-byte loads
    if (static_cast<int64_t>(lane) * kDqPerThread < valid)
      *reinterpret_cast<int4*>(st + lane * kDqPerThread) =
          __ldg(reinterpret_cast<const int4*>(q + span0) + lane);
  } else {
#pragma unroll
    for (int i = 0; i < kDqPerThread; ++i) {
      const int off = lane + 32 * i;
      if (off < valid) st[off] = q[span0 + off];
    }
  }
  __syncwarp();

#pragma unroll
  for (int j = 0; j < kDqPerThread / 4; ++j) {
    const int off = 128 * j + 4 * lane;   // 4 values, never across a block
    if (off >= valid) break;
    const int64_t i0 = span0 + off;
    const float scale = __ldg(scales + i0 / block);
    const char4 v = *reinterpret_cast<const char4*>(st + off);
    const float x0 = static_cast<float>(v.x) * scale;
    const float x1 = static_cast<float>(v.y) * scale;
    const float x2 = static_cast<float>(v.z) * scale;
    const float x3 = static_cast<float>(v.w) * scale;
    if (kBf16) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(x0, x1);
      const __nv_bfloat162 b = __floats2bfloat162_rn(x2, x3);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&a);
      packed.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i0) =
          packed;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + i0) =
          make_float4(x0, x1, x2, x3);
    }
  }
}

template <bool kBf16>
int launch_dequantize(const int8_t* q, const float* scales, void* out,
                      int64_t d, int64_t block, cudaStream_t s) {
  const int64_t spans = (d + kDqWarpSpan - 1) / kDqWarpSpan;
  const int64_t grid = (spans + kDqWarps - 1) / kDqWarps;
  if (reinterpret_cast<uintptr_t>(q) % 16 == 0)
    dequantize_kernel<true, kBf16>
        <<<static_cast<unsigned int>(grid), 32 * kDqWarps, 0, s>>>(
            q, scales, out, d, block);
  else
    dequantize_kernel<false, kBf16>
        <<<static_cast<unsigned int>(grid), 32 * kDqWarps, 0, s>>>(
            q, scales, out, d, block);
  return static_cast<int>(cudaGetLastError());
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

// q: int8 [d], any address; scales: f32 [d / block], 4-byte aligned; out:
// f32 (out_bf16 = 0) or bf16 (1) [d], 16-byte aligned.  block % 16 == 0 and
// d % block == 0 (the wrapper checks both).  Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted); -1 for an
// argument the kernel does not take.
extern "C" int repro_dequantize(const int8_t* q, const float* scales,
                                void* out, int64_t d, int64_t block,
                                int out_bf16, void* stream) {
  if (block <= 0 || block % kDqPerThread || d % block ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return -1;
  if (d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_dequantize<true>(q, scales, out, d, block, s)
                  : launch_dequantize<false>(q, scales, out, d, block, s);
}

extern "C" const char* repro_error_string(int rc) {
  if (rc < 0) return "argument refused by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
