// Forward flash attention: causal (or not) online-softmax attention with
// grouped KV heads, the prefill attention of the dense decoder.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (Pallas
// body _flash_kernel), reached from src/repro/models/attention.py
// blockwise_attention under set_attention_impl("pallas") when Sq == Skv.
//
//   q: [B, H, Sq, D], k, v: [B, KVH, Skv, D], out: [B, H, Sq, D], any
//   strides with a unit last stride (so the model's [B, S, H, D] tensors
//   are read and written through transposed views, with no copy).
//   Head h reads KV head h / (H / KVH).  Scores s = (q . k) * scale in f32,
//   masked to -1e30 where causal and k_pos > q_pos (no offset: the Pallas
//   kernel's mask), online softmax over key tiles, out = acc / max(l,
//   1e-30) cast to q's dtype (f32 or bf16).  p stays f32, as in the Pallas
//   kernel: p . v is exact products of p and v summed in f32.
//
// What bounds it on an H100: operations.  A causal call does
// 4 * D * H * B * S(S+1)/2 flops (two products of every unmasked (q, k)
// pair); at S = 32768, B = 1, H = 14, D = 64 that is 1.92e12, 1.95 ms at the
// 989 TFLOP/s of the bf16 tensor cores, against 0.04 ms for its 134 MB of
// q, k, v and out.  The exps (one per unmasked pair, 7.5e9 there) take
// about 1.9 ms on the SFUs (16 a clock per SM): a second floor beside the
// products, which this design does not hide (the softmax of a tile runs
// between its two products, in the same warps).
//
// Two kernels, chosen by dtype:
//
// * bf16 (flash_kernel_wgmma): the tensor cores.  One CTA of one warpgroup
//   (128 threads) per (64-row q tile, b * h); the grid's x is b * h and its
//   y the q tile, longest tile first, so the causal triangle's long tiles
//   start early and the short ones fill in at the end.
//   - q.k^T: bf16 wgmma m64n64k16 with f32 accumulation, Q and the K tile
//     both K-major in shared memory.  bf16 x bf16 products are exact in f32,
//     so the scores are the plain version's up to summation order.
//   - p.v: p is split into three bf16 terms, p = p1 + p2 + p3, exactly (each
//     residual p - p1, then - p2, is exact in f32, and 3 x 8 significand bits
//     cover f32's 24), and three bf16 wgmma m64nDk16 accumulate p1.v, p2.v
//     and p3.v into one f32 accumulator: every product is exact, as in the
//     f32 plain version.  p goes from the score accumulator straight into
//     the register A operand (for 16-bit types the accumulator fragment's
//     layout is the A fragment's), so it never touches shared memory; V is
//     read N-major (the transpose bit).  That is 4 products' worth of
//     tensor-core work per pair instead of 2: its own bound is twice the
//     all-tensor-core one.
//   - K and V arrive by cp.async (16 bytes a thread, zero-filled past Skv
//     and Sq) into a ring of two stages: tile kt + 1 loads while tile kt is
//     computed.  Shared memory holds the tiles in wgmma's no-swizzle layout
//     of 8-row x 16-byte core matrices, which is also the order of the
//     copies, so the 16-byte stores meet no bank conflict.
//   - Each tile's p.v goes into a fresh accumulator, and the running sum
//     acc = acc * alpha + pv is taken on the CUDA cores, rounded to
//     nearest as in the plain version.  The tensor cores' own f32 sums lean
//     one way: one tile's p.v summed 512 times through them on an H100 is
//     off by 1.3e-7 (mean, signed) and 7.2e-5 (largest) of the column's
//     absolute sum, against -9e-9 and 3.2e-6 this way
//     (scripts/probe_kernels.py), and a 32k prefill summed through them
//     broke the one-ulp check.
//   - Softmax in the plain version's order: mask, row max, exp, rescale,
//     sum.  The exponentials are base 2 of scores prescaled by
//     scale * log2(e), one FFMA and one SFU ex2 each: the instruction
//     exp2f is built on, without exp2f's rescale of results below 2^-126
//     (they flush to zero: such a p lies below an ulp of every sum it
//     enters, whose largest term is 1).  On the H100 the bf16 body is
//     bound by these per-score instructions (mask, max, exp, sum, the
//     three-term split), not by the tensor cores: a two-term split, with a
//     third less tensor-core work, ran no faster.
//     The division is IEEE.  Only the tiles that straddle the diagonal or
//     Skv are masked.
// * f32 (flash_kernel): the CUDA cores.  One CTA of 128
//   threads per (64-row q tile, b * h); the q tile and each 64-key K and V
//   tile staged in shared memory; each thread holds a 4 x 8 block of the
//   score tile and 4 rows x D/8 columns of the accumulator; P goes through
//   shared memory for the P.V product.
//
// In both: keys past Skv (a ragged last tile) are masked like causal ones; a
// ragged q tile computes zero rows and stores nothing for them.  Causal tile
// skip: a key tile that starts past the q tile's last row is not visited.
// This is exact, not an approximation: for such a tile every score is
// -1e30, so m_new = m_prev, alpha = exp(0) = 1 and p = exp(-1e30 - m_prev)
// = 0, and the state (m, l, acc) would come out unchanged bit for bit.  Key
// 0 is visited first and is unmasked for every row, so m is a real score
// from the first tile on and no row is fully masked.  64-bit offsets
// throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --------------------------------------------------------------------------
// f32: the CUDA cores
// --------------------------------------------------------------------------

constexpr int kBQ = 64;            // q rows per CTA
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;      // 16 (ty) x 8 (tx)
constexpr int kLdP = kBK + 8;      // padded row of the P tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

struct Strides {
  int64_t q[4], k[4], v[4], o[4];  // in elements: batch, head, seq, dim
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;   // elements per 16-byte load
  __device__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Rows [r0, r0 + 64) of a [S, D] slab (row stride `ld_g` elements) into
// shared f32 rows of `ld_s` floats; rows at or past `n` are zero.
template <typename T, int D>
__device__ void load_tile(const T* __restrict__ g, int64_t ld_g, int64_t r0,
                          int64_t n, float* __restrict__ s, int ld_s) {
  constexpr int kV = Io<T>::kVec;
  constexpr int kPerRow = D / kV;
  constexpr int kChunks = 64 * kPerRow;
#pragma unroll
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kV;
    float v[kV];
    if (r0 + r < n) {
      Io<T>::load(g + (r0 + r) * ld_g + col, v);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kV; i += 4)
      *reinterpret_cast<float4*>(s + r * ld_s + col + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 4) + kBK * D + kBQ * kLdP;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides st, int h_q,
             int group, int64_t sq, int64_t skv, float scale, int causal,
             int64_t n_qt) {
  constexpr int kLd = D + 4;       // padded row of the Q and K tiles
  constexpr int kC = D / 32;       // float4 column groups of a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;      // [kBK][kLd]
  float* vs = ks + kBK * kLd;      // [kBK][D]
  float* ps = vs + kBK * D;        // [kBQ][kLdP]

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / h_q, h = bh % h_q, kh = h / group;
  const int64_t q0 = (n_qt - 1 - static_cast<int64_t>(blockIdx.y)) * kBQ;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + kh * st.k[1];
  const T* vb = v + b * st.v[0] + kh * st.v[1];
  T* ob = o + b * st.o[0] + h * st.o[1];

  const int tx = threadIdx.x & 7;   // keys tx + 8 j; columns tx * 4 + 32 c
  const int ty = threadIdx.x >> 3;  // rows ty + 16 i

  load_tile<T, D>(qb, st.q[2], q0, sq, qs, kLd);

  float m[4], l[4], acc[4][4 * kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kC; ++c) acc[i][c] = 0.0f;
  }

  // causal: keys from q0 + kBQ on are above the diagonal for every row of
  // the tile, so their tiles are skipped (exact, see the note above)
  const int64_t k_end = causal && q0 + kBQ < skv ? q0 + kBQ : skv;
  const int64_t n_kt = (k_end + kBK - 1) / kBK;
  for (int64_t kt = 0; kt < n_kt; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(kb, st.k[2], k0, skv, ks, kLd);
    load_tile<T, D>(vb, st.v[2], k0, skv, vs, D);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t col = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (col >= skv || (causal && col > row)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 8 threads of a row are lanes that differ in their low 3 bits
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ps[(ty + 16 * i) * kLdP + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLdP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (kk + u) * D + tx * 4 + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * c + 0] = fmaf(p, vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(p, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * c + e] / den;
      Io<T>::store4(ob + row * st.o[2] + tx * 4 + 32 * c, out);
    }
  }
}

template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                const Strides& st, int64_t bh, int h_q, int group,
                int64_t sq, int64_t skv, float scale, int causal,
                cudaStream_t stream) {
  const int64_t n_qt = (sq + kBQ - 1) / kBQ;
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned int>(bh), static_cast<unsigned int>(n_qt));
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, h_q, group, sq, skv,
      scale, causal, n_qt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* o,
                  const Strides& st, int64_t bh, int h_q, int group,
                  int64_t sq, int64_t skv, int d, float scale, int causal,
                  cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_simt<T, 32>(q, k, v, o, st, bh, h_q, group, sq, skv,
                                scale, causal, stream);
    case 64:
      return launch_simt<T, 64>(q, k, v, o, st, bh, h_q, group, sq, skv,
                                scale, causal, stream);
    case 96:
      return launch_simt<T, 96>(q, k, v, o, st, bh, h_q, group, sq, skv,
                                scale, causal, stream);
    case 128:
      return launch_simt<T, 128>(q, k, v, o, st, bh, h_q, group, sq, skv,
                                 scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --------------------------------------------------------------------------
// bf16: wgmma on the tensor cores
// --------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;

// wgmma m64nNk16, bf16 in, f32 accumulators (N / 2 a thread): ss for the
// scores (N = 64 keys), rs for p . v (N = D)
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d (+)= A . B, A from registers (four 32-bit words of bf16 pairs), B
  // N-major from shared memory (transpose bit set)
  __device__ __forceinline__ static void rs(float* d, const uint32_t* a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}"
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  // d (+)= A . B^T, A and B K-major from shared memory (descriptors)
  __device__ __forceinline__ static void ss(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}"
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d)
        : "memory");
  }
  // d (+)= A . B, A from registers (four 32-bit words of bf16 pairs), B
  // N-major from shared memory (transpose bit set)
  __device__ __forceinline__ static void rs(float* d, const uint32_t* a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<96> {
  // d (+)= A . B, A from registers (four 32-bit words of bf16 pairs), B
  // N-major from shared memory (transpose bit set)
  __device__ __forceinline__ static void rs(float* d, const uint32_t* a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47}"
        ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A . B, A from registers (four 32-bit words of bf16 pairs), B
  // N-major from shared memory (transpose bit set)
  __device__ __forceinline__ static void rs(float* d, const uint32_t* a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}"
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};



// A shared-memory matrix descriptor, no swizzle: the start address and the
// byte steps between core matrices along K (lbo) and along M or N (sbo)
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3ffffu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register accesses across the async wgmma
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Rows [r0, r0 + 64) of a [S, D] slab (row stride `ld` elements) into
// shared memory as 8-row x 16-byte core matrices, row group major: the
// 16-byte chunk c (row (c / 8 / (D/8)) * 8 + c % 8, columns 8 * ((c / 8) %
// (D/8))) goes to byte 16 c.  Rows at or past n are zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile(const bf16* __restrict__ g,
                                          int64_t ld, int64_t r0, int64_t n,
                                          bf16* s) {
  constexpr int kJ = D / 8;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s));
#pragma unroll
  for (int c = threadIdx.x; c < 8 * D; c += 128) {
    const int64_t row = r0 + ((c >> 3) / kJ) * 8 + (c & 7);
    const int col = ((c >> 3) % kJ) * 8;
    const bool in = row < n;
    const bf16* src = in ? g + row * ld + col : g;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     base + 16 * c),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// two floats rounded to bf16 (one cvt.rn.bf16x2), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the two bf16 of a packed word, widened (exact)
__device__ __forceinline__ float lo_of(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_of(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 2^x by the SFU's ex2 (the instruction exp2f is built on; exp2f only adds
// a rescale for results below 2^-126, which flush to zero here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x0, x1 -> three packed bf16 words whose sums are x0 and x1 exactly: each
// residual x - bf16(x) is exact in f32, and three 8-bit significands cover
// f32's 24
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& w1,
                                       uint32_t& w2, uint32_t& w3) {
  w1 = pack(x0, x1);
  x0 -= lo_of(w1);
  x1 -= hi_of(w1);
  w2 = pack(x0, x1);
  w3 = pack(x0 - lo_of(w2), x1 - hi_of(w2));
}

constexpr int kTile = 64;      // q rows per CTA and keys per K/V tile
constexpr int kThreads = 128;  // one warpgroup

template <int D>
constexpr int smem_bytes() {
  return 2 * kTile * D * 5;  // Q, and two stages of K and V
}

template <int D, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   Strides st, int h_q, int group, int64_t sq, int64_t skv,
                   float scale, int causal, int64_t n_qt) {
  constexpr uint32_t kCore = 128;           // bytes of one core matrix
  constexpr uint32_t kRowGroup = 16 * D;    // bytes of 8 rows x D
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // Q, then stage 0's K and V, then stage 1's: 64 x D each
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  auto k_stage = [qs](int st) { return qs + (1 + 2 * st) * kTile * D; };
  auto v_stage = [qs](int st) { return qs + (2 + 2 * st) * kTile * D; };

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / h_q, h = bh % h_q, kh = h / group;
  const int64_t q0 = (n_qt - 1 - static_cast<int64_t>(blockIdx.y)) * kTile;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + kh * st.k[1];
  const bf16* vb = v + b * st.v[0] + kh * st.v[1];
  bf16* ob = o + b * st.o[0] + h * st.o[1];

  // fragment of the 64-row accumulators: rows r and r + 8, columns
  // 8 j + cq + {0, 1} for each block j of 8 columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = q0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
  const int cq = 2 * (lane & 3);

  const int64_t k_end = causal && q0 + kTile < skv ? q0 + kTile : skv;
  const int64_t n_kt = (k_end + kTile - 1) / kTile;
  // scores in base 2: exp2(s * scale * log2(e) - m) is exp(s * scale - m')
  // up to f32 rounding; the row max is taken over the raw scores (scale >
  // 0 keeps their order) so that one FFMA scales and shifts each
  const float scale_log2 = scale * 1.44269504088896341f;

  copy_tile<D>(qb, st.q[2], q0, sq, qs);
  copy_tile<D>(kb, st.k[2], 0, skv, k_stage(0));
  copy_tile<D>(vb, st.v[2], 0, skv, v_stage(0));
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const uint64_t dq = desc(qs, kCore, kRowGroup);
  float s[32], acc[D / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  for (int64_t kt = 0; kt < n_kt; ++kt) {
    const int stage = static_cast<int>(kt & 1);
    if (kt + 1 < n_kt) {
      copy_tile<D>(kb, st.k[2], (kt + 1) * kTile, skv, k_stage(stage ^ 1));
      copy_tile<D>(vb, st.v[2], (kt + 1) * kTile, skv, v_stage(stage ^ 1));
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    // the tile's generic-proxy writes become visible to wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q . K^T: D / 16 steps of 16 along D (two core matrices each)
    const uint64_t dk = desc(k_stage(stage), kCore, kRowGroup);
    fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<64>::ss(s, dq + ((2 * kCore * kk) >> 4),
                    dk + ((2 * kCore * kk) >> 4), kk > 0);
    commit_and_wait();
    pin<32>(s);

    const int64_t k0 = kt * kTile;
    const bool masked = k0 + kTile > skv || (causal && k0 + kTile - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i];
      if (masked) {
        const int64_t col = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int64_t row = (i & 2) ? row1 : row0;
        if (col >= skv || (causal && col > row)) x = kNegInf;
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    // the 4 lanes of a quad share their rows
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // m is kept in scaled units; a masked score stays -1e30 * scale_log2
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(fmaf(s[i], scale_log2, (i & 2) ? -mn1 : -mn0));
      s[i] = p;
      if (i & 2) sum1 += p; else sum0 += p;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
    // p = p1 + p2 + p3 in bf16, as A fragments: for keys 16 kk .. 16 kk +
    // 15, word w of the fragment holds accumulator entries 8 kk + 2 w and
    // 8 kk + 2 w + 1
    uint32_t a[3][16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      split3(s[2 * i], s[2 * i + 1], a[0][i], a[1][i], a[2][i]);

    // P . V of this tile into a fresh accumulator, smallest term first: V
    // is [keys x D] with D contiguous, N-major for wgmma; 16 keys are two
    // core matrices along K, kRowGroup bytes apart.  The tensor cores sum
    // only this tile's 192 products a column; the running sum over tiles
    // is rounded to nearest on the CUDA cores (see the note at the top)
    float pv[D / 2];
    const uint64_t dv = desc(v_stage(stage), kRowGroup, kCore);
    fence();
#pragma unroll
    for (int t = 2; t >= 0; --t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::rs(pv, &a[t][4 * kk], dv + ((2 * kRowGroup * kk) >> 4),
                     t < 2 || kk > 0);
    commit_and_wait();
    pin<D / 2>(pv);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      acc[i] = acc[i] * ((i & 2) ? alpha1 : alpha0) + pv[i];
    __syncthreads();  // every read of this stage is done before it refills
  }

  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int64_t row = (i & 2) ? row1 : row0;
    if (row >= sq) continue;
    const float den = (i & 2) ? den1 : den0;
    *reinterpret_cast<uint32_t*>(ob + row * st.o[2] + 8 * (i >> 2) + cq) =
        pack(acc[i] / den, acc[i + 1] / den);
  }
}

// CTAs an SM the registers are cut for: at D 64 three fit without spills
// (166 registers), which takes a 32k prefill's call from 14.4 to 12.9 ms
// on an H100 against the compiler's own choice (194 registers, fewer
// CTAs; scripts/probe_kernels.py).  At D 96 three too: 168 registers and
// 8 bytes spilled, 0.702 ms for phi-3-vision's 32/32 heads at B 1 S 4096,
// against 0.743 ms for two (215 registers) and 0.754 for one
// (scripts/probe_kernels.py d96_blocks); 61,440 bytes of shared memory a
// CTA
template <int D>
constexpr int min_blocks() {
  return D == 32 ? 4 : D == 64 || D == 96 ? 3 : 1;
}

template <int D, int kMinBlocks = min_blocks<D>()>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int64_t bh, int h_q, int group, int64_t sq,
           int64_t skv, float scale, int causal, cudaStream_t stream) {
  const int64_t n_qt = (sq + kTile - 1) / kTile;
  const int smem = smem_bytes<D>();
  auto kernel = flash_kernel_wgmma<D, kMinBlocks>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned int>(bh), static_cast<unsigned int>(n_qt));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), st, h_q, group, sq,
      skv, scale, causal, n_qt);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             const Strides& st, int64_t bh, int h_q, int group, int64_t sq,
             int64_t skv, int d, float scale, int causal,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, st, bh, h_q, group, sq, skv, scale,
                        causal, stream);
    case 64:
      return launch<64>(q, k, v, o, st, bh, h_q, group, sq, skv, scale,
                        causal, stream);
    case 96:
      return launch<96>(q, k, v, o, st, bh, h_q, group, sq, skv, scale,
                        causal, stream);
    case 128:
      return launch<128>(q, k, v, o, st, bh, h_q, group, sq, skv, scale,
                         causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wg

}  // namespace

// q, k, v, o: device pointers, 16-byte aligned, f32 (dtype 0, the CUDA-core
// kernel) or bf16 (dtype 1, the wgmma kernel); shape = {B, H, KVH, Sq, Skv,
// D} with D in {32, 64, 96, 128} and H % KVH == 0; strides: 16 int64 in
// elements (q, k, v, o, each batch, head, seq, dim), dim strides 1 and the
// others multiples of 16 bytes.  Launches on `stream` and returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const int64_t* shape,
                                     const int64_t* strides, float scale,
                                     int causal, int dtype, void* stream) {
  const int64_t b = shape[0], h = shape[1], kvh = shape[2], sq = shape[3],
                skv = shape[4], d = shape[5];
  if (b <= 0 || sq <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || skv <= 0 ||
      (sq + kBQ - 1) / kBQ > 65535 || b * h > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
    st.o[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = static_cast<int>(h / kvh);
  if (dtype == 0)
    return dispatch_simt<float>(q, k, v, o, st, b * h, static_cast<int>(h),
                                group, sq, skv, static_cast<int>(d), scale,
                                causal, s);
  if (dtype == 1)
    return wg::dispatch(q, k, v, o, st, b * h, static_cast<int>(h), group,
                        sq, skv, static_cast<int>(d), scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
