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
//   1e-30) cast to q's dtype (f32 or bf16).  All math is f32.
//
// What bounds it on an H100: operations.  A causal call does
// 4 * D * H * B * S(S+1)/2 flops (two products of every unmasked (q, k)
// pair); at S = 32768, B = 1, H = 14, D = 64 that is 1.92e12, 28.7 ms at
// the 67 TFLOP/s f32 rate of the CUDA cores, against 0.04 ms for its 134 MB
// of q, k, v and out.  (The tensor cores would bring the bound to 1.95 ms
// in bf16; that is a later redesign with wgmma, not this kernel.)
//
// Design (simple and right first):
// * One CTA of 128 threads per (64-row q tile, b * h).  The grid's x is
//   b * h and its y the q tile, longest tile first, so the causal triangle's
//   long tiles start early and the short ones fill in at the end.
// * The q tile and each 64-key K and V tile are staged in shared memory as
//   f32 (rows past Sq or Skv are zero).  Each thread holds a 4 x 8 block
//   of the 64 x 64 score tile in registers (rows ty + 16 i, keys tx + 8 j)
//   and 4 rows x D/8 columns of the output accumulator; a row's max and
//   sum are reduced across the 8 threads that share it with warp shuffles.
//   P goes through shared memory for the P.V product.  Rows are padded so
//   that the 16-byte shared loads of a warp meet no bank conflict.
// * Keys past Skv (a ragged last tile) are masked like causal ones; a
//   ragged q tile computes zero rows and stores nothing for them.
// * Causal tile skip: a key tile that starts past the q tile's last row is
//   not visited.  This is exact, not an approximation: for such a tile
//   every score is -1e30, so m_new = m_prev, alpha = exp(0) = 1 and
//   p = exp(-1e30 - m_prev) = 0, and the state (m, l, acc) would come out
//   unchanged bit for bit.  Key 0 is visited first and is unmasked for every
//   row, so m is a real score from the first tile on and no row is fully
//   masked.
// * Accurate expf and IEEE division; no flag relaxes them.
// 64-bit offsets throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // bf16 -> f32 is exact: the 16 bits are the top half of the f32
  __device__ static float widen(uint32_t bits16) {
    return __uint_as_float(bits16 << 16);
  }
  __device__ static uint32_t narrow(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = widen(w[i] & 0xffffu);
      v[2 * i + 1] = widen(w[i] >> 16);
    }
  }
  __device__ static void store4(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(narrow(v[0]) | (narrow(v[1]) << 16),
                   narrow(v[2]) | (narrow(v[3]) << 16));
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
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int64_t bh, int h_q, int group, int64_t sq,
           int64_t skv, float scale, int causal, cudaStream_t stream) {
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
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               const Strides& st, int64_t bh, int h_q, int group, int64_t sq,
               int64_t skv, int d, float scale, int causal,
               cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, st, bh, h_q, group, sq, skv, scale,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, st, bh, h_q, group, sq, skv, scale,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, st, bh, h_q, group, sq, skv, scale,
                            causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o: device pointers, 16-byte aligned, f32 (dtype 0) or bf16
// (dtype 1); shape = {B, H, KVH, Sq, Skv, D} with D in {32, 64, 128} and
// H % KVH == 0; strides: 16 int64 in elements (q, k, v, o, each batch,
// head, seq, dim), dim strides 1 and the others multiples of 16 bytes.
// Launches on `stream` and returns the CUDA error of the launch (0 when it
// was accepted).
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
    return dispatch_d<float>(q, k, v, o, st, b * h, static_cast<int>(h),
                             group, sq, skv, static_cast<int>(d), scale,
                             causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, st, b * h,
                                     static_cast<int>(h), group, sq, skv,
                                     static_cast<int>(d), scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
