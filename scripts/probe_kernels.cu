// Kernel probes for the flash kernel's bf16 body, built and driven by
// scripts/probe_kernels.py: its wgmma pieces alone (the no-swizzle layout of
// Q, K and N-major V), the tensor cores' f32 sums over many tiles against a
// fresh accumulator a tile added on the CUDA cores, and the body with p
// split into kTerms bf16 terms (3 is the kernel's; 2 drops the last 8 bits
// of p) or with its registers cut for kMinBlocks CTAs an SM.
#include "../src/repro_torch/csrc/flash_attention.cu"

namespace {
using namespace wg;

template <int D>
__global__ void probe_qk(const bf16* q, const bf16* k, float* out) {
  extern __shared__ __align__(128) unsigned char raw[];
  bf16* qs = reinterpret_cast<bf16*>(raw);
  bf16* ks = qs + 64 * D;
  copy_tile<D>(q, D, 0, 64, qs);
  copy_tile<D>(k, D, 0, 64, ks);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // K-major: LBO = 128 bytes along K, SBO = 16 D bytes along M / N
  const uint64_t dq = desc(qs, 128, 16 * D), dk = desc(ks, 128, 16 * D);
  float s[32];
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<64>::ss(s, dq + ((256 * kk) >> 4), dk + ((256 * kk) >> 4), kk > 0);
  commit_and_wait();
  pin<32>(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + (lane >> 2) + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    out[row * 64 + col] = s[i];
  }
}

template <int D>
__global__ void probe_pv(const float* p, const bf16* v, float* out) {
  extern __shared__ __align__(128) unsigned char raw[];
  bf16* vs = reinterpret_cast<bf16*>(raw);
  copy_tile<D>(v, D, 0, 64, vs);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + (lane >> 2) + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    s[i] = p[row * 64 + col];
  }
  uint32_t a[3][16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    split3(s[2 * i], s[2 * i + 1], a[0][i], a[1][i], a[2][i]);
  }
  // N-major V: LBO = 16 D bytes along K (keys), SBO = 128 along N (D)
  const uint64_t dv = desc(vs, 16 * D, 128);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence();
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<D>::rs(acc, &a[t][4 * kk], dv + ((2 * 16 * D * kk) >> 4), 1);
  commit_and_wait();
  pin<D / 2>(acc);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const int row = 16 * warp + (lane >> 2) + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    out[row * D + col] = acc[i];
  }
}

// T tiles of the same P . V summed two ways: mode 0 through the tensor
// cores' accumulator, mode 1 a fresh accumulator a tile added in f32
template <int D>
__global__ void probe_acc(const float* p, const bf16* v, float* out,
                          int tiles, int mode) {
  extern __shared__ __align__(128) unsigned char raw[];
  bf16* vs = reinterpret_cast<bf16*>(raw);
  copy_tile<D>(v, D, 0, 64, vs);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + (lane >> 2) + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    s[i] = p[row * 64 + col];
  }
  uint32_t a[3][16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    split3(s[2 * i], s[2 * i + 1], a[0][i], a[1][i], a[2][i]);
  const uint64_t dv = desc(vs, 16 * D, 128);
  float acc[D / 2], pv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    fence();
    if (mode == 0) {
#pragma unroll
      for (int u = 2; u >= 0; --u)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<D>::rs(acc, &a[u][4 * kk], dv + ((2 * 16 * D * kk) >> 4), 1);
      commit_and_wait();
      pin<D / 2>(acc);
    } else {
#pragma unroll
      for (int u = 2; u >= 0; --u)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<D>::rs(pv, &a[u][4 * kk], dv + ((2 * 16 * D * kk) >> 4),
                       u < 2 || kk > 0);
      commit_and_wait();
      pin<D / 2>(pv);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += pv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const int row = 16 * warp + (lane >> 2) + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    out[row * D + col] = acc[i];
  }
}
template <int D, int kTerms>
__global__ void __launch_bounds__(wg::kThreads, min_blocks<D>())
split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
    uint32_t a[kTerms][16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float x0 = s[2 * i], x1 = s[2 * i + 1];
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        a[t][i] = pack(x0, x1);
        x0 -= lo_of(a[t][i]);
        x1 -= hi_of(a[t][i]);
      }
    }

    // P . V of this tile into a fresh accumulator, smallest term first: V
    // is [keys x D] with D contiguous, N-major for wgmma; 16 keys are two
    // core matrices along K, kRowGroup bytes apart.  The tensor cores sum
    // only this tile's 192 products a column; the running sum over tiles
    // is rounded to nearest on the CUDA cores (see the note at the top)
    float pv[D / 2];
    const uint64_t dv = desc(v_stage(stage), kRowGroup, kCore);
    fence();
#pragma unroll
    for (int t = kTerms - 1; t >= 0; --t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::rs(pv, &a[t][4 * kk], dv + ((2 * kRowGroup * kk) >> 4),
                     t < kTerms - 1 || kk > 0);
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


template <int D>
int run_layout(const void* q, const void* k, const void* p, const void* v,
               void* s_out, void* o_out) {
  probe_qk<D><<<1, 128, 2 * 64 * D * 2>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<float*>(s_out));
  cudaError_t e = cudaGetLastError();
  if (e) return e;
  probe_pv<D><<<1, 128, 64 * D * 2>>>(static_cast<const float*>(p),
                                      static_cast<const bf16*>(v),
                                      static_cast<float*>(o_out));
  e = cudaGetLastError();
  if (e) return e;
  return cudaDeviceSynchronize();
}

template <int D, int kTerms>
int launch_split(const void* q, const void* k, const void* v, void* o,
                 const Strides& st, int64_t bh, int h_q, int group,
                 int64_t sq, int64_t skv, float scale, int causal) {
  const int64_t n_qt = (sq + kTile - 1) / kTile;
  const int smem = smem_bytes<D>();
  auto kernel = split_kernel<D, kTerms>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned int>(bh), static_cast<unsigned int>(n_qt));
  kernel<<<grid, wg::kThreads, smem>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), st, h_q, group, sq,
      skv, scale, causal, n_qt);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int probe_layout(int d, const void* q, const void* k,
                            const void* p, const void* v, void* s_out,
                            void* o_out) {
  switch (d) {
    case 32: return run_layout<32>(q, k, p, v, s_out, o_out);
    case 64: return run_layout<64>(q, k, p, v, s_out, o_out);
    case 96: return run_layout<96>(q, k, p, v, s_out, o_out);
    case 128: return run_layout<128>(q, k, p, v, s_out, o_out);
  }
  return -1;
}

extern "C" int probe_accumulate(const void* p, const void* v, void* out,
                                int tiles, int mode) {
  probe_acc<64><<<1, 128, 64 * 64 * 2>>>(static_cast<const float*>(p),
                                        static_cast<const bf16*>(v),
                                        static_cast<float*>(out), tiles, mode);
  cudaError_t e = cudaGetLastError();
  if (e) return e;
  return cudaDeviceSynchronize();
}

// bf16 attention by a variant: 2 or 3 = split_kernel at D 64 with that many
// terms of p; 11 .. 14 = the D 64 kernel cut for 1 .. 4 CTAs an SM; 21 .. 23
// = the D 96 kernel cut for 1 .. 3 CTAs an SM.
// shape and strides as repro_flash_attention takes them; default stream.
extern "C" int probe_variant(int variant, const void* q, const void* k,
                             const void* v, void* o, const int64_t* shape,
                             const int64_t* strides, float scale,
                             int causal) {
  const int64_t b = shape[0], h = shape[1], kvh = shape[2], sq = shape[3],
                skv = shape[4];
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
    st.o[i] = strides[12 + i];
  }
  const int g = static_cast<int>(h / kvh), hh = static_cast<int>(h);
  const int64_t bh = b * h;
  switch (variant) {
    case 2:
      return launch_split<64, 2>(q, k, v, o, st, bh, hh, g, sq, skv, scale,
                                 causal);
    case 3:
      return launch_split<64, 3>(q, k, v, o, st, bh, hh, g, sq, skv, scale,
                                 causal);
    case 11:
      return launch<64, 1>(q, k, v, o, st, bh, hh, g, sq, skv, scale, causal,
                           0);
    case 12:
      return launch<64, 2>(q, k, v, o, st, bh, hh, g, sq, skv, scale, causal,
                           0);
    case 13:
      return launch<64, 3>(q, k, v, o, st, bh, hh, g, sq, skv, scale, causal,
                           0);
    case 14:
      return launch<64, 4>(q, k, v, o, st, bh, hh, g, sq, skv, scale, causal,
                           0);
    case 21:
      return launch<96, 1>(q, k, v, o, st, bh, hh, g, sq, skv, scale, causal,
                           0);
    case 22:
      return launch<96, 2>(q, k, v, o, st, bh, hh, g, sq, skv, scale, causal,
                           0);
    case 23:
      return launch<96, 3>(q, k, v, o, st, bh, hh, g, sq, skv, scale, causal,
                           0);
  }
  return -1;
}

// Registers a thread and local (spill) bytes of a D 96 variant (21 .. 23):
// regs[0], regs[1]; returns the CUDA error of the query.
extern "C" int probe_d96_regs(int variant, int* regs) {
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
  switch (variant) {
    case 21: e = cudaFuncGetAttributes(&a, flash_kernel_wgmma<96, 1>); break;
    case 22: e = cudaFuncGetAttributes(&a, flash_kernel_wgmma<96, 2>); break;
    case 23: e = cudaFuncGetAttributes(&a, flash_kernel_wgmma<96, 3>); break;
  }
  if (e) return e;
  regs[0] = a.numRegs;
  regs[1] = static_cast<int>(a.localSizeBytes);
  return 0;
}
