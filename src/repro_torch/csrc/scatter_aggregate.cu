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
//   partial[t] = sum of agg[c]^2 over the columns of output tile t
// Slots with idx < 0 (transport-dropped) or idx >= d_out add nothing.  The
// wrapper sums `partial`.
//
// What bounds it on an H100: bytes.  The least traffic is each slot read
// once (5 bytes), the scales and weights once, and agg written once:
// 5*N*K + 8*N + 4*d_out bytes.  At K = 13,624,934 and d_out = 136,249,344
// (the full-width embedding bucket at keep 0.1) that is 0.183, 0.203 and
// 0.244 ms at 3.35 TB/s for N = 1, 2 and 4.
//
// Design: the TPU kernel scatters by a one-hot matmul on the MXU, comparing
// every slot with every column (N*K*D multiply-adds).  A scatter straight
// into agg (one float atomic per slot at a random address of a buffer L2
// cannot hold, plus a zero fill and a norm pass over agg) costs a 32-byte
// read-modify-write in HBM per slot and two extra passes.  Here the slots
// are first binned by output tile of kTile columns, so every add lands in
// shared memory and agg is written once, with its norm, in one pass:
//   1. count: each CTA counts a chunk of 1,024 slots by (tile, sender) in
//      a shared hash table, then adds each count it met to the small global
//      (tile, sender) table, which L2 holds, with one integer atomic; the
//      returned base plus the slot's place in the CTA's count is its rank,
//      its place in its segment;
//   2. scan: count -> exclusive offsets per (tile, sender), in tile-major,
//      sender-minor order: a scan inside each chunk of kChunk entries,
//      then one CTA scans the chunk totals;
//   3. place: record[offset + rank] = (column in tile << 8) | q byte.  The
//      open segments are few MB, so L2 merges these writes;
//   4. accumulate: one CTA per tile zeroes the tile in shared memory, adds
//      sender 0's segment, __syncthreads, sender 1's, and so on, then writes
//      agg coalesced (16-byte stores) and the tile's sum of squares.
// Traffic: about 21*N*K + 4*d_out bytes (idx twice, rank written and read,
// q once, the record written and read; the count and offset tables are
// small).  No pass zeroes or rereads agg and no float atomic touches it.
//
// Order: senders are added in order, one __syncthreads apart; where idx is
// distinct within a sender (top-k indices are) each column gets one add per
// sender, so agg is bit-equal to the plain in-order loop.  Duplicates within
// one sender meet, in shared-memory float atomics, in an order that varies
// from run to run.  Float atomics (atom.add.f32) flush subnormal inputs and
// results to zero, so bit-equality also needs every product and sum to be 0
// or normal; it is where scale * w >= 2^-100 (the scale floor 1e-30 with
// w = 1, as on the path), since every value is then a multiple of 2^-123.
// The product is formed as the Pallas kernel forms it, q * (scale * w), each
// rounded apart (__fmul_rn: no contraction), not as the oracle's
// (q * scale) * w.  64-bit offsets throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileLog = 12;
constexpr int64_t kTile = int64_t{1} << kTileLog;  // columns per output tile
constexpr int kCountItems = 4;
constexpr int kCountSlots = kThreads * kCountItems;  // slots a count CTA
constexpr int kTableLog = 11;
constexpr int kTable = 1 << kTableLog;  // its hash table: twice its slots
constexpr int kDirectRuns = 8;  // more runs in a warp: global atomics
constexpr int kDead = -1, kDirect = -2;  // a slot's table entry otherwise
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kChunk = kScanThreads * kScanItems;  // scan entries per CTA

__device__ __forceinline__ bool live(int32_t c, int64_t d_out) {
  return c >= 0 && c < d_out;
}

// grid (ceil(k / kCountSlots), n): kCountItems slots a thread, a chunk of
// kCountSlots neighbouring slots a CTA.  Top-k indices of a real gradient
// come in long runs (a zero-heavy bucket's ties go lowest index first),
// where one atomic a slot would queue thousands of CTAs on the same few
// counters; random ones spread over all counters.  So a warp first finds
// its runs of one tile: with more than kDirectRuns it takes one global
// atomic a run; with fewer, the CTA counts the runs in a shared hash table
// and takes one global atomic a key it met.
__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ idx, int32_t* __restrict__ count,
             int32_t* __restrict__ rank, int64_t n, int64_t k,
             int64_t d_out) {
  __shared__ long long keys[kTable];
  __shared__ int32_t hits[kTable];
  for (int j = threadIdx.x; j < kTable; j += kThreads) {
    keys[j] = -1;
    hits[j] = 0;
  }
  __syncthreads();
  const int64_t sender = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kCountSlots;
  // a warp's lanes take neighbouring slots; a run of live lanes with one
  // tile (dropped lanes between them do not break it) takes one shared
  // atomic, by its first lane, so a run of columns does not queue there
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int where[kCountItems], local[kCountItems];
#pragma unroll
  for (int i = 0; i < kCountItems; ++i) {
    const int64_t t = t0 + i * kThreads + threadIdx.x;
    const int32_t c = t < k ? idx[sender * k + t] : -1;
    const bool ok = live(c, d_out);
    const unsigned tile = ok ? static_cast<unsigned>(c >> kTileLog) : ~0u;
    const unsigned lv = __ballot_sync(~0u, ok);
    const int src = (lv & below) ? 31 - __clz(lv & below) : lane;
    const unsigned prev = __shfl_sync(~0u, tile, src);
    const bool head = ok && (src == lane || prev != tile);
    const unsigned heads = __ballot_sync(~0u, head);
    where[i] = kDead;
    if (!ok) continue;
    const int first = 31 - __clz(heads & (below | (1u << lane)));
    const unsigned later = heads & ~(below | (1u << lane));
    const unsigned before_next = later ? (1u << (__ffs(later) - 1)) - 1u : ~0u;
    const unsigned run = lv & before_next & ~((1u << first) - 1u);
    const long long e = static_cast<long long>(tile) * n + sender;
    if (__popc(heads) > kDirectRuns) {
      // scattered columns (many runs): one global atomic a run, no table
      int b = 0;
      if (head) b = atomicAdd(count + e, __popc(run));
      where[i] = kDirect;
      local[i] = __shfl_sync(lv, b, first) + __popc(run & below);
      continue;
    }
    int h = 0, b = 0;
    if (head) {
      unsigned hh = (static_cast<unsigned>(e) * 2654435761u) >>
                    (32 - kTableLog);
      for (;;) {  // at most kCountSlots keys in 2 kCountSlots entries
        const long long old = static_cast<long long>(atomicCAS(
            reinterpret_cast<unsigned long long*>(keys + hh),
            static_cast<unsigned long long>(-1LL),
            static_cast<unsigned long long>(e)));
        if (old == -1 || old == e) break;
        hh = (hh + 1) & (kTable - 1);
      }
      h = static_cast<int>(hh);
      b = atomicAdd(hits + hh, __popc(run));
    }
    where[i] = __shfl_sync(lv, h, first);
    local[i] = __shfl_sync(lv, b, first) + __popc(run & below);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kTable; j += kThreads)
    if (keys[j] >= 0) hits[j] = atomicAdd(count + keys[j], hits[j]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCountItems; ++i)
    if (where[i] != kDead)
      rank[sender * k + t0 + i * kThreads + threadIdx.x] =
          (where[i] == kDirect ? 0 : hits[where[i]]) + local[i];
}

// exclusive scan of one value a thread across the CTA (v becomes the sum
// of the values of the threads before it); returns the CTA's total
__device__ int32_t block_exclusive_scan(int32_t& v) {
  __shared__ int32_t warp_pre[kScanThreads / 32];
  __shared__ int32_t block_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_pre[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = warp_pre[lane];
    int32_t wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t o = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += o;
    }
    warp_pre[lane] = wi - w;
    if (lane == 31) block_total = wi;
  }
  __syncthreads();
  v = warp_pre[warp] + incl - v;
  const int32_t total = block_total;
  __syncthreads();  // the shared words are free for the next call
  return total;
}

// offsets[e] = sum of count over chunk entries before e; chunk_sum[c] =
// the chunk's total
__global__ void __launch_bounds__(kScanThreads)
scan_chunks_kernel(const int32_t* __restrict__ count,
                   int32_t* __restrict__ offsets,
                   int32_t* __restrict__ chunk_sum, int64_t e_total) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk +
                       static_cast<int64_t>(threadIdx.x) * kScanItems;
  int32_t v[kScanItems];
  int32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = base + i < e_total ? count[base + i] : 0;
    sum += v[i];
  }
  int32_t pre = sum;
  block_exclusive_scan(pre);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < e_total) offsets[base + i] = pre;
    pre += v[i];
  }
  // the last thread's inclusive prefix is the chunk's total
  if (threadIdx.x == kScanThreads - 1) chunk_sum[blockIdx.x] = pre;
}

// chunk_sum -> exclusive prefix over the chunks, in place (one CTA)
__global__ void __launch_bounds__(kScanThreads)
scan_totals_kernel(int32_t* __restrict__ chunk_sum, int64_t n_chunks) {
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t b = 0; b < n_chunks; b += kScanThreads) {
    const int64_t i = b + threadIdx.x;
    const int32_t x = i < n_chunks ? chunk_sum[i] : 0;
    int32_t pre = x;
    const int32_t c = carry;
    const int32_t total = block_exclusive_scan(pre);
    if (i < n_chunks) chunk_sum[i] = c + pre;
    if (threadIdx.x == 0) carry = c + total;
    __syncthreads();
  }
}

__device__ __forceinline__ int64_t segment_start(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ chunk_sum,
    int64_t e) {
  return static_cast<int64_t>(offsets[e]) + chunk_sum[e / kChunk];
}

// grid (ceil(k / kThreads), n)
__global__ void __launch_bounds__(kThreads)
place_kernel(const int32_t* __restrict__ idx, const int8_t* __restrict__ q,
             const int32_t* __restrict__ rank,
             const int32_t* __restrict__ offsets,
             const int32_t* __restrict__ chunk_sum,
             uint32_t* __restrict__ record, int64_t n, int64_t k,
             int64_t d_out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= k) return;
  const int64_t sender = blockIdx.y;
  const int64_t slot = sender * k + t;
  const int32_t c = idx[slot];
  if (!live(c, d_out)) return;
  const int64_t e = (static_cast<int64_t>(c) >> kTileLog) * n + sender;
  record[segment_start(offsets, chunk_sum, e) + rank[slot]] =
      (static_cast<uint32_t>(c & (kTile - 1)) << 8) |
      static_cast<uint8_t>(q[slot]);
}

// one CTA per output tile
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const uint32_t* __restrict__ record,
                  const int32_t* __restrict__ count,
                  const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ chunk_sum,
                  const float* __restrict__ scales,
                  const float* __restrict__ weights, float* __restrict__ agg,
                  float* __restrict__ partial, int64_t n, int64_t d_out) {
  __shared__ __align__(16) float tile[kTile];
  __shared__ float warp_sums[kThreads / 32];
  const int64_t t = blockIdx.x;
  float4* tile4 = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < kTile / 4; i += kThreads)
    tile4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  for (int64_t sender = 0; sender < n; ++sender) {
    const int64_t e = t * n + sender;
    const int64_t beg = segment_start(offsets, chunk_sum, e);
    const int64_t cnt = count[e];
    const float sw = __fmul_rn(scales[sender], weights[sender]);
    for (int64_t i = threadIdx.x; i < cnt; i += kThreads) {
      const uint32_t r = record[beg + i];
      const float v = __fmul_rn(
          static_cast<float>(static_cast<int8_t>(r & 0xffu)), sw);
      atomicAdd(tile + (r >> 8), v);
    }
    __syncthreads();  // this sender's adds land before the next sender's
  }
  const int64_t c0 = t * kTile;
  float ssq = 0.0f;
  for (int i = threadIdx.x; i < kTile / 4; i += kThreads) {
    const int64_t c = c0 + 4 * i;
    const float4 x = tile4[i];
    if (c + 4 <= d_out) {
      *reinterpret_cast<float4*>(agg + c) = x;  // 16-byte aligned
      ssq += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
    } else {
      const float xs[4] = {x.x, x.y, x.z, x.w};
      for (int j = 0; j < 4 && c + j < d_out; ++j) {
        agg[c + j] = xs[j];
        ssq += xs[j] * xs[j];
      }
    }
  }
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
    if (threadIdx.x == 0) partial[t] = v;
  }
}

struct Scratch {
  int32_t* count;     // [n_tiles * n]
  int32_t* offsets;   // [n_tiles * n]
  int32_t* chunk;     // [n_chunks]
  int32_t* rank;      // [n * k]
  uint32_t* record;   // [n * k]
};

int64_t n_tiles(int64_t d_out) { return (d_out + kTile - 1) / kTile; }

int64_t n_chunks(int64_t n, int64_t d_out) {
  return (n_tiles(d_out) * n + kChunk - 1) / kChunk;
}

// int32 entries of the scratch buffer, in the order of Scratch
int64_t scratch_ints(int64_t n, int64_t k, int64_t d_out) {
  return 2 * n_tiles(d_out) * n + n_chunks(n, d_out) + 2 * n * k;
}

}  // namespace

// Int32 entries of scratch the wrapper allocates (torch.empty) for n
// senders of k slots into d_out columns.
extern "C" int64_t repro_scatter_aggregate_scratch(int64_t n, int64_t k,
                                                   int64_t d_out) {
  return scratch_ints(n, k, d_out);
}

// idx: int32 [n, k]; q: int8 [n, k]; scales, weights: f32 [n], all
// contiguous on the card; agg: f32 [d_out], 16-byte aligned; partial: f32
// [ceil(d_out / tile)]; scratch: int32 [repro_scatter_aggregate_scratch],
// 16-byte aligned; n * k < 2^31.  Launches on `stream` (a fill of the count
// table, then count, two scans, place and accumulate) and returns the first
// CUDA error (0 when all were accepted).
extern "C" int repro_scatter_aggregate(const int32_t* idx, const int8_t* q,
                                       const float* scales,
                                       const float* weights, float* agg,
                                       float* partial, int32_t* scratch,
                                       int64_t n, int64_t k, int64_t d_out,
                                       void* stream) {
  if (d_out <= 0) return 0;
  if (n <= 0 || k <= 0 || n > 65535 || n * k >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = n_tiles(d_out), entries = tiles * n;
  const int64_t chunks = n_chunks(n, d_out);
  Scratch sc;
  sc.count = scratch;
  sc.offsets = sc.count + entries;
  sc.chunk = sc.offsets + entries;
  sc.rank = sc.chunk + chunks;
  sc.record = reinterpret_cast<uint32_t*>(sc.rank + n * k);
  cudaError_t rc = cudaMemsetAsync(sc.count, 0, entries * sizeof(int32_t), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 chunks_of_slots(
      static_cast<unsigned int>((k + kCountSlots - 1) / kCountSlots),
      static_cast<unsigned int>(n));
  count_kernel<<<chunks_of_slots, kThreads, 0, s>>>(idx, sc.count, sc.rank,
                                                    n, k, d_out);
  const dim3 slots(static_cast<unsigned int>((k + kThreads - 1) / kThreads),
                   static_cast<unsigned int>(n));
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  scan_chunks_kernel<<<static_cast<unsigned int>(chunks), kScanThreads, 0,
                       s>>>(sc.count, sc.offsets, sc.chunk, entries);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  scan_totals_kernel<<<1, kScanThreads, 0, s>>>(sc.chunk, chunks);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  place_kernel<<<slots, kThreads, 0, s>>>(idx, q, sc.rank, sc.offsets,
                                          sc.chunk, sc.record, n, k, d_out);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  accumulate_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0, s>>>(
      sc.record, sc.count, sc.offsets, sc.chunk, scales, weights, agg,
      partial, n, d_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t repro_scatter_aggregate_tile() { return kTile; }

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
