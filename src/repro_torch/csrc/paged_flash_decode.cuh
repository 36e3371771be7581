// Helpers of the paged flash decode kernels, shared by the single-pass
// bodies (paged_flash_decode.cu) and the pass bodies past their
// shared-memory cap (paged_flash_decode_long.cu): row loads and their
// geometry, the fixed-order reductions over a row group, a block and a
// cluster, the page divider and the cluster launch.  Each source that
// includes it gets its own copy (an anonymous namespace).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;  // repro.core.attention.NEG_INF
constexpr int kThreads = 256;      // kernel.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxCluster = 8;  // kernel.py MAX_CLUSTER
constexpr int kUnroll = 4;  // rows a thread loads a batch (two batches in flight)
// Shared-memory header (floats; kernel.py HEADER): the block's partial max,
// sum and (int8) w max of each g row, the cluster-wide ones, the warps'
// scratch and the int8 query scales.  Then (kWarps, g, D) PV partials, the
// (g, L) scores and the block's L / P page bases.
constexpr int kHeader = 128;
constexpr int kPMax = 0, kPSum = 8, kPW = 16, kGMax = 24, kGSum = 32, kGW = 40, kScratch = 48,
              kQScale = kScratch + kWarps * kMaxG;  // + kMaxG = 120 <= kHeader
constexpr int kMaxDevices = 64;

// Lanes this cell reads: 0..pos.  A negative pos (no valid lane) reads the
// whole span, where the reference's all-masked softmax is uniform.
__device__ __forceinline__ int span_of(int p, int S) { return p < 0 ? S : min(p + 1, S); }

__device__ __forceinline__ uint4 load16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One 16-byte chunk of a row of T, of which the first `valid` elements lie
// inside the true D (the rest read as zero).  A whole chunk of an aligned
// pool is one 16-byte load; otherwise the bytes inside D one at a time (a
// rolled loop).  Only NARROW instances (G = 8) carry that path: a launch
// that needs it (a padded D or unaligned rows) runs there whatever its g,
// so the other instances keep their registers for the 16-byte path alone.
template <typename T, bool NARROW>
__device__ __forceinline__ uint4 load_chunk(const char* p, int valid, bool wide) {
  constexpr int EPC = 16 / sizeof(T);
  if constexpr (!NARROW) {
    return load16(p);
  } else {
    if (wide && valid >= EPC) return load16(p);
    unsigned long long lo = 0ull, hi = 0ull;
    const int n = min(valid, EPC) * (int)sizeof(T);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const unsigned long long x = __ldg(reinterpret_cast<const unsigned char*>(p) + i);
      if (i < 8) lo |= x << (8 * i);
      else hi |= x << (8 * (i - 8));
    }
    return make_uint4((unsigned)lo, (unsigned)(lo >> 32), (unsigned)hi, (unsigned)(hi >> 32));
  }
}

// CH loaded 16-byte chunks -> f32 values (bf16: the high half of an f32,
// exactly)
template <typename T, int CH, int V>
__device__ __forceinline__ void unpack(const uint4 (&r)[CH], float (&f)[V]) {
  static_assert(V == CH * 16 / (int)sizeof(T), "a thread's values");
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const unsigned w[4] = {r[c].x, r[c].y, r[c].z, r[c].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 2) {
        f[8 * c + 2 * i] = __uint_as_float(w[i] << 16);
        f[8 * c + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        f[4 * c + i] = __uint_as_float(w[i]);
      }
    }
  }
}

// Signed byte k of w.
__device__ __forceinline__ int sbyte(unsigned w, int k) { return (int)(w << (24 - 8 * k)) >> 24; }

// Row geometry of a DP-wide row of T: TPR threads a row (at most a warp),
// each CH consecutive 16-byte chunks of EPC values, VEC values in all.
template <typename T, int DP>
struct Rows {
  static constexpr int EPC = 16 / sizeof(T);
  static constexpr int CHUNKS = DP / EPC;
  static constexpr int CH = CHUNKS > 32 ? CHUNKS / 32 : 1;
  static constexpr int TPR = CHUNKS / CH;
  static constexpr int VEC = CH * EPC;
  static_assert(DP % EPC == 0 && TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0,
                "a row must be 16 B times a power of two, at most 1 KB");
};

// The chunks of a thread's slice of a row: how many of each chunk's
// elements lie inside the true D, and whether the pool's rows allow
// 16-byte loads.
template <int CH>
struct Span {
  int valid[CH];
  bool wide;
  __device__ Span(int Dt, int sub, int EPC, bool wide_) : wide(wide_) {
#pragma unroll
    for (int i = 0; i < CH; ++i) valid[i] = Dt - (sub * CH + i) * EPC;
  }
};

// One step of `fold`: O is the step's lane offset, v[0, LIVE) the values
// still live.  Everything is a template constant, so v stays in registers.
template <int O, int LIVE, int N, typename V>
__device__ __forceinline__ void fold_step(V (&v)[N], int sub) {
  if constexpr (O >= 1) {
    if constexpr (LIVE >= 2) {
      constexpr int h = LIVE / 2;
      const bool up = sub & O;
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const V send = up ? v[j] : v[j + h];
        const V keep = up ? v[j + h] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      fold_step<O / 2, h>(v, sub);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      fold_step<O / 2, 1>(v, sub);
    }
  }
}
// Sum each of the N values of v over the TPR lanes of this lane's row group
// (sub = 0..TPR-1), halving the values at each step, so each shuffle
// carries a distinct value.  On return v[0, CNT) hold the totals of values
// [sub * N / TPR, + CNT), CNT = max(1, N / TPR); the order is fixed.
template <int TPR, int N, typename V>
__device__ __forceinline__ void fold(V (&v)[N], int sub) {
  fold_step<TPR / 2, N>(v, sub);
}

// Combine each thread's v[gi] over the block (max or sum; lanes by a fixed
// butterfly, warps in order) into hdr[dst + gi], gi < g.  The caller's next
// barrier publishes it.
template <int G, bool kMax>
__device__ void block_reduce(float (&v)[G], int g, float* hdr, int dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float x = v[gi];
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = kMax ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) hdr[kScratch + warp * kMaxG + gi] = x;
  }
  __syncthreads();
  if (threadIdx.x < g) {
    float x = hdr[kScratch + threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      const float y = hdr[kScratch + w * kMaxG + threadIdx.x];
      x = kMax ? fmaxf(x, y) : x + y;
    }
    hdr[dst + threadIdx.x] = x;
  }
}

// After a cluster barrier: combine hdr[src + gi] of the cluster's blocks in
// rank order into this block's hdr[dst + gi], gi < g.
// The C cluster blocks' copies of at[i], all loads in flight together.
template <typename A>
__device__ __forceinline__ void gather_ranks(cg::cluster_group& cluster, A* at, int i,
                                             A (&y)[kMaxCluster]) {
  const int C = cluster.num_blocks();
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c)
    if (c < C) y[c] = cluster.map_shared_rank(at, c)[i];
}

template <bool kMax>
__device__ void cluster_reduce(cg::cluster_group& cluster, float* hdr, int src, int dst, int g) {
  if (threadIdx.x < g) {
    float y[kMaxCluster];
    gather_ranks(cluster, hdr, src + threadIdx.x, y);
    float x = y[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < (int)cluster.num_blocks()) x = kMax ? fmaxf(x, y[c]) : x + y[c];
    hdr[dst + threadIdx.x] = x;
  }
  __syncthreads();
}

// Add the warps' (g, DP) partials (part, warp stride E = g*DP) into
// part[0], then, after a cluster barrier, the C blocks' sums in rank order:
// rank r writes its slice of the cell's (g, Dt) output, the columns past
// the true Dt dropped (int8: times that row's w_scale).  A last cluster
// barrier keeps every block's shared memory alive until all ranks have
// read it.  The blocks' sums add up in Acc (int8 past one block's int32
// range: long long).
template <typename A, typename Acc = A>
__device__ void cluster_output(cg::cluster_group& cluster, A* part, int E, int DP, int Dt,
                               float* __restrict__ out, const float* hdr, bool int8) {
  __syncthreads();
  for (int i = threadIdx.x; i < E; i += kThreads) {
    A x = part[i];
    for (int w = 1; w < kWarps; ++w) x += part[w * E + i];
    part[i] = x;
  }
  cluster.sync();
  const int C = cluster.num_blocks(), per = (E + C - 1) / C;
  const int i0 = cluster.block_rank() * per, i1 = min(E, i0 + per);
  for (int i = i0 + threadIdx.x; i < i1; i += kThreads) {
    A y[kMaxCluster];
    gather_ranks(cluster, part, i, y);
    Acc x = y[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < C) x += y[c];
    const int gi = i / DP, d = i - gi * DP;
    if (d < Dt)
      out[gi * Dt + d] = int8 ? (float)x * (fmaxf(hdr[kGW + gi], 1e-20f) / 127.0f) : (float)x;
  }
  cluster.sync();
}

// The page of lane s: s / P by a multiply-high with the host's magic
// number and a shift (kernel.py `page_divider`), exact for 0 <= s < 2^31;
// a power of two (magic 1) takes the shift alone.
struct PageDiv {
  int P;
  unsigned magic, shift;
  __device__ int page(int s) const {
    return magic == 1u ? s >> shift : (int)((__umulhi((unsigned)s, magic) + s) >> shift);
  }
};

// Load this thread's CH chunks of kUnroll rows from s0 on (rows >= lim read
// as zero).  `at` is the first chunk's address in pool row 0; the walk W
// (a block's Cell, or a pass of it) maps lanes to rows.
template <typename T, bool NARROW, int CH, typename W>
__device__ __forceinline__ void load_rows(uint4 (&raw)[kUnroll][CH], const W& c,
                                          const char* at, long long row_bytes, int s0, int lim,
                                          const Span<CH>& sp) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int s = c.lane_of(s0, u);
    const char* r = s < lim ? at + c.row(s) * row_bytes : nullptr;
#pragma unroll
    for (int i = 0; i < CH; ++i)
      raw[u][i] = r ? load_chunk<T, NARROW>(r + 16 * i, sp.valid[i], sp.wide)
                    : make_uint4(0, 0, 0, 0);
  }
}

// Blocks an SM the register budget is set for: two at G <= 4 up to D 128.
template <int G, int DP>
__host__ __device__ constexpr int min_blocks() {
  return G <= 4 && DP <= 128 ? 2 : 1;
}

// One cluster launch of `blocks` blocks, C to a cluster.  Dynamic shared
// memory above 48 KB must be opted into per kernel and device: that is done
// only when a launch first needs more than was allowed before.
template <auto Kern, typename... Args>
int launch_clusters(int blocks, int C, int smem, cudaStream_t st, Args... args) {
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return (int)err;
  if (smem > (48 << 10) && (dev >= kMaxDevices || smem > allowed[dev])) {
    err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return (int)err;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kern, args...);
  return (int)(err ? err : cudaGetLastError());
}

}  // namespace
