// Fused BSTC decode + GEMV: out = (w_q @ x) [* scale] straight from the
// two-state-coded weight planes, for the decode step's few columns.
//
// Replaces: src/repro/kernels/bstc_matmul/kernel.py, bstc_matmul_pallas.
//
// What bounds it on the H100: bytes, in principle.  At decode x has N <= 8
// columns (one per batch slot), so each weight element is used N times: 2N
// operations per ~0.94 byte of coded weight, far below the ~295 operations
// a byte the card needs before its arithmetic is the limit.  At 3.35 TB/s
// the coded bytes of phi4-mini's serve shapes (0.935 B a parameter over the
// decode step, PERF.md) bound a launch at about 2.6 us (wq/wo, 3072 x
// 3072), 0.9 us (wk/wv, 1024 x 3072), 7.0 us (gate/up, 8192 x 3072, and
// down, 3072 x 8192) and 172 us (lm_head, 200064 x 3072); chip_smoke.py
// prints each bound from the bytes its operands need.  In practice the
// decode's 32-bit integer work binds first: the H100 issues integer ops at
// half its f32 rate (64 lanes a clock an SM), and turning bit planes into
// weights takes several a weight.  So the design keeps bytes in flight and
// counts integer instructions.  The weight stays coded in device memory and
// is decoded in registers; nothing dense is written.
//
// What held the first version back, and what the design does about it:
//   * one warp walked a whole group row of H in series, so few warps ran:
//     a work item is now one (group row g, H tile kt).  A coded plane's
//     stream slot for tile kt starts at its stored offset offsets[e][g, kt],
//     so no warp needs another's running count and H splits: the grid is
//     (G/R, C, N/NB) with thread-block clusters of C <= 8 blocks along y;
//     cluster rank c owns the tiles [c*T, (c+1)*T) and each of a block's R
//     warps one group row.  C minimises the grid's time in waves of two
//     blocks an SM, each T + 1 steps long (kernels/bstc_matmul/kernel.py
//     `plan`, `grid_cost`; a partial last wave costs a whole one): gate/up
//     and lm_head take no cluster, wq/wo and down 2, wk/wv 6;
//   * a few 1-byte loads in flight, in series: a warp issues all of a step's
//     operand bytes (512 columns of a tile) before it waits on any -- 4 sign
//     rows, 4 rows a raw plane, a bitmap row a coded plane, 64 bytes each,
//     and each coded plane's pattern segment as the 16-byte aligned chunks
//     covering [offset, next offset), clamped to the row's cap and zero-
//     filled past it -- as cp.async into its own slice of shared memory
//     (16-byte copies on the serve path; 8, 4 or 1 where rows are not
//     aligned so).  A ring of up to 4 such buffers keeps the next steps'
//     bytes in flight while one is decoded; the row addresses come from a
//     per-warp table built once, so a copy costs a few integer ops;
//   * two block barriers every 256 columns around the staging of x: x is
//     staged once a block and step (f32 in shared memory, swizzled so a
//     lane's 16-byte reads hit distinct banks), by cp.async where x is a
//     16-byte aligned f32 view with unit stride along H -- the transposed
//     activations `layers.wdot` passes -- and element by element (bf16, or
//     any other strides) otherwise; one barrier a step;
//   * the decode, as the first version for the coded planes: lane l owns
//     bitmap bytes 2l and 2l+1 (16 columns of 4 rows); a coded plane takes
//     one warp exclusive scan of the lane's popcount and two
//     bstc::gather_byte calls on the staged segment (bstc_tile.cuh), each
//     4-bit pattern giving the plane's bit of the 4 rows.  Magnitudes are
//     held four columns a 32-bit word, a byte each (bit p = plane p, bit 7
//     = sign; |w| <= 127, so no byte carries).  The raw planes and the sign
//     of a row enter by two 8 x 8 bit transposes (three delta swaps each)
//     instead of a spread a plane and nibble, which was the decode's
//     largest integer cost.  The sign turns each byte into w + 128 without
//     carries, and a byte permute into the mantissa of 2^23 gives w in f32
//     with one subtraction;
//   * |w| <= 127 is exact in f32, so w * x is exact for f32 and bf16 x and
//     the sums are the only rounding; the scale is applied once at the end,
//     as the reference's bstc_matmul_ref does;
//   * a fixed-order sum: each warp reduces its 4 x NB partials over its
//     lanes into the block's shared part[4R][NB]; after a cluster barrier
//     each rank adds its share of those rows over ranks 0..C-1 in rank
//     order through distributed shared memory (K1's cluster_output,
//     paged_flash_decode.cu), scales and writes them, and a last cluster
//     barrier keeps every block's part alive until all ranks have read it.
//     No atomics: two launches give the same bits.
// Left out: a packed 4-bit pattern stream and a cheaper pattern gather (a
// format change and a new decode), tensor cores (the conversion of bits to
// weights, not the products, is the cost at N <= 8) and TMA (the segments
// are ragged and small).
//
// x and out are strided: the decode step's activations are (N, H) rows,
// read in place as x = a.T, and the result is written as the (N, M) rows
// the next layer reads, so no copy surrounds a launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bstc_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 4;        // BSTC/BRCR group m the kernel is built for
constexpr int kMaxWarps = 8;     // kernel.py MAX_WARPS: R, group rows a block
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxCluster = 8;   // kernel.py MAX_CLUSTER
constexpr int kMaxPlanes = 8;
constexpr int kMagPlanes = 7;    // magnitude planes 0..6: |w| <= 127
constexpr int kStepBytes = 64;   // kernel.py STEP_BYTES: bytes of a row a step
constexpr int kStepCols = 8 * kStepBytes;  // 512 columns: 32 lanes x 16
constexpr int kWindow = 544;     // kernel.py WINDOW: a step's pattern segment
                                 // (<= 512 slots) in 16-byte chunks
constexpr int kMeta = 160;       // kernel.py META: a stage's window table
constexpr int kMaxRows = kGroup * (1 + kMaxPlanes) + kMaxPlanes;  // staged rows a step
constexpr int kRowTable = 8 * kMaxRows;  // kernel.py ROW_TABLE: a warp's row pointers
constexpr int kMaxStages = 4;    // kernel.py MAX_STAGES
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;

struct Planes {
  const uint8_t* bitmap[kMaxPlanes];  // coded: (G, H/8)
  const int* offsets[kMaxPlanes];     // coded: (G, H/tile_k)
  const uint8_t* patterns[kMaxPlanes];  // coded: (G, cap)
  int cap[kMaxPlanes];
  int shift[kMaxPlanes];               // coded plane's index p
  const uint8_t* raw[kMaxPlanes];      // raw: (M, H/8)
  int raw_of[kMagPlanes];              // magnitude plane p -> its raw index, or -1
  int n_enc, n_raw;
};

// One launch's geometry (kernel.py Plan), checked on the host.
struct Geo {
  int R, C, T, NB, chunks, stages, smem, width, x_vec;
  int hb, tb, n_tiles;            // bytes of a row, bytes of a tile, tiles a row
  int rows;                       // staged rows a step: 4 sign, 4 a raw plane, 1 a coded
  int off_raw, off_bitmap, off_patt, stage_bytes;  // a warp stage's carve-up
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// f32 index of column c of a staged x column: 16-byte unit k = c/4 lives at
// k ^ ((k >> 3) & 3), so the 8 lanes of a 16-byte read phase (units 4l + q)
// hit 8 distinct bank groups.
__device__ __forceinline__ int x_pos(int c) {
  const int k = c >> 2;
  return ((k ^ ((k >> 3) & 3)) << 2) | (c & 3);
}

// 8 x 8 bit transpose (three delta swaps): lo / hi hold rows 0-3 / 4-7, a
// byte each with bit c = column c; on return they hold columns 0-3 / 4-7, a
// byte each with bit p = row p.
__device__ __forceinline__ void transpose8(unsigned& lo, unsigned& hi) {
  unsigned t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u;
  lo ^= t;
  hi ^= t >> 4;
}

// A stage's window table (kMeta bytes): per coded plane, the step's stream
// slot `start`, the staged slots [lo, hi), the byte at which slot lo sits
// in the staged segment, and `run`, the slot after the step (where a tile's
// next chunk starts).
struct Meta {
  int start[kMaxPlanes], lo[kMaxPlanes], hi[kMaxPlanes], skew[kMaxPlanes], run[kMaxPlanes];
};
static_assert(sizeof(Meta) == kMeta, "Meta is kernel.py META bytes");

// Issue one warp's copies of one step: the tile kt's chunk-th 64 bytes
// (nbytes of them) of each staged row (`rows`: their first bytes, from the
// warp's row table), then each coded plane's pattern segment, which starts
// at the tile's stored offset (chunk 0) or at `prev`'s run.
__device__ void issue_ops(const Planes& pl, const uint64_t* rows, uint8_t* st, const Geo& geo,
                          int g, int kt, int chunk, int nbytes, const Meta* prev, int lane) {
  // a lane per coded plane reads the step's stream offsets (in flight while
  // the rows are issued)
  int start = 0, bound = INT_MAX;
  if (lane < pl.n_enc) {
    const int* off = pl.offsets[lane] + (long long)g * geo.n_tiles + kt;
    start = chunk == 0 ? __ldg(off) : prev->run[lane];
    if (chunk == geo.chunks - 1 && kt + 1 < geo.n_tiles) bound = __ldg(off + 1);
  }
  const int w = geo.width, per = nbytes / w, n = geo.rows * per;
  const long long byte0 = (long long)kt * geo.tb + chunk * kStepBytes;
  for (int u = lane; u < n; u += 32) {
    const int r = per == 4 ? u >> 2 : u / per, k = (u - r * per) * w;
    uint8_t* d = st + kMeta + r * kStepBytes + k;
    const uint8_t* s = reinterpret_cast<const uint8_t*>(rows[r]) + byte0 + k;
    if (w == 16)
      cp16(d, s, 16);
    else if (w == 8)
      cp8(d, s);
    else if (w == 4)
      cp4(d, s);
    else
      *d = __ldg(s);
  }
  Meta* meta = reinterpret_cast<Meta*>(st);
#pragma unroll 1
  for (int e = 0; e < pl.n_enc; ++e) {
    const int cap = pl.cap[e];
    const int st_e = __shfl_sync(bstc::kFullMask, start, e);
    const int lo = min(max(st_e, 0), cap);
    const int hi = max(lo, min(min(cap, __shfl_sync(bstc::kFullMask, bound, e)), lo + 8 * nbytes));
    const long long rb = (long long)g * cap;  // the row's first byte
    const long long a0 = (rb + lo) & ~15LL;   // patterns is 16-byte aligned
    const int units = hi > lo ? (int)((rb + hi - a0 + 15) >> 4) : 0;
    uint8_t* d = st + geo.off_patt + e * kWindow;
    for (int u = lane; u < units; u += 32) {
      const long long a = a0 + 16LL * u;
      cp16(d + 16 * u, pl.patterns[e] + a, (int)min(16LL, rb + cap - a));
    }
    if (lane == 0) {
      meta->start[e] = st_e;
      meta->lo[e] = lo;
      meta->hi[e] = hi;
      meta->skew[e] = (int)(rb + lo - a0);
    }
  }
}

// Stage x[h0 .. h0 + cols) x [n0, n0 + nb) as f32 columns of kStepCols
// (block-wide).  Element copies zero the columns up to the next 16, so a
// lane whose second bitmap byte lies past the step multiplies w = 0 by 0.
__device__ void stage_x(float* xs, const void* x, int x_dtype, long long sx_h, long long sx_n,
                        long long h0, int cols, int n0, int nb, bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    const int per = cols >> 2;
    for (int u = tid; u < nb * per; u += nt) {
      const int n = per == kStepCols / 4 ? u / (kStepCols / 4) : u / per, k = u - n * per;
      cp16(xs + n * kStepCols + 4 * (k ^ ((k >> 3) & 3)),
           (const float*)x + h0 + 4 * k + (long long)(n0 + n) * sx_n, 16);
    }
    return;
  }
  const int span = (cols + 15) & ~15;
  for (int i = tid; i < nb * span; i += nt) {
    const int n = i / span, c = i - n * span;
    float v = 0.f;
    if (c < cols) {
      const long long at = (h0 + c) * sx_h + (long long)(n0 + n) * sx_n;
      v = x_dtype == 0 ? __ldg((const float*)x + at)
                       : __bfloat162float(((const __nv_bfloat16*)x)[at]);
    }
    xs[n * kStepCols + x_pos(c)] = v;
  }
}

// The C cluster blocks' copies of at[i], all loads in flight together
// (paged_flash_decode.cu gather_ranks).
__device__ __forceinline__ void gather_ranks(cg::cluster_group& cluster, float* at, int i,
                                             float (&y)[kMaxCluster]) {
  const int C = cluster.num_blocks();
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c)
    if (c < C) y[c] = cluster.map_shared_rank(at, c)[i];
}

template <int NB>
__global__ void __launch_bounds__(kMaxThreads, 2)
    bstc_matmul_kernel(Planes pl, const uint8_t* __restrict__ sign, const void* __restrict__ x,
                       int x_dtype, long long sx_h, long long sx_n,
                       const float* __restrict__ scale, float* __restrict__ out, long long so_m,
                       long long so_n, int M, int N, int tile_k, Geo geo) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = geo.R, G = M / kGroup;
  const int g = blockIdx.x * R + warp;
  const bool live = g < G;
  const int rank = blockIdx.y;  // cluster dims (1, C, 1), grid.y == C
  const int n0 = blockIdx.z * NB, nb = min(NB, N - n0);
  const int kt0 = rank * geo.T, kt1 = min(geo.n_tiles, kt0 + geo.T);
  const int steps = (kt1 - kt0) * geo.chunks;

  // carve-up (kernel.py smem_bytes): x stages, part, then each warp's row
  // table and stages
  float* xs = reinterpret_cast<float*>(smem);
  float* part = xs + geo.stages * NB * kStepCols;
  uint8_t* wbase = reinterpret_cast<uint8_t*>(part + kGroup * R * NB) +
                   warp * (kRowTable + geo.stages * geo.stage_bytes);
  uint64_t* rows = reinterpret_cast<uint64_t*>(wbase);
  uint8_t* wst = wbase + kRowTable;

  // the warp's staged rows at byte 0: 4 sign rows, 4 rows a raw plane, a
  // bitmap row a coded plane
  if (live) {
    for (int r = lane; r < geo.rows; r += 32) {
      const long long hb = geo.hb;
      const uint8_t* p;
      if (r < kGroup)
        p = sign + ((long long)g * kGroup + r) * hb;
      else if (r < kGroup * (1 + pl.n_raw))
        p = pl.raw[(r - kGroup) / kGroup] + ((long long)g * kGroup + (r & (kGroup - 1))) * hb;
      else
        p = pl.bitmap[r - kGroup * (1 + pl.n_raw)] + (long long)g * hb;
      rows[r] = reinterpret_cast<uint64_t>(p);
    }
    __syncwarp();
  }

  float acc[kGroup][NB];
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[r][n] = 0.f;

  auto stage_of = [&](int i) { return wst + ((i + geo.stages) % geo.stages) * geo.stage_bytes; };
  // Issue step i's copies (x block-wide, operands per live warp) as one
  // cp.async group; an empty group past the last step keeps the count.
  auto issue = [&](int i) {
    if (i < steps) {
      const int kt = kt0 + i / geo.chunks, chunk = i - (kt - kt0) * geo.chunks;
      const int nbytes = min(kStepBytes, geo.tb - chunk * kStepBytes);
      stage_x(xs + (i % geo.stages) * NB * kStepCols, x, x_dtype, sx_h, sx_n,
              (long long)kt * tile_k + chunk * kStepCols, 8 * nbytes, n0, nb, geo.x_vec);
      if (live)
        issue_ops(pl, rows, stage_of(i), geo, g, kt, chunk, nbytes,
                  reinterpret_cast<const Meta*>(stage_of(i + geo.stages - 1)), lane);
    }
    cp_commit();
  };
  // Prefetch distance: stages - 1 steps.  Where a tile takes several steps
  // (stages is then 2), a chunk's segment starts at the previous chunk's
  // run, which the warp counts from the staged bitmap before it issues.
  const int dist = max(1, geo.stages - 1);
  for (int i = -dist; i < steps; ++i) {
    uint8_t* st = stage_of(i);
    Meta* meta = reinterpret_cast<Meta*>(st);
    if (i >= 0) {
      // step i's group is complete once at most dist - 1 newer ones pend
      if (dist >= 3)
        asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      else if (dist == 2)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // step i's x and operands are in place; step i-1's buffers are free
      if (geo.chunks > 1 && live) {
        const int left = geo.tb - (i % geo.chunks) * kStepBytes - 2 * lane;  // the step's bytes
        const unsigned m = left >= 2 ? 0xffffu : left == 1 ? 0xffu : 0u;
#pragma unroll 1
        for (int e = 0; e < pl.n_enc; ++e) {
          const uint8_t* row = st + geo.off_bitmap + e * kStepBytes;
          const unsigned bm = m & *reinterpret_cast<const uint16_t*>(row + 2 * lane);
          int total;
          bstc::warp_exclusive_scan(__popc(bm), total);
          if (lane == 0) meta->run[e] = meta->start[e] + total;
        }
        __syncwarp();
      }
    }
    issue(i + dist);
    if (i < 0 || !live) continue;
    const int chunk = i % geo.chunks;
    const int nbytes = min(kStepBytes, geo.tb - chunk * kStepBytes);
    const float* xc = xs + (i % geo.stages) * NB * kStepCols;
    const int b0 = 2 * lane;
    const unsigned m16 = b0 + 1 < nbytes ? 0xffffu : b0 < nbytes ? 0xffu : 0u;
    auto u16 = [&](int off) { return (unsigned)*reinterpret_cast<const uint16_t*>(st + off + b0); };

    // mag[r][q]: columns 4q .. 4q+3 of the lane's 16, a byte each, bit p =
    // magnitude plane p, bit 7 = sign.  Coded planes first: the whole warp
    // scans the lanes' bitmap bytes for their stream slots; lanes with set
    // bits gather their patterns (a pattern's bit r is row r's bit).
    unsigned mag[kGroup][4];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) mag[r][q] = 0u;
#pragma unroll 1
    for (int e = 0; e < pl.n_enc; ++e) {
      const unsigned bmw = u16(geo.off_bitmap + e * kStepBytes) & m16;
      int total;
      const int excl = bstc::warp_exclusive_scan(__popc(bmw), total);
      if (bmw) {
        const int s = pl.shift[e], lo = meta->lo[e], len = meta->hi[e] - lo;
        const uint8_t* seg = st + geo.off_patt + e * kWindow + meta->skew[e];
        int f = meta->start[e] + excl - lo;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const unsigned bm = (bmw >> (8 * b)) & 0xffu;
          if (bm) {
            int patt[8];
            bstc::gather_byte(bm, f, seg, len, patt);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned w = (unsigned)patt[4 * h] | ((unsigned)patt[4 * h + 1] << 8) |
                                 ((unsigned)patt[4 * h + 2] << 16) |
                                 ((unsigned)patt[4 * h + 3] << 24);
#pragma unroll
              for (int r = 0; r < kGroup; ++r)
                mag[r][2 * b + h] |= ((w >> r) & 0x01010101u) << s;
            }
          }
          f += __popc(bm);
        }
      }
    }
    if (!m16) continue;
    // raw planes and the sign: per row, 8 bit-rows of the lane's 16 columns
    // (planes 0..6, absent ones zero; the sign as row 7) in two 8 x 8
    // transposes give each column's byte
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      unsigned v[8];
#pragma unroll
      for (int p = 0; p < kMagPlanes; ++p) {
        const int e = pl.raw_of[p];
        v[p] = e >= 0 ? u16(geo.off_raw + (e * kGroup + r) * kStepBytes) : 0u;
      }
      v[7] = u16(kMeta + r * kStepBytes);
      const unsigned a01 = __byte_perm(v[0], v[1], 0x5410), a23 = __byte_perm(v[2], v[3], 0x5410);
      const unsigned a45 = __byte_perm(v[4], v[5], 0x5410), a67 = __byte_perm(v[6], v[7], 0x5410);
      unsigned c0 = __byte_perm(a01, a23, 0x6420), c1 = __byte_perm(a45, a67, 0x6420);
      unsigned c2 = __byte_perm(a01, a23, 0x7531), c3 = __byte_perm(a45, a67, 0x7531);
      transpose8(c0, c1);
      transpose8(c2, c3);
      const unsigned hi_ok = m16 == 0xffffu ? ~0u : 0u;  // the second byte lies in the step
      mag[r][0] |= c0;
      mag[r][1] |= c1;
      mag[r][2] = (mag[r][2] | c2) & hi_ok;
      mag[r][3] = (mag[r][3] | c3) & hi_ok;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * lane + q;
      float4 xv[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n)
        xv[n] = *reinterpret_cast<const float4*>(xc + n * kStepCols + 4 * (k ^ ((k >> 3) & 3)));
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        // bytes of w + 128: |w| = bits 0-6, negated where bit 7 is set
        const unsigned m = mag[r][q], S = (m >> 7) & 0x01010101u;
        const unsigned u = ((m & 0x7f7f7f7fu) ^ (S * 0xffu) ^ 0x80808080u) + S;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // 0x4B0000uu is 2^23 + u in f32: w = that - (2^23 + 128), exactly
          const float w = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) - 8388736.0f;
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const float xj = j == 0 ? xv[n].x : j == 1 ? xv[n].y : j == 2 ? xv[n].z : xv[n].w;
            acc[r][n] = fmaf(w, xj, acc[r][n]);
          }
        }
      }
    }
  }

  // the warp's partials, then the cluster's sum in rank order
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float v = acc[r][n];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(bstc::kFullMask, v, o);
      if (lane == 0) part[(warp * kGroup + r) * NB + n] = v;
    }
  cluster.sync();
  const int C = geo.C, E = kGroup * R * NB, per = (E + C - 1) / C;
  const int i0 = rank * per, i1 = min(E, i0 + per);
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    float y[kMaxCluster];
    gather_ranks(cluster, part, i, y);
    float v = y[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < C) v += y[c];
    const int row = blockIdx.x * R * kGroup + i / NB, n = i % NB;
    if (row < M && n < nb) {
      if (scale != nullptr) v *= scale[row];
      out[row * so_m + (n0 + n) * so_n] = v;
    }
  }
  cluster.sync();
}

struct Launch {
  Planes pl;
  const uint8_t* sign;
  const void* x;
  int x_dtype;
  long long sx_h, sx_n;
  const float* scale;
  float* out;
  long long so_m, so_n;
  int M, N, tile_k;
  Geo geo;
  cudaStream_t st;
};

template <int NB>
int launch_nb(const Launch& a) {
  auto kern = bstc_matmul_kernel<NB>;
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return (int)err;
  if (a.geo.smem > (48 << 10) && (dev >= kMaxDevices || a.geo.smem > allowed[dev])) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.geo.smem);
    if (err) return (int)err;
    if (dev < kMaxDevices) allowed[dev] = a.geo.smem;
  }
  const int G = a.M / kGroup;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((G + a.geo.R - 1) / a.geo.R, a.geo.C, (a.N + NB - 1) / NB);
  cfg.blockDim = dim3(32 * a.geo.R);
  cfg.dynamicSmemBytes = a.geo.smem;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.geo.C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a.pl, a.sign, a.x, a.x_dtype, a.sx_h, a.sx_n, a.scale,
                           a.out, a.so_m, a.so_n, a.M, a.N, a.tile_k, a.geo);
  return (int)(err ? err : cudaGetLastError());
}

bool aligned(const void* p, int width) { return ((uintptr_t)p % (uintptr_t)width) == 0; }

}  // namespace

extern "C" {

// desc: host array [n_enc, n_raw, then per coded plane (bitmap, offsets,
// patterns, cap, p), then per raw plane (plane, p)], pointers as integers;
// plane indices p lie in 0..6 and each appears once.  sign (M, H/8) u8; x
// (H, N) at element strides (x_h, x_n), x_dtype 0 = f32, 1 = bf16; scale
// (M,) f32 or null; out (M, N) f32 at element strides (out_m, out_n).  plan:
// host array [R, C, T, NB, chunks, stages, smem, row copy width, x copy
// width] from kernel.py `plan`, checked here against the shapes.  m = 4,
// M % 4 == 0, H % tile_k == 0, tile_k % 8 == 0 (the wrapper checks).
// Returns cudaErrorInvalidValue for operands or a plan the kernel does not
// take, else the launch's cudaError_t.
int bstc_matmul_launch(const long long* desc, const void* sign, const void* x, int x_dtype,
                       long long x_h, long long x_n, const void* scale, void* out,
                       long long out_m, long long out_n, int M, int H, int N, int tile_k,
                       const int* plan, void* stream) {
  Launch a = {};
  Planes& pl = a.pl;
  pl.n_enc = (int)desc[0];
  pl.n_raw = (int)desc[1];
  if (pl.n_enc < 0 || pl.n_raw < 0 || pl.n_enc + pl.n_raw > kMagPlanes)
    return (int)cudaErrorInvalidValue;
  Geo& geo = a.geo;
  geo.R = plan[0];
  geo.C = plan[1];
  geo.T = plan[2];
  geo.NB = plan[3];
  geo.chunks = plan[4];
  geo.stages = plan[5];
  geo.smem = plan[6];
  geo.width = plan[7];
  geo.x_vec = plan[8] == 16;
  geo.hb = H / 8;
  geo.tb = tile_k / 8;
  geo.n_tiles = H / tile_k;
  geo.rows = kGroup * (1 + pl.n_raw) + pl.n_enc;
  geo.off_raw = kMeta + kGroup * kStepBytes;
  geo.off_bitmap = geo.off_raw + pl.n_raw * kGroup * kStepBytes;
  geo.off_patt = geo.off_bitmap + pl.n_enc * kStepBytes;
  geo.stage_bytes = geo.off_patt + pl.n_enc * kWindow;
  const int w = geo.width;
  const bool ok =
      geo.R >= 1 && geo.R <= kMaxWarps && geo.C >= 1 && geo.C <= kMaxCluster && geo.T >= 1 &&
      (geo.C - 1) * geo.T < geo.n_tiles && geo.n_tiles <= geo.C * geo.T &&
      (geo.NB == 1 || geo.NB == 2 || geo.NB == 4 || geo.NB == 8) &&
      (N + geo.NB - 1) / geo.NB <= 65535 &&
      geo.chunks == (geo.tb + kStepBytes - 1) / kStepBytes &&
      (geo.T * geo.chunks == 1 ? geo.stages == 1
       : geo.chunks > 1        ? geo.stages == 2
                               : geo.stages >= 2 && geo.stages <= kMaxStages) &&
      (w == 1 || w == 4 || w == 8 || w == 16) && geo.hb % w == 0 && geo.tb % w == 0 &&
      geo.smem == 4 * geo.stages * geo.NB * kStepCols + 4 * kGroup * geo.R * geo.NB +
                      geo.R * (kRowTable + geo.stages * geo.stage_bytes) &&
      geo.smem <= kMaxSmem &&
      (plan[8] == 0 || (plan[8] == 16 && x_dtype == 0 && x_h == 1 && (N == 1 || x_n % 4 == 0) &&
                        geo.tb % 2 == 0 && aligned(x, 16)));
  if (!ok) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < kMagPlanes; ++p) pl.raw_of[p] = -1;
  unsigned seen = 0;
  const long long* d = desc + 2;
  for (int e = 0; e < pl.n_enc; ++e, d += 5) {
    pl.bitmap[e] = (const uint8_t*)d[0];
    pl.offsets[e] = (const int*)d[1];
    pl.patterns[e] = (const uint8_t*)d[2];
    pl.cap[e] = (int)d[3];
    pl.shift[e] = (int)d[4];
    if (!aligned(pl.bitmap[e], w) || !aligned(pl.patterns[e], 16) || pl.cap[e] < 1 ||
        pl.shift[e] < 0 || pl.shift[e] >= kMagPlanes || (seen >> pl.shift[e]) & 1u)
      return (int)cudaErrorInvalidValue;
    seen |= 1u << pl.shift[e];
  }
  for (int e = 0; e < pl.n_raw; ++e, d += 2) {
    pl.raw[e] = (const uint8_t*)d[0];
    const int p = (int)d[1];
    if (!aligned(pl.raw[e], w) || p < 0 || p >= kMagPlanes || (seen >> p) & 1u)
      return (int)cudaErrorInvalidValue;
    seen |= 1u << p;
    pl.raw_of[p] = e;
  }
  if (!aligned(sign, w)) return (int)cudaErrorInvalidValue;
  a.sign = (const uint8_t*)sign;
  a.x = x;
  a.x_dtype = x_dtype;
  a.sx_h = x_h;
  a.sx_n = x_n;
  a.scale = (const float*)scale;
  a.out = (float*)out;
  a.so_m = out_m;
  a.so_n = out_n;
  a.M = M;
  a.N = N;
  a.tile_k = tile_k;
  a.st = (cudaStream_t)stream;
  switch (geo.NB) {
    case 1: return launch_nb<1>(a);
    case 2: return launch_nb<2>(a);
    case 4: return launch_nb<4>(a);
    default: return launch_nb<8>(a);
  }
}

}  // extern "C"
