// BRCR GEMM: out = w_q @ x through the bit-slice repetitiveness
// factorization, from the signed-plane group patterns of the int8 weight.
//
// Replaces: src/repro/kernels/brcr_gemm/kernel.py, brcr_gemm_pallas (body
//   _kernel): per signed plane p (+2^0..+2^6, then -2^0..-2^6) the MAV
//   Z = one-hot(patterns) @ x on the MXU, then E @ Z, then +-2^p
//   accumulation in f32; (p, M tile, H tile) tiles whose patterns are all
//   zero are skipped.
//
// What bounds it on the H100: tensor-core multiply-adds and the integer
// work that builds their one-hot operand, not bytes.  The one-hot MAV has
// 2^m * P / m = 56 times the multiply-adds of the dense product at m = 4
// (45 GFLOP at 8192 x 3072, N 16, one bf16 term of x), and f32 x takes
// three bf16 terms; the patterns are 3.5 bytes a weight, read once (0.0265
// ms at 3.35 TB/s for 8192 x 3072).  At few columns of x (one or two mma a
// one-hot operand) the chain that builds the operand binds before the
// tensor cores: per plane and row tile a warp votes its pattern words and
// spends ~12 dependent 32-bit integer instructions a thread on the
// fragment, and more columns add mma almost for free (chip_smoke.py's
// brcr_device_phase times N 4, 16 and 128).  Times: PERF.md, K7.
//
// What the design does:
//   * the MAV on the tensor cores: mma.sync m16n8k16, bf16 in, f32
//     accumulate.  A is 16 one-hot rows -- the 2^m bins of 16 / 2^m groups
//     -- by 16 columns of H, built in registers from the pattern bytes, with
//     the plane's weight +-2^p (exact in bf16) as its non-zero entry, so
//     every plane accumulates into ONE Z and E @ Z runs once an output
//     tile, from the accumulator fragments by warp shuffles.  B is the x
//     tile.  The mma's k index 2t+e / 2t+8+e is H column 4t+e / 4t+2+e,
//     so a lane's four pattern bytes are one 32-bit word and its B operand
//     one 8-byte read;
//   * one-hot from a pattern word w: bytes q = w ^ (bin * 0x01010101) are
//     < 16, so 0x80808080 - q has bit 7 of a byte set exactly where the
//     pattern is the lane's bin; prmt's sign replication spreads that bit
//     over a bf16 half and an AND puts +-2^p there (xor, sub, 4 prmt, 4 and
//     a fragment);
//   * exact where the first kernel was: f32 x is staged as hi = bf16(x),
//     mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x exactly,
//     and each A fragment feeds all three products; a tile whose mid terms
//     are all 0 (so lo too: integers below 2^8 in magnitude, as the
//     quickstart's) multiplies hi alone.  Bf16 x is one term.
//     Integer x: a bin gathers only columns where bit p of |w| of one of
//     its rows is set, so every partial sum (in the mma, between tiles,
//     in E @ Z and across the cluster) is an integer within Sum|w| *
//     (|hi| + |mid| + |lo|) <= (1 + 2^-7) Sum|w * x| of a row: exact below
//     2^24.  The mma's f32 sums truncate, so each 128-column tile (64 at
//     m = 2) accumulates from zero and is added to the running sum in
//     round-to-nearest f32;
//   * filling the card: a block of 4 warps owns 8 row tiles (8 groups at
//     m = 4, 32 at m = 2) and up to 32 columns of x; a thread-block
//     cluster of C <= 8 blocks along y splits the H tiles, rank c owning
//     [c T, (c + 1) T); ranks add their E @ Z results in rank order through
//     distributed shared memory (as K1-K3 do), so the result does not
//     depend on scheduling and two launches give the same bits.  C comes
//     from kernel.py `plan` (8192 x 3072, N 16: 256 row blocks x C 2);
//   * bytes: patterns as 16-byte cp.async copies (8 / 4 / 1 where H is not
//     so aligned) into a double-buffered stage of every plane's rows of
//     the tile; x staged once a tile, as its bf16 terms, and then read by
//     every plane;
//   * skips: a warp votes each (plane, 16-column) step of its two row
//     tiles and builds and multiplies nothing where every pattern is 0
//     (which also skips every (plane, row tile, H tile) tile with no
//     non-zero pattern, the TPU kernel's tile_any).  The step's pattern
//     words and plane weights are loaded 8 planes at a time ahead of the
//     votes, and the two row tiles' products interleave, so consecutive
//     mma do not wait on one accumulator;
//   * edges: m is 2 or 4; M need only be a multiple of m, N and H any size
//     (groups past G and columns past H are staged as 0, columns past N
//     masked at the store); x is read at its strides as f32 or bf16; out
//     is f32 (M, N) at its strides.  Plane weights must be exact in bf16
//     (the format's +-2^p are): the launch writes NaN rather than a wrong
//     product otherwise.
// Left out: wgmma (its A from registers would need the one-hot in the
// warpgroup layout), a packed 4-bit pattern stream (bytes are not the
// limit) and TMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;                 // kernel.py WARPS
constexpr int kThreads = 32 * kWarps;
constexpr int kRT = 2;                    // kernel.py ROW_TILES: 16-row tiles a warp
constexpr int kPad = 16;                  // kernel.py PAD: bytes / bf16 past a staged row
constexpr int kMaxCluster = 8;            // kernel.py MAX_CLUSTER
constexpr int kMaxPlanes = 16;            // kernel.py MAX_PLANES
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// One launch's geometry (kernel.py Plan), checked on the host.
struct Geo {
  int C, T, n_tiles;   // blocks a cluster, H tiles a rank, H tiles
  int width, shift;    // pattern copy width (bytes) and log2(tile columns / width)
  int x_h_fast;        // x has unit stride along H: threads walk H first
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// cp.async of 16 / 8 / 4 bytes: the source's first n, zeros after them
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp8(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// prmt in its default mode: a selector nibble of 8 + i gives byte i's sign
// bit replicated over the output byte.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0u), "r"(sel));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The kernel's compile-time shape: kTerms bf16 terms of x (3: f32 x, 1:
// bf16 x), kNT n-tiles of 8 columns.
template <int kM, int kNT, int kTerms>
struct Shape {
  static constexpr int kBins = 1 << kM;
  static constexpr int kGpt = 16 >> kM;             // groups a 16-row tile
  static constexpr int kGB = kWarps * kRT * kGpt;   // groups a block
  static constexpr int kTK = kM == 4 ? 128 : 64;    // kernel.py TILE_K: H columns a tile
  static constexpr int kRow = kTK + kPad;           // a staged row: pattern bytes, x bf16
  static constexpr int kNB = 8 * kNT;               // columns of x a block
  static constexpr int kRows = kGB * kM;            // output rows a block
  // dynamic shared memory (kernel.py smem_bytes) for P planes: two pattern
  // stages, the x terms, the E @ Z part, the plane weights
  __host__ __device__ static constexpr int stage(int P) { return P * kGB * kRow; }
  __host__ __device__ static constexpr int x_off(int P) { return 2 * stage(P); }
  __host__ __device__ static constexpr int part_off(int P) {
    return x_off(P) + 2 * kTerms * kNB * kRow;
  }
  __host__ __device__ static constexpr int pw_off(int P) { return part_off(P) + 4 * kRows * kNB; }
  __host__ __device__ static constexpr int smem(int P) { return pw_off(P) + 4 * kMaxPlanes; }
};

template <int kM, int kNT, int kTerms>
__global__ void __launch_bounds__(kThreads, (kNT == 4 && kTerms == 3) ? 3 : 4)
    brcr_gemm_kernel(const uint8_t* __restrict__ idx, const float* __restrict__ pw,
                     const void* __restrict__ xv, long long sx_h, long long sx_n,
                     float* __restrict__ out, long long so_m, long long so_n, int P, int G,
                     int H, int N, Geo geo) {
  using S = Shape<kM, kNT, kTerms>;
  using XT = typename std::conditional<kTerms == 3, float, __nv_bfloat16>::type;
  constexpr int kBins = S::kBins, kGpt = S::kGpt, kGB = S::kGB, kTK = S::kTK;
  constexpr int kRow = S::kRow, kNB = S::kNB, kRows = S::kRows;
  constexpr int kChunk = 8;  // planes whose pattern words a step holds at once
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* patt = smem;  // [2][P][kGB][kRow]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + S::x_off(P));  // [terms][kNB][kRow]
  float* part = reinterpret_cast<float*>(smem + S::part_off(P));              // [kRows][kNB]
  uint32_t* pw2 = reinterpret_cast<uint32_t*>(smem + S::pw_off(P));  // [kMaxPlanes], P set
  const XT* x = static_cast<const XT*>(xv);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma's groupID and thread in group
  const int n0 = blockIdx.x * kNB;
  const int rank = blockIdx.y;  // cluster dims (1, C, 1), grid.y == C
  const int g0 = blockIdx.z * kGB;
  const int kt0 = rank * geo.T, tiles = max(0, min(geo.n_tiles, kt0 + geo.T) - kt0);
  const int stage_bytes = S::stage(P);

  // plane weights as bf16 pairs; a weight bf16 does not hold poisons the output
  bool inexact = false;
  if (tid < P) {
    const float v = pw[tid];
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    inexact = __bfloat162float(b) != v;
    const uint32_t u = *reinterpret_cast<const uint16_t*>(&b);
    pw2[tid] = u | (u << 16);
  }

  // Stage tile kt's pattern rows of every plane (plane-major, padded rows)
  // as one cp.async group; rows past G and columns past H are zero.
  auto issue = [&](int kt, int s) {
    uint8_t* dst = patt + s * stage_bytes;
    const long long h0 = (long long)kt * kTK;
    const int w = geo.width, sh = geo.shift, per = 1 << sh;
    for (int u = tid; u < P * kGB * per; u += kThreads) {
      const int row = u >> sh, c = (u & (per - 1)) * w;
      const int p = row / kGB, gg = g0 + row - p * kGB;
      const long long h = h0 + c;
      const bool in = gg < G && h < H;  // H % w == 0: a copy lies wholly in or out
      const uint8_t* src = in ? idx + ((long long)p * G + gg) * H + h : idx;
      uint8_t* d = dst + row * kRow + c;
      if (w == 16)
        cp16(d, src, in ? 16 : 0);
      else if (w == 8)
        cp8(d, src, in ? 8 : 0);
      else if (w == 4)
        cp4(d, src, in ? 4 : 0);
      else
        *d = in ? __ldg(src) : (uint8_t)0;
    }
    cp_commit();
  };

  // Stage tile kt of x as its bf16 terms, two columns of H a thread and
  // store; past H and N it is 0 (a 0 times a stale NaN would poison the
  // bins through the mma).  Returns whether a mid term of the thread's is
  // non-zero (lo is zero wherever mid is: the tile then needs hi alone).
  auto stage_x = [&](int kt) {
    bool low = false;
    const long long h0 = (long long)kt * kTK;
    constexpr int kPairs = kTK / 2;
    for (int u = tid; u < kNB * kPairs; u += kThreads) {
      const int n = geo.x_h_fast ? u / kPairs : u % kNB;
      const int hp = geo.x_h_fast ? u % kPairs : u / kNB;
      const long long h = h0 + 2 * hp;
      const int nn = n0 + n;
      float v0 = 0.f, v1 = 0.f;
      if (nn < N) {
        const XT* col = x + (long long)nn * sx_n;
        if (h < H) v0 = to_f(col[h * sx_h]);
        if (h + 1 < H) v1 = to_f(col[(h + 1) * sx_h]);
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
      uint32_t* d = reinterpret_cast<uint32_t*>(xs + n * kRow + 2 * hp);
      d[0] = bits(hi);
      if (kTerms == 3) {
        v0 -= __low2float(hi);
        v1 -= __high2float(hi);
        const __nv_bfloat162 mid = __floats2bfloat162_rn(v0, v1);
        v0 -= __low2float(mid);
        v1 -= __high2float(mid);
        d[kNB * kRow / 2] = bits(mid);
        d[kNB * kRow] = bits(__floats2bfloat162_rn(v0, v1));
        low |= bits(mid) != 0u;
      }
    }
    return low;
  };

  // the lane's two A rows g and g + 8 of a tile: their group in the tile and
  // bin, as a byte repeated four times
  const int ga = g >> kM, gb = (g + 8) >> kM;
  const uint32_t Ra = (uint32_t)(g & (kBins - 1)) * 0x01010101u;
  const uint32_t Rb = (uint32_t)((g + 8) & (kBins - 1)) * 0x01010101u;

  float acc[kRT][kNT][4], fresh[kRT][kNT][4];
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

  // One tile's MAV into fresh, kUse terms of x.  Each 16-column step
  // loads the pattern words of kChunk planes of both row tiles, and their
  // weights, at once; a plane with no pattern in the warp's rows costs no
  // one-hot and no mma, and the two row tiles' products interleave.
  auto mav = [&](const uint8_t* ps, auto use) {
    constexpr int kUse = decltype(use)::value;
#pragma unroll 1
    for (int ks = 0; ks < kTK / 16; ++ks) {
      // B: x at n-tile j, column g; H columns 4t .. 4t + 3 of the step
      uint32_t b[kNT][kUse][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < kUse; ++e) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              xs + ((e * kNB + 8 * j + g) * kRow) + 16 * ks + 4 * t);
          b[j][e][0] = v.x;
          b[j][e][1] = v.y;
        }
      const uint8_t* rows = ps + 16 * ks + warp * kRT * kGpt * kRow;
#pragma unroll
      for (int c = 0; c < kMaxPlanes; c += kChunk) {
        if (c >= P) break;
        uint32_t wa[kRT][kChunk], wb[kRT][kChunk], wp[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
#pragma unroll
          for (int r = 0; r < kRT; ++r) {
            const uint8_t* rp = rows + ((c + q) * kGB + r * kGpt) * kRow;
            const bool in = c + q < P;
            wa[r][q] = in ? *reinterpret_cast<const uint32_t*>(rp + ga * kRow) : 0u;
            wb[r][q] = kM == 4 ? wa[r][q]
                               : in ? *reinterpret_cast<const uint32_t*>(rp + gb * kRow) : 0u;
          }
#pragma unroll
        for (int q = 0; q < kChunk; q += 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(pw2 + c + q);
          wp[q] = v.x;
          wp[q + 1] = v.y;
          wp[q + 2] = v.z;
          wp[q + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          uint32_t any = 0;
#pragma unroll
          for (int r = 0; r < kRT; ++r) any |= wa[r][q] | wb[r][q];
          if (!__any_sync(kFull, any != 0)) continue;  // no pattern in the warp's rows
#pragma unroll
          for (int r = 0; r < kRT; ++r) {
            const uint32_t ya = 0x80808080u - (wa[r][q] ^ Ra);
            const uint32_t yb = 0x80808080u - (wb[r][q] ^ Rb);
            const uint32_t a[4] = {prmt(ya, 0x9988u) & wp[q], prmt(yb, 0x9988u) & wp[q],
                                   prmt(ya, 0xBBAAu) & wp[q], prmt(yb, 0xBBAAu) & wp[q]};
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
              for (int e = 0; e < kUse; ++e) mma_bf16(fresh[r][j], a, b[j][e]);
          }
        }
      }
    }
  };

  if (tiles > 0) issue(kt0, 0);
  const bool poison = __syncthreads_or(inexact);  // also: pw2 is in place
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles)
      issue(kt0 + i + 1, (i + 1) & 1);
    else
      cp_commit();  // an empty group keeps the count
    const bool low = stage_x(kt0 + i);
    cp_wait_one();  // tile i's patterns have landed
    // the tile's x needs its mid and lo terms (in no lane zero)
    const bool full = __syncthreads_or(low);
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) fresh[r][j][e] = 0.f;
    const uint8_t* ps = patt + (i & 1) * stage_bytes + 4 * t;
    if (kTerms > 1 && full)
      mav(ps, std::integral_constant<int, kTerms>{});
    else
      mav(ps, std::integral_constant<int, 1>{});
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] += fresh[r][j][e];
    __syncthreads();  // x and this pattern stage are free again
  }

  // E @ Z: y_j = the sum of the bins with bit j, over the lanes holding the
  // tile's bins (fixed shuffle order), into the block's part rows
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int tile_g = (warp * kRT + r) * kGpt;  // the tile's first local group
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float za = acc[r][j][e], zb = acc[r][j][2 + e];
        if (kM == 4) {  // bins g and g + 8 of one group; bin 0 feeds no row
          const float s = za + zb;
          float y[4] = {(g & 1) ? s : 0.f, (g & 2) ? s : 0.f, (g & 4) ? s : 0.f, zb};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) y[q] += __shfl_xor_sync(kFull, y[q], o);
          if (g == 0)
#pragma unroll
            for (int q = 0; q < 4; ++q) part[(tile_g * 4 + q) * kNB + col] = y[q];
        } else {  // m = 2: row g is bin g & 3 of group g >> 2, row g + 8 of group 2 + (g >> 2)
          const int bin = g & 3;
          float y[4] = {(bin & 1) ? za : 0.f, (bin & 2) ? za : 0.f, (bin & 1) ? zb : 0.f,
                        (bin & 2) ? zb : 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int o = 4; o < 16; o <<= 1) y[q] += __shfl_xor_sync(kFull, y[q], o);
          if (bin == 0) {
            part[((tile_g + ga) * 2 + 0) * kNB + col] = y[0];
            part[((tile_g + ga) * 2 + 1) * kNB + col] = y[1];
            part[((tile_g + gb) * 2 + 0) * kNB + col] = y[2];
            part[((tile_g + gb) * 2 + 1) * kNB + col] = y[3];
          }
        }
      }
  }

  // the cluster's sum in rank order through distributed shared memory
  cluster.sync();
  const int C = geo.C, E = kRows * kNB, per = (E + C - 1) / C;
  const int i1 = min(E, (rank + 1) * per);
  const long long M = (long long)G * kM;
  for (int i = rank * per + tid; i < i1; i += kThreads) {
    float y[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < C) y[c] = cluster.map_shared_rank(part, c)[i];
    float v = y[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < C) v += y[c];
    const long long row = (long long)g0 * kM + i / kNB;
    const int n = n0 + i % kNB;
    if (row < M && n < N) out[row * so_m + (long long)n * so_n] = poison ? NAN : v;
  }
  cluster.sync();  // every block's part stays alive until all ranks have read it
}

struct Args {
  const uint8_t* idx;
  const float* pw;
  const void* x;
  long long sx_h, sx_n;
  float* out;
  long long so_m, so_n;
  int P, G, H, N;
  Geo geo;
  dim3 grid;
  int smem;
  cudaStream_t st;
};

template <int kM, int kNT, int kTerms>
int launch_t(const Args& a) {
  auto kern = brcr_gemm_kernel<kM, kNT, kTerms>;
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return (int)err;
  if (a.smem > (48 << 10) && (dev >= kMaxDevices || a.smem > allowed[dev])) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err) return (int)err;
    if (dev < kMaxDevices) allowed[dev] = a.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = a.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.geo.C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a.idx, a.pw, a.x, a.sx_h, a.sx_n, a.out, a.so_m, a.so_n,
                           a.P, a.G, a.H, a.N, a.geo);
  return (int)(err ? err : cudaGetLastError());
}

template <int kM, int kTerms>
int launch_nt(const Args& a, int NT) {
  switch (NT) {
    case 1: return launch_t<kM, 1, kTerms>(a);
    case 2: return launch_t<kM, 2, kTerms>(a);
    default: return launch_t<kM, 4, kTerms>(a);
  }
}

template <int kM>
int smem_of(int NT, int terms, int P) {
  if (terms == 3)
    return NT == 1 ? Shape<kM, 1, 3>::smem(P) : NT == 2 ? Shape<kM, 2, 3>::smem(P)
                                                        : Shape<kM, 4, 3>::smem(P);
  return NT == 1 ? Shape<kM, 1, 1>::smem(P) : NT == 2 ? Shape<kM, 2, 1>::smem(P)
                                                      : Shape<kM, 4, 1>::smem(P);
}

}  // namespace

extern "C" {

// idx (P, G, H) uint8 contiguous, patterns < 2^m; pw (P,) f32, each exact
// in bf16; x (H, N) at element strides (sx_h, sx_n), x_dtype 0 = f32, 1 =
// bf16; out (G*m, N) f32 at element strides (so_m, so_n); m in {2, 4}.
// plan: host int array [NT, terms, tile columns, C, T, copy width, smem,
// grid x, grid y, grid z] from kernel.py `plan`, checked here against the
// shapes.  Returns cudaErrorInvalidValue for what the kernel does not take,
// else the launch's cudaError_t.
int brcr_gemm_launch(const void* idx, const void* pw, const void* x, int x_dtype,
                     long long sx_h, long long sx_n, void* out, long long so_m, long long so_n,
                     int P, int G, int H, int N, int m, const int* plan, void* stream) {
  const int NT = plan[0], terms = plan[1], K = plan[2], w = plan[5];
  Args a = {};
  Geo& geo = a.geo;
  geo.C = plan[3];
  geo.T = plan[4];
  geo.width = w;
  a.smem = plan[6];
  a.grid = dim3((unsigned)plan[7], (unsigned)plan[8], (unsigned)plan[9]);
  const int GB = kWarps * kRT * (16 >> (m == 2 ? 2 : 4));
  geo.n_tiles = K > 0 ? (H + K - 1) / K : 0;
  const int per = w > 0 ? K / w : 0;
  geo.shift = per > 0 ? __builtin_ctz((unsigned)per) : 0;
  geo.x_h_fast = sx_h == 1;
  const bool ok =
      (m == 2 || m == 4) && K == (m == 4 ? 128 : 64) && P >= 1 && P <= kMaxPlanes && G >= 1 &&
      H >= 1 && N >= 1 && (NT == 1 || NT == 2 || NT == 4) &&
      (x_dtype == 0 || x_dtype == 1) && terms == (x_dtype == 0 ? 3 : 1) && geo.C >= 1 &&
      geo.C <= kMaxCluster && geo.T >= 1 && (geo.C - 1) * geo.T < geo.n_tiles &&
      geo.n_tiles <= geo.C * geo.T && (w == 1 || w == 4 || w == 8 || w == 16) && H % w == 0 &&
      (uintptr_t)idx % (uintptr_t)w == 0 && (per & (per - 1)) == 0 &&
      a.smem == (m == 4 ? smem_of<4>(NT, terms, P) : smem_of<2>(NT, terms, P)) &&
      a.smem <= kMaxSmem && (long long)plan[7] == (N + 8LL * NT - 1) / (8LL * NT) &&
      plan[8] == geo.C && (long long)plan[9] == (G + GB - 1LL) / GB && plan[9] <= 65535;
  if (!ok) return (int)cudaErrorInvalidValue;
  a.idx = (const uint8_t*)idx;
  a.pw = (const float*)pw;
  a.x = x;
  a.sx_h = sx_h;
  a.sx_n = sx_n;
  a.out = (float*)out;
  a.so_m = so_m;
  a.so_n = so_n;
  a.P = P;
  a.G = G;
  a.H = H;
  a.N = N;
  a.st = (cudaStream_t)stream;
  if (m == 4) return terms == 3 ? launch_nt<4, 3>(a, NT) : launch_nt<4, 1>(a, NT);
  return terms == 3 ? launch_nt<2, 3>(a, NT) : launch_nt<2, 1>(a, NT);
}

}  // extern "C"
