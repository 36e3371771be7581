// Tiled online-softmax GQA attention (the whole-sequence forward's attend).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (body _kernel): causal / sliding / chunked / full
//   masks, GQA (query head h reads kv head h / g), fully masked key tiles
//   skipped by the same index-range predicate; and the VLM's prefix_causal
//   mask, which the reference runs in its jnp blocked_attend
//   (src/repro/core/attention.py): full attention inside the first w
//   positions (the image prefix), causal after.
//
// What bounds it on the H100.  At the eager admission's longest prompt
// (B 1, S 450, Hq 24, Hk 8, D 128, causal, bf16) it must read q, k and v
// once and write out once: 2 * 450*24*128*2 + 2 * 450*8*128*2 B = 7.37 MB,
// 2.2 us at 3.35 TB/s.  Its operations are 4 * D per visible (query, key)
// pair: 4*128 * (450*451/2) * 24 = 1.25 GFLOP, 1.3 us at the bf16 tensor
// cores' 989 TFLOP/s.  So the bound is ~0.0022 ms, by bytes (0.0025 ms at
// the kernel phase's S 512).
//
// Two bodies.
//
// bf16 operands: a FlashAttention-2-style kernel on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).  What a CUDA-core body
// like the f32 one below costs at bf16, and what this one does about it:
//   * f32 FMAs on the CUDA cores, a shared-memory load for every 2-3 FMAs
//     -> QK^T and PV are mma.sync products.  Q is loaded once into
//     registers as A fragments (ldmatrix); K is read with ldmatrix and V
//     with ldmatrix.trans, one 16 x 16 operand an instruction.
//   * element-wide staging with nothing in flight -> 64-key K / V tiles
//     are copied with cp.async, 16 bytes a thread, into two stages: tile
//     t + 1 is in flight while tile t computes.  Rows at or past Sk are
//     zero-filled (src-size 0).  Each row's 16-byte chunks are XOR-swizzled
//     by the row, so the 8 rows one ldmatrix phase reads hit 8 different
//     bank groups.
//   * 115,456 B of f32 tiles a block at D 128 -> bf16 tiles: Q (32 x D)
//     and two stages of K and V (64 x D each), 72 KB at D 128.
//   * a P tile through shared memory -> none: the m16n8 f32 accumulator
//     fragments of S are, pair by pair, the m16n8k16 A fragments of the PV
//     product, so p never leaves registers.
//   * 4-8 warps an SM, and the causal grid's heaviest query tile as its
//     critical path -> a block is 32 query rows of one (batch, query head):
//     2 row groups of 16 rows x 2 key halves, one warp each; a warp takes
//     its 16 rows against 32 keys (its half) of every 64-key tile, and the
//     two warps of a row group merge their (m, l, acc) through shared
//     memory at the end.  That halves the serial chain of the heaviest
//     tile, and the block's 168 registers a thread and 72 KB let three
//     blocks (12 warps) share an SM: B 1, Hq 24 gives 168 blocks at S 201
//     and 384 at S 512, one wave on 132 SMs.  The grid is (B Hq, query
//     tiles) with the tiles reversed, so every head's heaviest tile (the
//     last: causal rows see the most keys) is issued before any lighter
//     one.  The plan (kernels/flash_attention/kernel.py) computes this
//     geometry in Python and passes it here, where it is checked.
//     Why not larger blocks: with one warp a 16-row group over whole
//     64-key tiles, causal S 512 took as long as the full mask, bound by
//     its heaviest blocks; 8-warp blocks fit one block an SM; and sharing
//     each K/V tile across the g = 3 query heads of a kv head did not
//     shorten the kernel at these shapes (PERF.md, findings on K5).
// A block walks its live key tiles in order (the exact interval test
// below, as the Pallas predicate); a warp skips a 32-key half that none of
// its rows sees, and evaluates the mask element by element only on a half
// that straddles a mask edge or the Sk tail, from each row's visible key
// range [lo, hi].
//
// Arithmetic, as the reference's online softmax.  s = q . k with f32
// accumulation (bf16 products are exact in f32); masked entries are -1e30
// (keys at or past Sk never attend); each row's max and sum are reduced
// over the 4 lanes of a quad.  The scale rides in the exponent: p =
// 2^(s c2 - m c2) with c2 = scale * log2(e), one FFMA and ex2.approx (on
// a half with masked entries 2^((s - m) c2), which is exactly 1 where a
// row has seen only masked keys, as the reference's exp(s - m)).  m is
// each row's reference point: it moves to the row max, rescaling l and acc
// by c = 2^((m - m') c2), only once some row of the warp has grown past it
// by 2^8 (so p <= 2^8; out = acc / l does not depend on m).  l sums the
// f32 p; acc += p v; out = acc * (1 / max(l, 1e-30)), rounded once to bf16.
// The split of p.  The Pallas body rounds p to v's dtype once
// (kernel.py:100-101).  This body keeps p to ~16 bits: p_hi = bf16(p),
// p_lo = bf16(p - p_hi), and two PV products a k-step, p_hi v and p_lo v.
// |p - p_hi| <= 2^-9 p, so |p - p_hi - p_lo| <= 2^-18 p, and the output
// moves by at most 2^-18 sum(p |v|) / l <= 2^-18 max|v| (3.8e-6 max|v|)
// against p kept in f32.  The exponent's argument carries one rounding
// (2^-24 relative), as the reference's s * scale - m does, and ex2.approx
// a few ulp.  So the output stays inside the 1e-5 * max|v| the kernel is
// held to.  The split costs one more PV mma a k-step.
//
// Head widths: instances at the compiled widths DP = 16, 32, 64, 128 and
// 256; any other D from 1 to 256 runs at the next one, with the true D at
// run time: q, k and v past D read as zero and the output past D is not
// written, which is exact (zero columns add nothing to q.k or to p.v); the
// scale is the caller's.  At DP 256 the bf16 body's output accumulator
// alone is 128 registers a thread, so Q is not held in registers: each
// k-step reads its A fragment from the staged Q tile by ldmatrix, and the
// block (147,456 B of tiles) runs one an SM with up to 255 registers.
// bf16 rows whose starts are not all 16-byte aligned are staged by plain
// element loads instead of cp.async; a chunk that straddles D copies only
// its bytes inside D (cp.async zero-fills the rest).  The f32 body stages
// element by element anyway; at DP 256 its tiles take 213,760 B.
//
// f32 operands: the CUDA-core body (the tensor cores have no exact f32
// product; the f32 smoke forward is held to the CPU within 1e-4).  One
// 128-thread block per (64-row query tile, batch x query head); Q and
// each K/V tile staged in shared memory as f32 (rows padded by one
// float); a thread owns 4 query rows x 8 key columns of the score tile and
// 4 rows x D/8 output columns; p goes through a shared P tile, kept in
// f32; exp and the division as written.
//
// Tolerance held against the plain version (flash_attention_ref, the
// materialised softmax) on the card: |out - ref| <= 1e-5 * max|v| per
// element (sums in another order; for bf16, the split of p); for bf16
// operands that plus one bf16 step (the spacing of bf16 values at |ref|),
// since two f32 results that close can round to neighbouring bf16 values.
//
// prefix_causal: a row's visible keys are still one interval from key 0,
// [0, qi] past the prefix and [0, max(qi, w - 1)] inside it, so a query
// tile inside the prefix walks past its diagonal up to key w - 1: the live
// run, the per-row upper bound hi and the whole-tile test all take the
// prefix's reach (w <= 0 arrives as causal; w >= Sk is full attention).
//
// The log-sum-exp.  When the caller passes an lse buffer (the training
// forward, whose backward flash_attention_bwd.cu recomputes p from it),
// each row also writes ln sum_j exp(s_j scale) over its visible keys: the
// f32 body m + ln l (m the scaled row max), the bf16 body mm scale + ln l
// (mm the merged reference point in raw score units).  Nothing else
// changes: out is computed and rounded exactly as without it.  A row that
// sees no key is outside the contract, as for out.
//
// Left for later: wgmma with a TMA producer warp (mma.sync reaches part of
// the tensor cores' rate, and a producer warp takes the copies off the
// compute warps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

constexpr int kBK = 64;            // keys a tile (both bodies)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // (B, Hq, Sq) row log-sum-exp of the scaled, masked logits, or null
  int Sq, Sk, Hq, Hk;
  int D;     // the true head width (<= the compiled width DP)
  int wide;  // bf16: every q, k, v row starts on a 16-byte boundary
  long long qs[3], ks[3], vs[3];  // batch, sequence and head strides (elements)
  int mask, window, q_offset;
  float scale;
};

// ---------------------------------------------------------------------------
// f32 body (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;            // query rows a block
constexpr int kThreads = 128;      // 16 row groups x 8 column lanes
constexpr int kRows = kBQ / 16;    // query rows a thread
constexpr int kCols = kBK / 8;     // key columns a thread (strided by 8)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float row_max8(float x) {
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Args a) {
  constexpr int LD = D + 1;     // padded row of the Q and K tiles
  constexpr int PLD = kBK + 1;  // padded row of the P tile
  constexpr int DC = D / 8;     // output columns a thread
  const int Dt = a.D;           // columns d >= Dt read as 0 and are not written
  extern __shared__ float smem[];
  float* Qs = smem;            // (kBQ, LD)
  float* Ks = Qs + kBQ * LD;   // (kBK, LD)
  float* Vs = Ks + kBK * LD;   // (kBK, D)
  float* Ps = Vs + kBK * D;    // (kBQ, PLD)

  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tile first
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const T* qb = (const T*)a.q + b * a.qs[0] + h * a.qs[2];
  const T* kb = (const T*)a.k + b * a.ks[0] + hk * a.ks[2];
  const T* vb = (const T*)a.v + b * a.vs[0] + hk * a.vs[2];

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * LD + d] = s < a.Sq && d < Dt ? to_f(qb[s * a.qs[1] + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  const int n_kt = (a.Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_live(a.mask, a.window, q_lo, q_hi, k0, min(k0 + kBK, a.Sk) - 1)) continue;
    __syncthreads();  // Q is staged; the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool in = s < a.Sk && d < Dt;
      Ks[r * LD + d] = in ? to_f(kb[s * a.ks[1] + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[s * a.vs[1] + d]) : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qi = q_lo + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 8 * j;
        const bool live = kj < a.Sk && visible(a.mask, a.window, qi, kj);
        sc[i][j] = live ? sc[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[r * PLD + tx + 8 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum8(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * PLD + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* out = (T*)a.out;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + ty * kRows + i;
    if (s >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && tx == 0) a.lse[((long long)b * a.Hq + h) * a.Sq + s] = m[i] + logf(l[i]);
    T* row = out + (((long long)b * a.Sq + s) * a.Hq + h) * Dt;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (tx + 8 * c < Dt) store(row + tx + 8 * c, acc[i][c] / den);
  }
}

// ---------------------------------------------------------------------------
// bf16 body (tensor cores)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Stage the 16-byte chunk of bf16 row `row` that starts at column c0 into
// shared memory at dst: `valid` of its 8 columns lie inside the true D (the
// rest are zero; valid <= 0: all zero, nothing read).  `wide` rows go by
// cp.async (src-size zero-fills), others by element loads and one store.
// Only NARROW instances carry the element path and partial chunks: a
// launch whose rows are all 16-byte aligned and whose D is a multiple of
// 8 (every chunk whole or wholly past D) runs an instance without them.
// (Not NARROW: `row` already points at the chunk, c0 is unused.)
template <bool NARROW>
__device__ __forceinline__ void stage16(uint32_t dst, const __nv_bfloat16* row, int c0,
                                        int valid, bool wide) {
  if constexpr (!NARROW) {
    cp_async16(dst, row, valid > 0 ? 16 : 0);
    return;
  }
  if (wide) {
    const int bytes = valid <= 0 ? 0 : valid >= 8 ? 16 : 2 * valid;
    cp_async16(dst, bytes ? row + c0 : row, bytes);
    return;
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
  const unsigned short* p = reinterpret_cast<const unsigned short*>(row + c0);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < valid) w[e >> 1] |= (unsigned)__ldg(p + e) << (16 * (e & 1));
  st_shared16(dst, make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> bf16x2 p_hi and the bf16x2 rest p_lo = bf16(p - p_hi); the
// lower 16 bits hold x, the lower column of an mma A fragment.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// The chunk XOR of tile row r: rows are (rows, D) bf16, U = D / 8 chunks of
// 16 bytes each, and chunk c of row r is stored at chunk c ^ swz_mask(r).
// The 8 consecutive rows (from a multiple of 8) that one ldmatrix phase
// reads at one chunk then land in 8 distinct 16-byte bank groups.  With
// U < 8 a row spans U bank groups, so rows are swizzled in runs of 8 / U.
// The mask depends on r & 7 alone.
template <int D>
__device__ __forceinline__ int swz_mask(int r) {
  constexpr int U = D / 8;
  if constexpr (U >= 8) {
    return r & 7;
  } else {
    return (r / (8 / U)) & (U - 1);
  }
}

// Byte offset of chunk c of row r in a swizzled tile.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return 2 * (r * D + ((c ^ swz_mask<D>(r)) << 3));
}

// 2^x, a subnormal result flushed to 0 (a p below 2^-126 adds nothing at
// f32 to a row sum that holds a p of 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A bf16 block: kMmaBQ = 32 query rows of one (batch, query head), in
// 2 row groups of 16 rows x 2 key halves of 32 (of every 64-key tile), one
// warp each.  The two warps of a row group merge their softmax states
// through shared memory at the end.  Up to D 128: three blocks an SM
// (registers capped at 168 a thread; 72 KB of shared memory a block at
// D 128) with Q held in registers; at D 256 one block an SM, Q read from
// shared memory each k-step.
constexpr int kRG = 2;
constexpr int kMmaBQ = 16 * kRG;
constexpr int kMmaThreads = 64 * kRG;

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)2 * D * (kMmaBQ + 2 * 2 * kBK);  // Q, then two stages of K and V
}

template <int D>
__host__ __device__ constexpr int mma_min_blocks() {
  return D <= 128 ? 3 : 1;
}

template <int D, bool NARROW>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<D>()) flash_mma_kernel(const Args a) {
  constexpr int RG = kRG, BQ = kMmaBQ, THREADS = kMmaThreads;
  constexpr bool QREG = D <= 128;       // Q's A fragments held in registers
  constexpr int U = D / 8;              // 16-byte chunks a row
  constexpr int KS = D / 16;            // k-steps of the QK^T product
  constexpr int NT = D / 8;             // 8-column n-tiles of the output
  constexpr int ROWS = THREADS / U;     // tile rows one pass of a copy covers
  constexpr uint32_t ROW_B = 2 * D;     // bytes a tile row
  constexpr uint32_t STAGE_B = kBK * ROW_B;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kGrow = 8.f;          // rescale once a row max grows by 2^8
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s = smem_addr(smem_raw);     // (BQ, D)
  const uint32_t k_s = q_s + BQ * ROW_B;        // 2 stages of (kBK, D)
  const uint32_t v_s = k_s + 2 * STAGE_B;       // 2 stages of (kBK, D)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % RG, kh = warp / RG;     // row group, key half
  const int wr = rg * 16, kw = kh * 32;         // the warp's first row and first key of a tile
  // x walks (batch, query head) fastest and y the query tiles, heaviest
  // first, so every head's heaviest tile (the last: causal rows see the
  // most keys) is issued before any lighter one
  const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq;
  const int hk = h / (a.Hq / a.Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // a copy pass: thread tid moves chunk cc of rows rr, rr + ROWS, ...; the
  // chunk's columns inside the true D
  const int cc = tid % U, rr = tid / U, cvalid = a.D - cc * 8;
  const bool wide = a.wide != 0;
  const int c_in = NARROW ? 0 : cc * 8;  // a whole-chunk copy points at the chunk itself
  const __nv_bfloat16* qb = (const __nv_bfloat16*)a.q + b * a.qs[0] + h * a.qs[2] + c_in;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)a.k + b * a.ks[0] + hk * a.ks[2] + c_in;
  const __nv_bfloat16* vb = (const __nv_bfloat16*)a.v + b * a.vs[0] + hk * a.vs[2] + c_in;

  // The block's live key tiles form one run [kt_first, kt_last]: the
  // union of its rows' visible keys is one interval.
  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + BQ, a.Sq) - 1;
  const int n_kt = (a.Sk + kBK - 1) / kBK;
  int kt_first = n_kt, kt_last = -1;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (tile_live(a.mask, a.window, q_lo, q_hi, kt * kBK, min(kt * kBK + kBK, a.Sk) - 1)) {
      kt_first = min(kt_first, kt);
      kt_last = kt;
    }
  }
  // the warp's query positions; a row group wholly past Sq computes nothing
  const bool warp_rows = q0 + wr < a.Sq;
  const int wq_lo = q_lo + wr;
  const int wq_hi = a.q_offset + min(q0 + wr + 16, a.Sq) - 1;
  // the visible keys [lo, hi] of the lane's two rows, g and g + 8
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = wq_lo + (lane >> 2) + 8 * i;
    const int reach = a.mask == kPrefix && qi < a.window ? a.window - 1 : qi;  // past the diagonal
    hi[i] = a.mask == kFull ? a.Sk - 1 : min(reach, a.Sk - 1);
    lo[i] = a.mask == kSliding ? qi - a.window + 1 : a.mask == kChunked ? qi / a.window * a.window : 0;
  }
  const float c2 = a.scale * kLog2e;  // exp(x * scale) = exp2(x * c2)

  // ldmatrix lanes: every operand row a lane addresses is a multiple of 8
  // plus lane & 7, so its chunk XOR is the lane's constant.
  const int xr = swz_mask<D>(lane & 7);
  const uint32_t q_lane = q_s + (wr + (lane & 15)) * ROW_B;
  const int q_x = (lane >> 4) ^ xr;                      // Q: chunk 2 kk + lane / 16
  const uint32_t k_lane = k_s + (kw + (lane & 7) + ((lane >> 4) << 3)) * ROW_B;
  const int k_x = ((lane >> 3) & 1) ^ xr;                // K: chunk 2 kk + (lane / 8) % 2
  const uint32_t v_lane = v_s + (kw + (lane & 7) + (((lane >> 3) & 1) << 3)) * ROW_B;
  const int v_x = (lane >> 4) ^ xr;                      // V: chunk 2 np + lane / 16

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qf[QREG ? KS : 1][4];

  auto load_kv = [&](int kt, int st) {
#pragma unroll
    for (int j = 0; j < (kBK + ROWS - 1) / ROWS; ++j) {
      const int r = rr + j * ROWS, s = kt * kBK + r;
      if (r >= kBK) break;  // ROWS > kBK: D 16
      const bool in = s < a.Sk;
      const long long row = in ? s : 0;  // a valid address even when zero-filling
      const uint32_t off = st * STAGE_B + swz<D>(r, cc);
      stage16<NARROW>(k_s + off, kb + row * a.ks[1], cc * 8, in ? cvalid : 0, wide);
      stage16<NARROW>(v_s + off, vb + row * a.vs[1], cc * 8, in ? cvalid : 0, wide);
    }
  };

  if (kt_first <= kt_last) {
#pragma unroll
    for (int j = 0; j < (BQ + ROWS - 1) / ROWS; ++j) {
      const int r = rr + j * ROWS, s = q0 + r;
      const bool in = s < a.Sq;
      if (r < BQ)  // ROWS > BQ: D 16 and 32
        stage16<NARROW>(q_s + swz<D>(r, cc), qb + (long long)(in ? s : 0) * a.qs[1], cc * 8,
                in ? cvalid : 0, wide);
    }
    load_kv(kt_first, 0);
    cp_commit();
  }

  for (int kt = kt_first, st = 0; kt <= kt_last; ++kt, st ^= 1) {
    cp_wait<0>();  // this tile (and Q) has landed for this thread ...
    __syncthreads();  // ... and for every thread; and every warp is done with tile kt - 1
    if (kt < kt_last) {  // so its stage takes tile kt + 1, in flight while kt computes
      load_kv(kt + 1, st ^ 1);
      cp_commit();
    }
    if constexpr (QREG) {
      if (kt == kt_first) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(q_lane + (((2 * kk) ^ q_x) << 4), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
      }
    }
    const int k0 = kt * kBK + kw;  // the warp's 32 keys: [k0, k0 + 32)
    if (warp_rows && k0 < a.Sk &&
        tile_live(a.mask, a.window, wq_lo, wq_hi, k0, min(k0 + 32, a.Sk) - 1)) {
      // ---- S = Q K^T: 16 rows x 32 keys a warp, 4 n-tiles of 8 keys ----
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t k_st = k_lane + st * STAGE_B;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t k_kk = k_st + (((2 * kk) ^ k_x) << 4);
        uint32_t qs[4];  // this k-step's A fragment: held, or read from the Q tile
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qs[e] = qf[kk][e];
        } else {
          ldsm_x4(q_lane + (((2 * kk) ^ q_x) << 4), qs[0], qs[1], qs[2], qs[3]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {  // two n-tiles a ldmatrix.x4
          uint32_t b0, b1, b2, b3;
          ldsm_x4(k_kk + np * 16 * ROW_B, b0, b1, b2, b3);
          mma_bf16(s[2 * np], qs, b0, b1);
          mma_bf16(s[2 * np + 1], qs, b2, b3);
        }
      }
      // ---- mask; lane holds rows g, g + 8 and keys 2t, 2t + 1 of each n-tile ----
      const bool edge = k0 + 32 > a.Sk ||
                        !tile_whole(a.mask, a.window, wq_lo, wq_hi, k0, k0 + 31);
      if (edge) {
        const int kj0 = k0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = kj0 + j * 8 + (e & 1), i = e >> 1;
            s[j][e] = kj >= lo[i] && kj <= hi[i] ? s[j][e] : kNegInf;
          }
        }
      }
      // ---- online softmax over the quad that shares a row (raw scores; the
      // scale rides in the exponent) ----
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
      // m is the reference point of the row's p, l and acc; it moves up to
      // the row max (rescaling l and acc by c) only once some row of the
      // warp has grown past it by 2^kGrow, so p <= 2^kGrow
      const bool grow = (mx[0] - m[0]) * c2 > kGrow || (mx[1] - m[1]) * c2 > kGrow;
      if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float corr = ex2((m[i] - mx[i]) * c2);
          m[i] = mx[i];
          l[i] *= corr;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            o[n][2 * i] *= corr;
            o[n][2 * i + 1] *= corr;
          }
        }
      }
      float mc[2] = {m[0] * c2, m[1] * c2}, rs[2] = {0.f, 0.f};
      if (edge) {  // (s - m) c2: exactly 0 where a row has seen only masked keys
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = ex2((s[j][e] - m[e >> 1]) * c2);
      } else {  // every score is finite: one rounding, s c2 - m c2
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = ex2(fmaf(s[j][e], c2, -mc[e >> 1]));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rs[0] += s[j][0] + s[j][1];
        rs[1] += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] += rs[i];
      }
      // ---- O += P V: p's C fragments of n-tiles 2kk, 2kk + 1 are the A
      // fragment of k-step kk ----
      const uint32_t v_st = v_lane + st * STAGE_B;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {  // two output n-tiles a ldmatrix.x4.trans
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(v_st + kk * 16 * ROW_B + (((2 * np) ^ v_x) << 4), b0, b1, b2, b3);
          mma_bf16(o[2 * np], ph, b0, b1);
          mma_bf16(o[2 * np + 1], ph, b2, b3);
          mma_bf16(o[2 * np], pl, b0, b1);
          mma_bf16(o[2 * np + 1], pl, b2, b3);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the stages: they become the merge buffer

  // ---- merge the key halves: the second half's warps hand (m, l, acc) to
  // the first's through the (now idle) Q tile and K/V stages, lane-major ----
  float* xch = reinterpret_cast<float*>(smem_raw) + rg * (4 * NT + 4) * 32 + lane;
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 * n + e) * 32] = o[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xch[(4 * NT + i) * 32] = m[i];
      xch[(4 * NT + 2 + i) * 32] = l[i];
    }
  }
  __syncthreads();
  if (kh == 1 || !warp_rows) return;
  float c0[2], c1[2], ref[2];  // ref: the merged rows' reference point mm
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = xch[(4 * NT + i) * 32], l1 = xch[(4 * NT + 2 + i) * 32];
    const float mm = fmaxf(m[i], m1);
    c0[i] = ex2((m[i] - mm) * c2);
    c1[i] = ex2((m1 - mm) * c2);
    l[i] = l[i] * c0[i] + l1 * c1[i];
    ref[i] = mm;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] * c0[e >> 1] + xch[(4 * n + e) * 32] * c1[e >> 1];

  // out is (B, Sq, Hq, D) at the true D: column pairs as one 4-byte store
  // where D is even, else one by one; columns past D dropped
  __nv_bfloat16* out = (__nv_bfloat16*)a.out;
  const int Dt = a.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + wr + (lane >> 2) + 8 * i;
    if (s >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    // l sums exp((s - mm) scale) over the row, so its log-sum-exp is
    // mm scale + ln l; the quad's four lanes hold the same l, one writes
    if (a.lse != nullptr && (lane & 3) == 0)
      a.lse[((long long)b * a.Hq + h) * a.Sq + s] = ref[i] * a.scale + logf(l[i]);
    __nv_bfloat16* row = out + (((long long)b * a.Sq + s) * a.Hq + h) * Dt;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * (lane & 3);
      const __nv_bfloat162 pr = __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      if constexpr (!NARROW) {  // D % 8 == 0: a pair lies wholly inside D or past it
        if (col < Dt) *reinterpret_cast<__nv_bfloat162*>(row + col) = pr;
      } else if (col + 1 < Dt && !(Dt & 1)) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) = pr;
      } else {
        if (col < Dt) row[col] = pr.x;
        if (col + 1 < Dt) row[col + 1] = pr.y;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int launch_kernel(K kern, dim3 grid, int threads, int smem, const Args& a, cudaStream_t st) {
  // dynamic shared memory above 48 KB must be opted into per kernel
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kern<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Args& a, int B, int dtype, int bq, int smem, cudaStream_t st) {
  if (dtype == 0) {  // the plan must be the f32 body's fixed geometry
    if (bq != kBQ || smem != (int)(smem_floats<D>() * sizeof(float)))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.Hq);
    return launch_kernel(flash_kernel<float, D>, grid, kThreads, smem, a, st);
  }
  if (bq != kMmaBQ || smem != (int)mma_smem_bytes<D>())
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * a.Hq, (a.Sq + kMmaBQ - 1) / kMmaBQ);
  // unaligned rows or a D that leaves a partial chunk: the narrow instance
  return a.wide && a.D % 8 == 0
             ? launch_kernel(flash_mma_kernel<D, false>, grid, kMmaThreads, smem, a, st)
             : launch_kernel(flash_mma_kernel<D, true>, grid, kMmaThreads, smem, a, st);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16; mask: 0 full, 1 causal, 2 sliding, 3 chunked,
// 4 prefix_causal (window = the prefix length).  lse: null, or a (B, Hq, Sq)
// f32 buffer that takes each row's natural-log log-sum-exp of its scaled,
// masked logits (the backward's input); out is the same either way.
// D is the true head width, DP the compiled width it runs at (16, 32, 64,
// 128 or 256).  Strides are in elements; D must be unit stride; wide: every
// bf16 row starts on a 16-byte boundary (else rows are staged element by
// element).  bq / smem: the launch plan (query rows a block, dynamic
// shared memory bytes), checked against this file's geometry.  Returns
// cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, void* lse,
                           int B,
                           int Sq, int Sk, int Hq, int Hk, int D, int DP, int wide,
                           long long qsb,
                           long long qss, long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss, long long vsh,
                           int dtype, int mask, int window, int q_offset, float scale,
                           int bq, int smem, void* stream) {
  if (((mask == kSliding || mask == kChunked || mask == kPrefix) && window <= 0) || mask < kFull ||
      mask > kPrefix || D < 1 || D > DP)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = (float*)lse;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hk = Hk;
  a.D = D;
  a.wide = wide;
  a.qs[0] = qsb; a.qs[1] = qss; a.qs[2] = qsh;
  a.ks[0] = ksb; a.ks[1] = kss; a.ks[2] = ksh;
  a.vs[0] = vsb; a.vs[1] = vss; a.vs[2] = vsh;
  a.mask = mask;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  switch (DP) {
    case 16: return launch_d<16>(a, B, dtype, bq, smem, st);
    case 32: return launch_d<32>(a, B, dtype, bq, smem, st);
    case 64: return launch_d<64>(a, B, dtype, bq, smem, st);
    case 128: return launch_d<128>(a, B, dtype, bq, smem, st);
    case 256: return launch_d<256>(a, B, dtype, bq, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
