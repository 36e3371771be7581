// The gradient of the flash-attention forward (flash_attention.cu): dq, dk
// and dv from q, k, v, the forward's out and row log-sum-exp, and dout.
//
// Replaces: no Pallas kernel.  The reference trains through its jnp
// blocked_attend (src/repro/core/attention.py:97), an online-softmax scan
// that XLA differentiates; the port's blocked_attend launches the forward
// kernel instead, so it owes that kernel a backward.  This file computes
// the gradient of the function the forward computes, for every mask kind
// it takes (full, causal, sliding, chunked, prefix_causal), GQA of any
// group, f32 and bf16 operands, every head width up to 256 (compiled widths
// 16, 32, 64, 128 and 256, as the forward; a narrower D runs at the next
// one with the columns past it read as zero and not written) and Sq != Sk.
//
// Arithmetic.  With s = scale q.k and P = exp(s - lse) on the visible
// pairs (0 elsewhere; lse the forward's row log-sum-exp), the gradient is
//   delta_i = sum_d dout_id o_id                (one f32 sum a query row)
//   dv_j   += sum_i P_ij dout_i
//   dS_ij   = P_ij (dout_i . v_j - delta_i)
//   dk_j   += scale sum_i dS_ij q_i
//   dq_i    = scale sum_j dS_ij k_j
// summed over the query heads of each kv head's group for dk and dv, in
// f32, and rounded once to the operands' dtype.
//
// Three launches on the stream, one C call: delta (a warp a query row),
// then a dk / dv pass and a dq pass.  Each output element is written by
// one block, and every sum runs in a fixed order: no atomics, so two
// launches on the same inputs give identical bits.
//
// bf16 operands: a FlashAttention-2-style body on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate), 128-thread blocks of four
// warps.  A warp owns 16 rows (keys in the dk / dv pass, queries in the dq
// pass); at the compiled width 256 two warps share each 16 rows, one half
// of the output columns each, so a tile is T = 64 rows up to D 128 and 32
// at D 256.
//   * dk / dv pass, a block per (batch x kv head, key tile of T), issued
//     key tile 0 first (under a causal mask it sees the most queries).  K
//     and V stay in shared memory.  The block walks the group's query
//     heads in order and, for each, the run of query tiles the mask lets
//     see its keys (the exact tile test of flash_attention.cuh); Q, dout,
//     lse and delta of each tile are copied with cp.async into two stages,
//     the next tile in flight while this one computes.  For every 16-query
//     chunk a warp forms S^T = K Q^T and dP^T = V dout^T (K and V as A
//     fragments by ldmatrix, Q and dout as B fragments by ldmatrix), then
//     P^T = 2^(s c2 - lse log2 e) and dS^T = P^T (dP^T - delta) in f32 in
//     the accumulator fragments.  The m16n8 accumulators of two adjacent
//     8-query n-tiles are, pair by pair, the m16n8k16 A fragment of the
//     next product, so P and dS never leave registers: dv += P^T dout and
//     dk += dS^T Q, dout and Q as B fragments by ldmatrix.trans.
//   * dq pass, a block per (batch x query head, query tile of T), the last
//     tile (the heaviest under a causal mask) first.  Q and dout stay in
//     shared memory (up to D 128 their A fragments are held in registers),
//     lse and delta in registers; the run of live key tiles streams
//     through two cp.async stages.  S = Q K^T and dP = dout V^T as above,
//     dS formed in the fragments, dq += dS K with K by ldmatrix.trans.
//   * The split of P and dS.  A single bf16 rounding (2^-9 relative) of
//     each would move a gradient element that sums many cancelling terms
//     by ~1e-3 of its typical size, outside the 1e-5 * max|grad| the
//     kernel is held to.  Each is split as the forward splits p: hi =
//     bf16(x), lo = bf16(x - hi), |x - hi - lo| <= 2^-17 |x|, and both
//     halves go through the product (two mma a k-step).  In the dk / dv
//     pass the two go into a zeroed fragment and the chunk's sum is added
//     to dk / dv by f32 adds: the mma accumulator's own additions, over
//     the g S / 16 chunks of a key tile, drifted past 1e-5 max|dk| at g 5
//     and 6 (llama4-scout's and mixtral's heads; g 3 stayed inside).
//   * Tiles are bf16, rows of D, each row's 16-byte chunks XOR-swizzled by
//     the row as the forward's (swz), so the 8 rows one ldmatrix phase
//     reads hit 8 bank groups.  Shared memory a block: 12 T D bytes (dk / dv
//     adds 16 T of lse and delta): 99,328 and 98,304 B at D 128, 98,816
//     and 98,304 at D 256, so two blocks share an SM.  Rows that do not all
//     start on a 16-byte boundary are staged by element loads, a chunk that
//     straddles D copies only its bytes inside D.
//   * The exponent: p = ex2(fma(s, scale log2 e, -lse log2 e)), one
//     rounding of the argument as the plain version's s scale - lse, and
//     ex2.approx's few ulp.
//   * Work: per visible (query, key) pair 2 D operations for each of S and
//     dP in both passes and 4 D for each of the split dv, dk and dq
//     products, 20 D in all (28 D at D 256, where both warps of a row
//     pair form S and dP), against the 10 D of the bound below.
//
// f32 operands: the CUDA-core body, as the tensor cores have no exact f32
// product.  256-thread blocks over tiles of 64 rows (32 at D 256), f32
// tiles in shared memory padded by one float a row; a thread owns R x T/16
// (key, query) entries of S^T and dP^T and R x D/16 (key, column)
// accumulators of dk and dv (dq: the same by query); P and dS go through
// shared memory in f32.  S and dP are formed in both passes.
//
// What bounds it on the H100.  At phi4-mini's training shape (B 1, S 4096,
// Hq 24, Hk 8, D 128, causal, bf16) it must read q, k, v, o and dout once
// and write dq, dk and dv once: 4096 * 128 * 2 B a head, over 24 + 8 + 8 +
// 24 + 24 heads read and 24 + 8 + 8 written, 134.2 MB, 0.040 ms at 3.35
// TB/s (lse adds 0.4 MB); its operations are 10 D per visible (query,
// key) pair (the five products QK^T, dout V^T, P^T dout, dS^T Q and dS K,
// two operations a multiply-add): 10 * 128 * 201.4 M pairs = 257.8 GFLOP,
// 0.26 ms at the bf16 tensor cores' 989 TFLOP/s.  So it is bound by
// operations.  The bf16 body does twice those operations (the split, and S
// and dP formed in both passes) with mma.sync, which reaches a part of the
// tensor cores' rate, and reads every B operand (256 bytes a 16 x 8 x 16
// product) and the dk / dv pass's A operands of S and dP from shared memory
// by ldmatrix.  On an H100 SXM at 700 W the dk / dv and dq launches take
// ~1.4 and ~1.2 ms at this shape, ~220 and ~180 TFLOP/s of issued
// products; forming S and dP 32 rows a pass (twice the independent
// accumulators, half the A-fragment loads of the dk / dv pass) did not
// shorten either, so the rate of the products themselves bounds it.  Left
// for later: dq folded into the dk / dv pass with an ordered reduction
// over key tiles (S and dP formed once), then wgmma with a TMA producer
// warp.
//
// A query row that sees no key is outside the contract, as in the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// delta and the f32 body (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kLanes = 16;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq)
  float* delta;      // (B, Hq, Sq) workspace
  void* dq;          // (B, Sq, Hq, D) contiguous
  void* dk;          // (B, Sk, Hk, D) contiguous
  void* dv;          // (B, Sk, Hk, D) contiguous
  int B, Sq, Sk, Hq, Hk;
  int D;     // the true head width (<= the compiled width DP)
  int wide;  // bf16: every q, k, v and dout row starts on a 16-byte boundary
  long long qs[3], ks[3], vs[3], os[3], ds[3];  // batch, sequence, head strides (elements)
  int mask, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Tile rows a block: 64, or 32 at the compiled width 256.
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D > 128 ? 32 : 64;
}

// Shared memory of the dk/dv block: K, V, Q, dout (T x (D + 1) each), P and
// dS (T x (T + 1) each), lse and delta (T each), f32.
template <int D>
__host__ __device__ constexpr int kv_smem_bytes() {
  return 4 * (4 * tile_rows<D>() * (D + 1) + 2 * tile_rows<D>() * (tile_rows<D>() + 1) +
              2 * tile_rows<D>());
}

// Shared memory of the dq block: Q, dout, K, V (T x (D + 1) each), dS
// (T x (T + 1)), lse and delta (T each), f32.
template <int D>
__host__ __device__ constexpr int q_smem_bytes() {
  return 4 * (4 * tile_rows<D>() * (D + 1) + tile_rows<D>() * (tile_rows<D>() + 1) +
              2 * tile_rows<D>());
}

// Stage `rows` rows of a (.., seq, .., D) operand from sequence index row0
// into a (rows, D + 1) f32 tile: rows at or past n and columns at or past
// the true D read as zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* base, long long seq_stride, int row0,
                                      int rows, int n, int Dt) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D, s = row0 + r;
    dst[r * (D + 1) + d] = s < n && d < Dt ? to_f(base[(long long)s * seq_stride + d]) : 0.f;
  }
}

// delta = rowsum(dout * o) in f32, a warp a (batch, head, query) row.
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const BwdArgs a) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Hq * a.Sq) return;
  const int s = (int)(row % a.Sq);
  const int h = (int)((row / a.Sq) % a.Hq);
  const int b = (int)(row / ((long long)a.Sq * a.Hq));
  const T* o = (const T*)a.o + b * a.os[0] + (long long)s * a.os[1] + h * a.os[2];
  const T* d = (const T*)a.dout + b * a.ds[0] + (long long)s * a.ds[1] + h * a.ds[2];
  float acc = 0.f;
  for (int c = lane; c < a.D; c += 32) acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// dk and dv of one key tile of one (batch, kv head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const BwdArgs a) {
  constexpr int TR = tile_rows<D>();
  constexpr int LD = D + 1, PLD = TR + 1;
  constexpr int R = TR / 16;        // key rows a thread
  constexpr int QC = TR / kLanes;   // query columns a thread (strided by 16)
  constexpr int DC = D / kLanes;  // head columns a thread (strided by 16)
  extern __shared__ float smem[];
  float* Ks = smem;              // (TR, LD)
  float* Vs = Ks + TR * LD;      // (TR, LD)
  float* Qs = Vs + TR * LD;      // (TR, LD)
  float* Os = Qs + TR * LD;      // dout (TR, LD)
  float* Ps = Os + TR * LD;      // P^T (TR keys, PLD)
  float* Ss = Ps + TR * PLD;     // dS^T (TR keys, PLD)
  float* Ls = Ss + TR * PLD;     // lse (TR)
  float* Es = Ls + TR;           // delta (TR)

  const int b = blockIdx.y / a.Hk, hk = blockIdx.y % a.Hk;
  const int g = a.Hq / a.Hk;
  const int k0 = blockIdx.x * TR;  // causal: the first key tiles see the most queries
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int Dt = a.D;

  stage<T, D>(Ks, (const T*)a.k + b * a.ks[0] + hk * a.ks[2], a.ks[1], k0, TR, a.Sk, Dt);
  stage<T, D>(Vs, (const T*)a.v + b * a.vs[0] + hk * a.vs[2], a.vs[1], k0, TR, a.Sk, Dt);

  float dk[R][DC], dv[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int k_hi = min(k0 + TR, a.Sk) - 1;
  const int n_qt = (a.Sq + TR - 1) / TR;
  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    const T* qb = (const T*)a.q + b * a.qs[0] + h * a.qs[2];
    const T* db = (const T*)a.dout + b * a.ds[0] + h * a.ds[2];
    const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * TR;
      const int q_lo = a.q_offset + q0, q_hi = a.q_offset + min(q0 + TR, a.Sq) - 1;
      if (!tile_live(a.mask, a.window, q_lo, q_hi, k0, k_hi)) continue;
      __syncthreads();  // the previous tile's readers are done (and K, V are staged)
      stage<T, D>(Qs, qb, a.qs[1], q0, TR, a.Sq, Dt);
      stage<T, D>(Os, db, a.ds[1], q0, TR, a.Sq, Dt);
      for (int i = threadIdx.x; i < TR; i += kThreads) {
        const bool in = q0 + i < a.Sq;
        Ls[i] = in ? a.lse[lrow + q0 + i] : 0.f;
        Es[i] = in ? a.delta[lrow + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dout^T: thread rows ty R + i, columns tx + 16 j
      float st[R][QC], dp[R][QC];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < QC; ++j) st[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[R], vv[R], qv[QC], ov[QC];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = Ks[(ty * R + i) * LD + d];
          vv[i] = Vs[(ty * R + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          qv[j] = Qs[(tx + kLanes * j) * LD + d];
          ov[j] = Os[(tx + kLanes * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < QC; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kj = k0 + ty * R + i;
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          const int c = tx + kLanes * j, qr = q0 + c;
          const bool live = kj < a.Sk && qr < a.Sq && visible(a.mask, a.window, a.q_offset + qr, kj);
          const float p = live ? expf(st[i][j] * a.scale - Ls[c]) : 0.f;
          Ps[(ty * R + i) * PLD + c] = p;
          Ss[(ty * R + i) * PLD + c] = p * (dp[i][j] - Es[c]);
        }
      }
      __syncthreads();

      // dv += P^T dout, dk += dS^T Q: thread rows ty R + i, columns tx + 16 c
      for (int qq = 0; qq < TR; ++qq) {
        float pv[R], sv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Ps[(ty * R + i) * PLD + qq];
          sv[i] = Ss[(ty * R + i) * PLD + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = tx + kLanes * c;
          const float ov = Os[qq * LD + d], qv = Qs[qq * LD + d];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
            dk[i][c] = fmaf(sv[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  T* dkp = (T*)a.dk;
  T* dvp = (T*)a.dv;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty * R + i;
    if (kj >= a.Sk) continue;
    const long long row = (((long long)b * a.Sk + kj) * a.Hk + hk) * Dt;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + kLanes * c;
      if (d < Dt) {
        store(dkp + row + d, dk[i][c] * a.scale);
        store(dvp + row + d, dv[i][c]);
      }
    }
  }
}

// dq of one query tile of one (batch, query head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdArgs a) {
  constexpr int TR = tile_rows<D>();
  constexpr int LD = D + 1, PLD = TR + 1;
  constexpr int R = TR / 16;        // query rows a thread
  constexpr int KC = TR / kLanes;   // key columns a thread (strided by 16)
  constexpr int DC = D / kLanes;
  extern __shared__ float smem[];
  float* Qs = smem;              // (TR, LD)
  float* Os = Qs + TR * LD;      // dout (TR, LD)
  float* Ks = Os + TR * LD;      // (TR, LD)
  float* Vs = Ks + TR * LD;      // (TR, LD)
  float* Ss = Vs + TR * LD;      // dS (TR queries, PLD)
  float* Ls = Ss + TR * PLD;     // lse (TR)
  float* Es = Ls + TR;           // delta (TR)

  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TR;  // heaviest tile first
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int Dt = a.D;
  const long long lrow = ((long long)b * a.Hq + h) * a.Sq;

  stage<T, D>(Qs, (const T*)a.q + b * a.qs[0] + h * a.qs[2], a.qs[1], q0, TR, a.Sq, Dt);
  stage<T, D>(Os, (const T*)a.dout + b * a.ds[0] + h * a.ds[2], a.ds[1], q0, TR, a.Sq, Dt);
  for (int i = threadIdx.x; i < TR; i += kThreads) {
    const bool in = q0 + i < a.Sq;
    Ls[i] = in ? a.lse[lrow + q0 + i] : 0.f;
    Es[i] = in ? a.delta[lrow + q0 + i] : 0.f;
  }
  const T* kb = (const T*)a.k + b * a.ks[0] + hk * a.ks[2];
  const T* vb = (const T*)a.v + b * a.vs[0] + hk * a.vs[2];

  float dq[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  const int q_lo = a.q_offset + q0, q_hi = a.q_offset + min(q0 + TR, a.Sq) - 1;
  const int n_kt = (a.Sk + TR - 1) / TR;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TR;
    if (!tile_live(a.mask, a.window, q_lo, q_hi, k0, min(k0 + TR, a.Sk) - 1)) continue;
    __syncthreads();  // the previous tile's readers are done (and Q, dout are staged)
    stage<T, D>(Ks, kb, a.ks[1], k0, TR, a.Sk, Dt);
    stage<T, D>(Vs, vb, a.vs[1], k0, TR, a.Sk, Dt);
    __syncthreads();

    // S = Q K^T and dP = dout V^T: thread rows ty R + i, key columns tx + 16 j
    float st[R][KC], dp[R][KC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) st[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[R], ov[R], kv[KC], vv[KC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(ty * R + i) * LD + d];
        ov[i] = Os[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        kv[j] = Ks[(tx + kLanes * j) * LD + d];
        vv[j] = Vs[(tx + kLanes * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          st[i][j] = fmaf(qv[i], kv[j], st[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i, qr = q0 + r;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kj = k0 + tx + kLanes * j;
        const bool live = kj < a.Sk && qr < a.Sq && visible(a.mask, a.window, a.q_offset + qr, kj);
        const float p = live ? expf(st[i][j] * a.scale - Ls[r]) : 0.f;
        Ss[r * PLD + tx + kLanes * j] = p * (dp[i][j] - Es[r]);
      }
    }
    __syncthreads();

    // dq += dS K
    for (int kk = 0; kk < TR; ++kk) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = Ss[(ty * R + i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + kLanes * c;
        const float kv = Ks[kk * LD + d];
#pragma unroll
        for (int i = 0; i < R; ++i) dq[i][c] = fmaf(sv[i], kv, dq[i][c]);
      }
    }
  }

  T* dqp = (T*)a.dq;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qr = q0 + ty * R + i;
    if (qr >= a.Sq) continue;
    const long long row = (((long long)b * a.Sq + qr) * a.Hq + h) * Dt;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + kLanes * c;
      if (d < Dt) store(dqp + row + d, dq[i][c] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 body (tensor cores)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps
constexpr float kLog2e = 1.4426950408889634f;

// Warps that share a 16-row group, one slice of the output columns each:
// 2 at the compiled width 256 (dk and dv of 16 rows x 256 columns would be
// 256 f32 accumulators a thread), else 1.
template <int D>
__host__ __device__ constexpr int mma_slices() {
  return D > 128 ? 2 : 1;
}

// Rows a tile, both passes: 16 a row group, 4 / slices row groups.
template <int D>
__host__ __device__ constexpr int mma_tile() {
  return 16 * (4 / mma_slices<D>());
}

// dk / dv block: K and V, two stages of Q and dout (bf16, T x D each), two
// stages of lse and delta (f32, T each).
template <int D>
constexpr int mma_kv_smem_bytes() {
  return 12 * mma_tile<D>() * D + 16 * mma_tile<D>();
}

// dq block: Q and dout, two stages of K and V (bf16, T x D each).
template <int D>
constexpr int mma_q_smem_bytes() {
  return 12 * mma_tile<D>() * D;
}

// 4-byte asynchronous copy (f32 lse and delta rows start anywhere);
// src_bytes 0 writes zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Columns col, col + 1 of a bf16 output row at the true width Dt: one
// 4-byte store where Dt is even, else one by one; columns past Dt dropped.
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col, int Dt, float x,
                                           float y) {
  if (col + 1 < Dt && !(Dt & 1)) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
  } else {
    if (col < Dt) row[col] = __float2bfloat16(x);
    if (col + 1 < Dt) row[col + 1] = __float2bfloat16(y);
  }
}

// The m16n8k16 A fragment of x's 16 columns held as two m16n8 accumulator
// n-tiles (x[0] columns 0-7, x[1] columns 8-15), split into bf16 hi and lo.
__device__ __forceinline__ void split_a(const float (&x)[2][4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_bf16x2(x[0][0], x[0][1], hi[0], lo[0]);
  split_bf16x2(x[0][2], x[0][3], hi[1], lo[1]);
  split_bf16x2(x[1][0], x[1][1], hi[2], lo[2]);
  split_bf16x2(x[1][2], x[1][3], hi[3], lo[3]);
}

// Stage `T` rows of a (.., seq, .., D) bf16 operand from sequence index
// row0 into a swizzled tile at dst: rows at or past n read as zero.  Thread
// tid moves chunk tid % U of rows tid / U, tid / U + ROWS, ...
template <int D, int T>
__device__ __forceinline__ void stage_rows(uint32_t dst, const __nv_bfloat16* base,
                                           long long seq_stride, int row0, int n, int Dt,
                                           bool wide) {
  constexpr int U = D / 8, ROWS = kMmaThreads / U;
  const int cc = threadIdx.x % U, rr = threadIdx.x / U, valid = Dt - cc * 8;
#pragma unroll
  for (int j = 0; j < (T + ROWS - 1) / ROWS; ++j) {
    const int r = rr + j * ROWS, s = row0 + r;
    if (r >= T) break;  // ROWS > T: D 16
    const bool in = s < n;
    stage16<true>(dst + swz<D>(r, cc), base + (long long)(in ? s : 0) * seq_stride, cc * 8,
                  in ? valid : 0, wide);
  }
}

// ldmatrix lane offsets into a swizzled (rows, D) tile: every row a lane
// addresses is a multiple of 8 plus lane & 7, so its chunk XOR is the
// lane's constant xr.
struct Lanes {
  uint32_t a_row, bn_row, bt_row;  // byte offsets of the lane's row
  int a_x, bn_x, bt_x;             // chunk XORs
};

template <int D>
__device__ __forceinline__ Lanes lanes(int lane) {
  constexpr uint32_t ROW_B = 2 * D;
  const int xr = swz_mask<D>(lane & 7);
  Lanes l;
  // A (16 rows x 16 columns): row lane % 16, chunk 2 kk + lane / 16
  l.a_row = (lane & 15) * ROW_B;
  l.a_x = (lane >> 4) ^ xr;
  // B from rows that are its n index (two 8-row n-tiles x 16 columns):
  // row lane % 8 + 8 (lane / 16), chunk 2 kk + (lane / 8) % 2
  l.bn_row = ((lane & 7) + ((lane >> 4) << 3)) * ROW_B;
  l.bn_x = ((lane >> 3) & 1) ^ xr;
  // B from rows that are its k index (16 rows x two 8-column n-tiles), by
  // ldmatrix.trans: row lane % 8 + 8 ((lane / 8) % 2), chunk 2 np + lane / 16
  l.bt_row = ((lane & 7) + (((lane >> 3) & 1) << 3)) * ROW_B;
  l.bt_x = (lane >> 4) ^ xr;
  return l;
}

// acc += hi B + lo B: one 16-query chunk's split product formed in a zeroed
// fragment, then added to the running sum by f32 adds (round to nearest).
__device__ __forceinline__ void chunk_add(float (&acc)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, hi, b0, b1);
  mma_bf16(t, lo, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// dk and dv of one key tile of one (batch, kv head).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2) dkdv_mma_kernel(const BwdArgs a) {
  constexpr int CS = mma_slices<D>(), T = mma_tile<D>();
  constexpr int KS = D / 16;       // k-steps of S^T and dP^T
  constexpr int NO = D / CS / 8;   // output n-tiles a warp, of dk and of dv
  constexpr uint32_t ROW_B = 2 * D, TILE_B = T * ROW_B;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t k_s = smem_addr(smem_raw);  // (T, D)
  const uint32_t v_s = k_s + TILE_B;         // (T, D)
  const uint32_t q_s = v_s + TILE_B;         // 2 stages of (T, D)
  const uint32_t o_s = q_s + 2 * TILE_B;     // dout, 2 stages of (T, D)
  const uint32_t l_s = o_s + 2 * TILE_B;     // lse, 2 stages of T f32
  const uint32_t e_s = l_s + 8 * T;          // delta, 2 stages of T f32
  const float* ls = reinterpret_cast<const float*>(smem_raw + 6 * TILE_B);
  const float* es = ls + 2 * T;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / CS, cs = warp % CS;  // row group, column slice
  const int b = blockIdx.x / a.Hk, hk = blockIdx.x % a.Hk;
  const int g = a.Hq / a.Hk;
  const int k0 = blockIdx.y * T;
  const int Dt = a.D;
  const bool wide = a.wide != 0;

  // The query tiles that see a key of this tile form one run [qt_first,
  // qt_last]: the union of the keys' visible queries is one interval.
  const int k_hi = min(k0 + T, a.Sk) - 1;
  const int n_qt = (a.Sq + T - 1) / T;
  int qt_first = n_qt, qt_last = -1;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q_lo = a.q_offset + qt * T, q_hi = a.q_offset + min(qt * T + T, a.Sq) - 1;
    if (tile_live(a.mask, a.window, q_lo, q_hi, k0, k_hi)) {
      qt_first = min(qt_first, qt);
      qt_last = qt;
    }
  }
  const int n_live = qt_last - qt_first + 1;
  const int n_it = n_live > 0 ? g * n_live : 0;  // (query head of the group, live tile)

  // Q, dout, lse and delta of iteration it into stage st
  auto load_q = [&](int it, int st) {
    const int h = hk * g + it / n_live, q0 = (qt_first + it % n_live) * T;
    stage_rows<D, T>(q_s + st * TILE_B, (const __nv_bfloat16*)a.q + b * a.qs[0] + h * a.qs[2],
                     a.qs[1], q0, a.Sq, Dt, wide);
    stage_rows<D, T>(o_s + st * TILE_B,
                     (const __nv_bfloat16*)a.dout + b * a.ds[0] + h * a.ds[2], a.ds[1], q0,
                     a.Sq, Dt, wide);
    if (tid < 2 * T) {  // one f32 a thread: lse rows, then delta rows
      const int r = tid % T, s = q0 + r;
      const long long at = ((long long)b * a.Hq + h) * a.Sq + (s < a.Sq ? s : 0);
      cp_async4((tid < T ? l_s : e_s) + 4 * (st * T + r), (tid < T ? a.lse : a.delta) + at,
                s < a.Sq ? 4 : 0);
    }
  };

  if (n_it > 0) {
    stage_rows<D, T>(k_s, (const __nv_bfloat16*)a.k + b * a.ks[0] + hk * a.ks[2], a.ks[1], k0,
                     a.Sk, Dt, wide);
    stage_rows<D, T>(v_s, (const __nv_bfloat16*)a.v + b * a.vs[0] + hk * a.vs[2], a.vs[1], k0,
                     a.Sk, Dt, wide);
    load_q(0, 0);
    cp_commit();
  }

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const Lanes ln = lanes<D>(lane);
  const uint32_t k_a = k_s + 16 * rg * ROW_B + ln.a_row, v_a = v_s + 16 * rg * ROW_B + ln.a_row;
  const float c2 = a.scale * kLog2e;  // exp(s scale) = 2^(s c2)
  const int kw = k0 + 16 * rg;        // the warp's first key
  const int kw_hi = min(kw + 16, a.Sk) - 1;
  const int kj[2] = {kw + (lane >> 2), kw + (lane >> 2) + 8};  // the lane's keys (rows g, g + 8)

  for (int it = 0, st = 0; it < n_it; ++it, st ^= 1) {
    cp_wait<0>();     // this tile (and K, V) has landed for this thread ...
    __syncthreads();  // ... and for every thread; and every warp is done with tile it - 1
    if (it + 1 < n_it) {  // so its stage takes tile it + 1, in flight while it computes
      load_q(it + 1, st ^ 1);
      cp_commit();
    }
    if (kw >= a.Sk) continue;  // the warp's rows are all past Sk
    const int q0 = (qt_first + it % n_live) * T;
    const uint32_t q_st = q_s + st * TILE_B, o_st = o_s + st * TILE_B;
    const float* l_st = ls + st * T;
    const float* e_st = es + st * T;
#pragma unroll 1
    for (int c = 0; c < T / 16; ++c) {  // 16-query chunks
      const int qc = q0 + 16 * c;
      if (qc >= a.Sq) break;
      const int q_lo = a.q_offset + qc, q_hi = a.q_offset + min(qc + 16, a.Sq) - 1;
      if (!tile_live(a.mask, a.window, q_lo, q_hi, kw, kw_hi)) continue;

      // ---- S^T = K Q^T, dP^T = V dout^T: 16 keys x 2 n-tiles of 8 queries ----
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const uint32_t q_b = q_st + 16 * c * ROW_B + ln.bn_row;
      const uint32_t o_b = o_st + 16 * c * ROW_B + ln.bn_row;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4], b0, b1, b2, b3;
        ldsm_x4(k_a + (((2 * kk) ^ ln.a_x) << 4), ka[0], ka[1], ka[2], ka[3]);
        ldsm_x4(q_b + (((2 * kk) ^ ln.bn_x) << 4), b0, b1, b2, b3);
        mma_bf16(s[0], ka, b0, b1);
        mma_bf16(s[1], ka, b2, b3);
        ldsm_x4(v_a + (((2 * kk) ^ ln.a_x) << 4), va[0], va[1], va[2], va[3]);
        ldsm_x4(o_b + (((2 * kk) ^ ln.bn_x) << 4), b0, b1, b2, b3);
        mma_bf16(dp[0], va, b0, b1);
        mma_bf16(dp[1], va, b2, b3);
      }

      // ---- P^T and dS^T in the fragments: lane holds keys kj[e / 2] and
      // queries qc + 8 j + 2 (lane % 4) + e % 2 ----
      const bool whole = qc + 16 <= a.Sq && kw + 16 <= a.Sk &&
                         tile_whole(a.mask, a.window, q_lo, q_hi, kw, kw_hi);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 16 * c + 8 * j + 2 * (lane & 3);  // the tile row of e % 2 = 0
        const float2 l2 = *reinterpret_cast<const float2*>(l_st + r);
        const float2 d2 = *reinterpret_cast<const float2*>(e_st + r);
        const float lq[2] = {l2.x * kLog2e, l2.y * kLog2e}, dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e & 1;
          float p = ex2(fmaf(s[j][e], c2, -lq[x]));
          if (!whole) {
            const int qr = qc + 8 * j + 2 * (lane & 3) + x, key = kj[e >> 1];
            p = key < a.Sk && qr < a.Sq && visible(a.mask, a.window, a.q_offset + qr, key)
                    ? p
                    : 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl[x]);
        }
      }

      // ---- dv += P^T dout, dk += dS^T Q: the split fragments are the A
      // operand of one 16-query k-step; dout and Q by ldmatrix.trans.  The
      // chunk's hi and lo products are formed in a zeroed fragment and
      // added to dk / dv in f32 (chunk_add): accumulated in the mma's own
      // accumulator over a group's g S / 16 chunks, dk drifted past the
      // 1e-5 max|dk| bound at g 5 and 6 (S 4096 and 8448) ----
      uint32_t hi[4], lo[4];
      split_a(s, hi, lo);
      const uint32_t o_t = o_st + 16 * c * ROW_B + ln.bt_row;
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {  // two output n-tiles a ldmatrix.x4.trans
        const int ch = 2 * (cs * (NO / 2) + np);
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(o_t + ((ch ^ ln.bt_x) << 4), b0, b1, b2, b3);
        chunk_add(dv[2 * np], hi, lo, b0, b1);
        chunk_add(dv[2 * np + 1], hi, lo, b2, b3);
      }
      split_a(dp, hi, lo);
      const uint32_t q_t = q_st + 16 * c * ROW_B + ln.bt_row;
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        const int ch = 2 * (cs * (NO / 2) + np);
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(q_t + ((ch ^ ln.bt_x) << 4), b0, b1, b2, b3);
        chunk_add(dk[2 * np], hi, lo, b0, b1);
        chunk_add(dk[2 * np + 1], hi, lo, b2, b3);
      }
    }
  }

  // dk and dv are (B, Sk, Hk, D) at the true D; a block with no live query
  // tile writes zeros
  __nv_bfloat16* dkp = (__nv_bfloat16*)a.dk;
  __nv_bfloat16* dvp = (__nv_bfloat16*)a.dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kj[i] >= a.Sk) continue;
    const long long row = (((long long)b * a.Sk + kj[i]) * a.Hk + hk) * Dt;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * (cs * NO + n) + 2 * (lane & 3);
      store_pair(dkp + row, col, Dt, dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
      store_pair(dvp + row, col, Dt, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// dq of one query tile of one (batch, query head).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2) dq_mma_kernel(const BwdArgs a) {
  constexpr int CS = mma_slices<D>(), T = mma_tile<D>();
  constexpr bool QREG = CS == 1;   // Q's and dout's A fragments held in registers
  constexpr int KS = D / 16;
  constexpr int NO = D / CS / 8;   // dq n-tiles a warp
  constexpr uint32_t ROW_B = 2 * D, TILE_B = T * ROW_B;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s = smem_addr(smem_raw);  // (T, D)
  const uint32_t o_s = q_s + TILE_B;         // dout (T, D)
  const uint32_t k_s = o_s + TILE_B;         // 2 stages of (T, D)
  const uint32_t v_s = k_s + 2 * TILE_B;     // 2 stages of (T, D)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / CS, cs = warp % CS;
  // x walks (batch, query head) fastest and y the query tiles, heaviest
  // first, so every head's heaviest tile is issued before any lighter one
  const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq;
  const int hk = h / (a.Hq / a.Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;
  const int Dt = a.D;
  const bool wide = a.wide != 0;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)a.k + b * a.ks[0] + hk * a.ks[2];
  const __nv_bfloat16* vb = (const __nv_bfloat16*)a.v + b * a.vs[0] + hk * a.vs[2];

  // the block's live key tiles: one run [kt_first, kt_last]
  const int q_lo = a.q_offset + q0, q_hi = a.q_offset + min(q0 + T, a.Sq) - 1;
  const int n_kt = (a.Sk + T - 1) / T;
  int kt_first = n_kt, kt_last = -1;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (tile_live(a.mask, a.window, q_lo, q_hi, kt * T, min(kt * T + T, a.Sk) - 1)) {
      kt_first = min(kt_first, kt);
      kt_last = kt;
    }
  }

  auto load_kv = [&](int kt, int st) {
    stage_rows<D, T>(k_s + st * TILE_B, kb, a.ks[1], kt * T, a.Sk, Dt, wide);
    stage_rows<D, T>(v_s + st * TILE_B, vb, a.vs[1], kt * T, a.Sk, Dt, wide);
  };
  if (kt_first <= kt_last) {
    stage_rows<D, T>(q_s, (const __nv_bfloat16*)a.q + b * a.qs[0] + h * a.qs[2], a.qs[1], q0,
                     a.Sq, Dt, wide);
    stage_rows<D, T>(o_s, (const __nv_bfloat16*)a.dout + b * a.ds[0] + h * a.ds[2], a.ds[1],
                     q0, a.Sq, Dt, wide);
    load_kv(kt_first, 0);
    cp_commit();
  }

  // the warp's query rows; the lane's two, qr[0] and qr[1], with their lse
  // (times log2 e) and delta
  const int qw = q0 + 16 * rg;
  const int qw_lo = a.q_offset + qw, qw_hi = a.q_offset + min(qw + 16, a.Sq) - 1;
  const int qr[2] = {qw + (lane >> 2), qw + (lane >> 2) + 8};
  float lq[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = ((long long)b * a.Hq + h) * a.Sq + (qr[i] < a.Sq ? qr[i] : 0);
    lq[i] = a.lse[at] * kLog2e;
    dl[i] = a.delta[at];
  }

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  uint32_t qf[QREG ? KS : 1][4], of[QREG ? KS : 1][4];

  const Lanes ln = lanes<D>(lane);
  const uint32_t q_a = q_s + 16 * rg * ROW_B + ln.a_row, o_a = o_s + 16 * rg * ROW_B + ln.a_row;
  const float c2 = a.scale * kLog2e;

  for (int kt = kt_first, st = 0; kt <= kt_last; ++kt, st ^= 1) {
    cp_wait<0>();
    __syncthreads();
    if (kt < kt_last) {
      load_kv(kt + 1, st ^ 1);
      cp_commit();
    }
    if constexpr (QREG) {
      if (kt == kt_first) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(q_a + (((2 * kk) ^ ln.a_x) << 4), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
          ldsm_x4(o_a + (((2 * kk) ^ ln.a_x) << 4), of[kk][0], of[kk][1], of[kk][2], of[kk][3]);
        }
      }
    }
    if (qw >= a.Sq) continue;  // the warp's rows are all past Sq
    const uint32_t k_st = k_s + st * TILE_B, v_st = v_s + st * TILE_B;
#pragma unroll 1
    for (int c = 0; c < T / 16; ++c) {  // 16-key chunks
      const int kc = kt * T + 16 * c;
      if (kc >= a.Sk) break;
      const int kc_hi = min(kc + 16, a.Sk) - 1;
      if (!tile_live(a.mask, a.window, qw_lo, qw_hi, kc, kc_hi)) continue;

      // ---- S = Q K^T, dP = dout V^T: 16 queries x 2 n-tiles of 8 keys ----
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const uint32_t k_b = k_st + 16 * c * ROW_B + ln.bn_row;
      const uint32_t v_b = v_st + 16 * c * ROW_B + ln.bn_row;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], oa[4], b0, b1, b2, b3;
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kk][e];
            oa[e] = of[kk][e];
          }
        } else {
          ldsm_x4(q_a + (((2 * kk) ^ ln.a_x) << 4), qa[0], qa[1], qa[2], qa[3]);
          ldsm_x4(o_a + (((2 * kk) ^ ln.a_x) << 4), oa[0], oa[1], oa[2], oa[3]);
        }
        ldsm_x4(k_b + (((2 * kk) ^ ln.bn_x) << 4), b0, b1, b2, b3);
        mma_bf16(s[0], qa, b0, b1);
        mma_bf16(s[1], qa, b2, b3);
        ldsm_x4(v_b + (((2 * kk) ^ ln.bn_x) << 4), b0, b1, b2, b3);
        mma_bf16(dp[0], oa, b0, b1);
        mma_bf16(dp[1], oa, b2, b3);
      }

      // ---- dS in the fragments: lane holds rows qr[e / 2] and keys
      // kc + 8 j + 2 (lane % 4) + e % 2 ----
      const bool whole = qw + 16 <= a.Sq && kc + 16 <= a.Sk &&
                         tile_whole(a.mask, a.window, qw_lo, qw_hi, kc, kc_hi);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = ex2(fmaf(s[j][e], c2, -lq[i]));
          if (!whole) {
            const int key = kc + 8 * j + 2 * (lane & 3) + (e & 1);
            p = key < a.Sk && qr[i] < a.Sq &&
                        visible(a.mask, a.window, a.q_offset + qr[i], key)
                    ? p
                    : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - dl[i]);
        }
      }

      // ---- dq += dS K: the split dS is the A operand of one 16-key
      // k-step; K by ldmatrix.trans ----
      uint32_t hi[4], lo[4];
      split_a(dp, hi, lo);
      const uint32_t k_t = k_st + 16 * c * ROW_B + ln.bt_row;
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        const int ch = 2 * (cs * (NO / 2) + np);
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(k_t + ((ch ^ ln.bt_x) << 4), b0, b1, b2, b3);
        mma_bf16(dq[2 * np], hi, b0, b1);
        mma_bf16(dq[2 * np + 1], hi, b2, b3);
        mma_bf16(dq[2 * np], lo, b0, b1);
        mma_bf16(dq[2 * np + 1], lo, b2, b3);
      }
    }
  }

  __nv_bfloat16* dqp = (__nv_bfloat16*)a.dq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qr[i] >= a.Sq) continue;
    const long long row = (((long long)b * a.Sq + qr[i]) * a.Hq + h) * Dt;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * (cs * NO + n) + 2 * (lane & 3);
      store_pair(dqp + row, col, Dt, dq[n][2 * i] * a.scale, dq[n][2 * i + 1] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int launch_kernel(K kern, dim3 grid, int threads, int smem, const BwdArgs& a, cudaStream_t st) {
  // dynamic shared memory above 48 KB must be opted into per kernel
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kern<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta(const BwdArgs& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// f32 operands: the CUDA-core body
template <int D>
int launch_f32(const BwdArgs& a, int tile, int smem_kv, int smem_q, cudaStream_t st) {
  // the plan must be this file's geometry
  if (tile != tile_rows<D>() || smem_kv != kv_smem_bytes<D>() || smem_q != q_smem_bytes<D>())
    return (int)cudaErrorInvalidValue;
  int err = launch_delta<float>(a, st);
  if (err) return err;
  const int TR = tile_rows<D>();
  err = launch_kernel(dkdv_kernel<float, D>, dim3((a.Sk + TR - 1) / TR, a.B * a.Hk), kThreads,
                      smem_kv, a, st);
  if (err) return err;
  return launch_kernel(dq_kernel<float, D>, dim3((a.Sq + TR - 1) / TR, a.B * a.Hq), kThreads,
                       smem_q, a, st);
}

// bf16 operands: the tensor-core body
template <int D>
int launch_mma(const BwdArgs& a, int tile, int smem_kv, int smem_q, cudaStream_t st) {
  if (tile != mma_tile<D>() || smem_kv != mma_kv_smem_bytes<D>() ||
      smem_q != mma_q_smem_bytes<D>())
    return (int)cudaErrorInvalidValue;
  int err = launch_delta<__nv_bfloat16>(a, st);
  if (err) return err;
  const int T = mma_tile<D>();
  err = launch_kernel(dkdv_mma_kernel<D>, dim3(a.B * a.Hk, (a.Sk + T - 1) / T), kMmaThreads,
                      smem_kv, a, st);
  if (err) return err;
  return launch_kernel(dq_mma_kernel<D>, dim3(a.B * a.Hq, (a.Sq + T - 1) / T), kMmaThreads,
                       smem_q, a, st);
}

template <int D>
int launch_bwd(const BwdArgs& a, int dtype, int tile, int smem_kv, int smem_q, cudaStream_t st) {
  if (dtype == 0) return launch_f32<D>(a, tile, smem_kv, smem_q, st);
  if (dtype == 1) return launch_mma<D>(a, tile, smem_kv, smem_q, st);
  return (int)cudaErrorInvalidValue;
}

// Does every row of a bf16 operand start on a 16-byte boundary?
bool wide_rows(const void* p, long long sb, long long ss, long long sh) {
  return (uintptr_t)p % 16 == 0 && sb % 8 == 0 && ss % 8 == 0 && sh % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q, k, v, o, dout and the outputs share it);
// mask: 0 full, 1 causal, 2 sliding, 3 chunked, 4 prefix_causal.  D is the
// true head width, DP the compiled width it runs at.  Strides are in
// elements (unit stride along D); lse is (B, Hq, Sq) f32 from the forward,
// delta a (B, Hq, Sq) f32 workspace; dq (B, Sq, Hq, D), dk and dv (B, Sk,
// Hk, D) are written whole and contiguous; bf16 rows may start anywhere
// (rows not all on 16-byte boundaries are staged element by element).
// tile / smem_kv / smem_q: the plan (tile rows, the two blocks' dynamic
// shared memory), checked against this file's geometry for the dtype.
// Returns cudaGetLastError() after the launches.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hk, int D,
                               int DP, long long qsb, long long qss, long long qsh,
                               long long ksb, long long kss, long long ksh, long long vsb,
                               long long vss, long long vsh, long long osb, long long oss,
                               long long osh, long long dsb, long long dss, long long dsh,
                               int dtype, int mask, int window, int q_offset, float scale,
                               int tile, int smem_kv, int smem_q, void* stream) {
  if (((mask == kSliding || mask == kChunked || mask == kPrefix) && window <= 0) ||
      mask < kFull || mask > kPrefix || D < 1 || D > DP || Hk < 1 || Hq % Hk)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = (const float*)lse;
  a.delta = (float*)delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hk = Hk;
  a.D = D;
  a.qs[0] = qsb; a.qs[1] = qss; a.qs[2] = qsh;
  a.ks[0] = ksb; a.ks[1] = kss; a.ks[2] = ksh;
  a.vs[0] = vsb; a.vs[1] = vss; a.vs[2] = vsh;
  a.os[0] = osb; a.os[1] = oss; a.os[2] = osh;
  a.ds[0] = dsb; a.ds[1] = dss; a.ds[2] = dsh;
  a.mask = mask;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  a.wide = wide_rows(q, qsb, qss, qsh) && wide_rows(k, ksb, kss, ksh) &&
           wide_rows(v, vsb, vss, vsh) && wide_rows(dout, dsb, dss, dsh);
  cudaStream_t st = (cudaStream_t)stream;
  switch (DP) {
    case 16: return launch_bwd<16>(a, dtype, tile, smem_kv, smem_q, st);
    case 32: return launch_bwd<32>(a, dtype, tile, smem_kv, smem_q, st);
    case 64: return launch_bwd<64>(a, dtype, tile, smem_kv, smem_q, st);
    case 128: return launch_bwd<128>(a, dtype, tile, smem_kv, smem_q, st);
    case 256: return launch_bwd<256>(a, dtype, tile, smem_kv, smem_q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
