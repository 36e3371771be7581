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
// 16, 32, 64, 128 and 256, as the forward) and Sq != Sk.
//
// Arithmetic.  With s = scale q.k and P = exp(s - lse) on the visible
// pairs (0 elsewhere; lse the forward's row log-sum-exp), the gradient is
//   delta_i = sum_d dout_id o_id                (one f32 sum a query row)
//   dv_j   += sum_i P_ij dout_i
//   dS_ij   = P_ij (dout_i . v_j - delta_i)
//   dk_j   += scale sum_i dS_ij q_i
//   dq_i    = scale sum_j dS_ij k_j
// summed over the query heads of each kv head's group for dk and dv.  All
// of it runs in f32 on the CUDA cores from operands read as f32 (bf16
// values are exact in f32), so the kernel departs from the materialised
// plain version (flash_attention_bwd_ref) by summation order alone, and
// the results are rounded once to the operands' dtype.
//
// Three launches on the stream, one C call:
//   1. delta: a warp a query row.
//   2. dk, dv: a block per (key tile of T keys, batch x kv head).  K and V
//      stay in shared memory; the block walks the group's query heads and,
//      for each, the query tiles the mask lets see its key tile (the exact
//      tile test of flash_attention.cuh), staging Q, dout, lse and delta
//      of each.  A thread owns R key rows: for S^T and dP^T it holds R x
//      T/16 (key, query) entries, for dk and dv R x D/16 (key, column)
//      accumulators in registers, over the whole walk.  The group's sum
//      happens inside the block in a fixed order: no atomics, so two
//      launches on the same inputs give identical bits.
//   3. dq: a block per (query tile of T rows, batch x query head), heaviest
//      first; Q, dout, lse and delta stay in shared memory while the block
//      walks the live key tiles in order.
// T is 64 up to D 128 and 32 at D 256 (shared memory: 165,888 B at D 128,
// 140,288 B at D 256, tiles padded by one float a row against bank
// conflicts), 256 threads a block.
//
// What bounds it on the H100.  At phi4-mini's training shape (B 1, S 4096,
// Hq 24, Hk 8, D 128, causal, bf16) it must read q, k, v, o and dout once
// and write dq, dk and dv once: 4096 * 128 * 2 B a head, over 24 + 8 + 8 +
// 24 + 24 heads read and 24 + 8 + 8 written, 134.2 MB, 0.040 ms at 3.35
// TB/s (lse adds 0.4 MB); its operations are 10 D per visible (query,
// key) pair (the five products QK^T, dout V^T, P^T dout, dS^T Q and dS K,
// two operations a multiply-add): 10 * 128 * 201.4 M pairs = 257.8 GFLOP, 0.26 ms at the
// bf16 tensor cores' 989 TFLOP/s.  So it is bound by operations.  This
// design does them as f32 FMAs on the CUDA cores (67 TFLOP/s at most; a
// shared-memory load for every two FMAs), and recomputes S in both the
// dk/dv and the dq pass (seven products, not five): a simple kernel that
// is right first.  The tensor-core route (mma.sync or wgmma with split
// bf16 operands for P and dS, as the forward's bf16 body splits p) is
// later work.
//
// A query row that sees no key is outside the contract, as in the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

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
  int D;  // the true head width (<= the compiled width DP)
  long long qs[3], ks[3], vs[3], os[3], ds[3];  // batch, sequence, head strides (elements)
  int mask, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <typename K>
int launch_kernel(K kern, dim3 grid, int smem, const BwdArgs& a, cudaStream_t st) {
  // dynamic shared memory above 48 KB must be opted into per kernel
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const BwdArgs& a, int tile, int smem_kv, int smem_q, cudaStream_t st) {
  // the plan must be this file's geometry
  if (tile != tile_rows<D>() || smem_kv != kv_smem_bytes<D>() || smem_q != q_smem_bytes<D>())
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, st>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int TR = tile_rows<D>();
  err = launch_kernel(dkdv_kernel<T, D>, dim3((a.Sk + TR - 1) / TR, a.B * a.Hk), smem_kv, a, st);
  if (err) return err;
  return launch_kernel(dq_kernel<T, D>, dim3((a.Sq + TR - 1) / TR, a.B * a.Hq), smem_q, a, st);
}

template <typename T>
int launch_dtype(const BwdArgs& a, int DP, int tile, int smem_kv, int smem_q, cudaStream_t st) {
  switch (DP) {
    case 16: return launch_bwd<T, 16>(a, tile, smem_kv, smem_q, st);
    case 32: return launch_bwd<T, 32>(a, tile, smem_kv, smem_q, st);
    case 64: return launch_bwd<T, 64>(a, tile, smem_kv, smem_q, st);
    case 128: return launch_bwd<T, 128>(a, tile, smem_kv, smem_q, st);
    case 256: return launch_bwd<T, 256>(a, tile, smem_kv, smem_q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q, k, v, o, dout and the outputs share it);
// mask: 0 full, 1 causal, 2 sliding, 3 chunked, 4 prefix_causal.  D is the
// true head width, DP the compiled width it runs at.  Strides are in
// elements (unit stride along D); lse is (B, Hq, Sq) f32 from the forward,
// delta a (B, Hq, Sq) f32 workspace; dq (B, Sq, Hq, D), dk and dv (B, Sk,
// Hk, D) are written whole and contiguous.  tile / smem_kv / smem_q: the
// plan (tile rows, the two blocks' dynamic shared memory), checked against
// this file's geometry.  Returns cudaGetLastError() after the launches.
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
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_dtype<float>(a, DP, tile, smem_kv, smem_q, st);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(a, DP, tile, smem_kv, smem_q, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
