// Tiled online-softmax GQA attention (the whole-sequence forward's attend).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (body _kernel): causal / sliding / chunked / full
//   masks, GQA (query head h reads kv head h / g), fully masked key tiles
//   skipped by the same index-range predicate.
//
// What bounds it on the H100: at the forward's shapes (bf16, D = 128,
// causal, S = 512) it must move q, k, v and out once (~8.4 MB at B = 1) and
// do 4*D operations per visible (query, key) pair (~1.6 GFLOP): ~190 flops a
// byte, under the ~295 where the bf16 tensor cores would be the limit, so
// the card's bound is its bytes (~2.5 us).  This first kernel runs its
// arithmetic in f32 on the CUDA cores (67 TFLOP/s, ~24 us for that work)
// and is about 100x off the bound (PERF.md, K5).  What holds it back is not
// measured (the profiler there gives no per-kernel counters); the likely
// parts: each K/V tile is staged with element-wide loads and nothing in
// flight behind it, only 4-8 warps an SM hide that latency, and the score
// and PV loops issue a shared-memory load for every 2-3 FMAs.  Tensor cores
// (wgmma), cp.async / TMA double buffering and wider loads are the next
// steps.
//
// What the design does:
//   * one 128-thread block per (64-row query tile, batch x query head);
//     the block walks the key tiles of 64 in order and skips a tile that
//     holds no visible (query, key) pair (exact interval tests: a causal
//     sweep does ~half the tiles, a sliding one O(window));
//   * the Q tile and each K/V tile are staged in shared memory as f32, so
//     every K/V element read serves 64 query rows; rows are padded by one
//     float so the 8 column lanes and 4 row groups of a warp hit distinct
//     banks;
//   * a thread owns 4 query rows x 8 key columns of the score tile and
//     4 rows x D/8 output columns of the accumulator; the running
//     (max, denominator) of a row lives in the 8 lanes that share it and is
//     reduced with shuffles;
//   * query tiles are issued heaviest first (the last causal tile sees the
//     most keys), so the tail of the grid is short.
// Arithmetic, as the reference's online softmax: s = (q . k) * scale in
// f32, masked entries set to -1e30 (keys at or past Sk never attend),
// m' = max(m, max s), p = exp(s - m'), c = exp(m - m'), l = l c + sum p,
// acc = acc c + p v with p kept in f32 (the Pallas body rounds p to v's
// dtype; this kernel does not), out = acc / max(l, 1e-30) rounded once to
// q's dtype.  Sq and Sk are arbitrary: tail query rows are computed on
// zeros and never written, tail key lanes are masked.
//
// Tolerance held against the plain version (flash_attention_ref, the
// materialised softmax) on the card: |out - ref| <= 1e-5 * max|v| per
// element for f32 operands (the sums run in another order); for bf16
// operands that plus one bf16 step (the spacing of bf16 values at |ref|),
// since two f32 results that close can round to neighbouring bf16 values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // repro.core.attention.NEG_INF
constexpr int kBQ = 64;            // query rows a block
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 128;      // 16 row groups x 8 column lanes
constexpr int kRows = kBQ / 16;    // query rows a thread
constexpr int kCols = kBK / 8;     // key columns a thread (strided by 8)

enum MaskKind { kFull = 0, kCausal = 1, kSliding = 2, kChunked = 3 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Sk, Hq, Hk;
  long long qs[3], ks[3], vs[3];  // batch, sequence and head strides (elements)
  int mask, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Does query position qi see key position kj?
__device__ __forceinline__ bool visible(int mask, int w, int qi, int kj) {
  if (mask == kFull) return true;
  const bool causal = kj <= qi;
  if (mask == kCausal) return causal;
  if (mask == kSliding) return causal && qi - kj < w;
  return causal && qi / w == kj / w;
}

// Does the tile of query positions [q_lo, q_hi] x keys [k_lo, k_hi] hold a
// visible pair?  The union of the rows' visible key ranges is one interval
// ([q_lo - w + 1, q_hi] sliding, [q_lo / w * w, q_hi] chunked), so the
// test is exact.
__device__ __forceinline__ bool tile_live(int mask, int w, int q_lo, int q_hi, int k_lo,
                                          int k_hi) {
  if (mask == kFull) return true;
  if (k_lo > q_hi) return false;
  if (mask == kCausal) return true;
  if (mask == kSliding) return k_hi >= q_lo - w + 1;
  return k_hi / w >= q_lo / w;
}

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
    Qs[r * LD + d] = s < a.Sq ? to_f(qb[s * a.qs[1] + d]) : 0.f;
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
      const bool in = s < a.Sk;
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
    T* row = out + (((long long)b * a.Sq + s) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(row + tx + 8 * c, acc[i][c] / den);
  }
}

template <typename T, int D>
int launch_typed(const Args& a, int B, cudaStream_t st) {
  auto kern = flash_kernel<T, D>;
  const size_t smem = smem_floats<D>() * sizeof(float);
  // dynamic shared memory above 48 KB must be opted into per kernel
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.Hq);
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch_typed<T, 16>(a, B, st);
    case 32: return launch_typed<T, 32>(a, B, st);
    case 64: return launch_typed<T, 64>(a, B, st);
    case 128: return launch_typed<T, 128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16; mask: 0 full, 1 causal, 2 sliding, 3 chunked.
// Strides are in elements; D must be unit stride.  Returns
// cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B,
                           int Sq, int Sk, int Hq, int Hk, int D, long long qsb,
                           long long qss, long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss, long long vsh,
                           int dtype, int mask, int window, int q_offset, float scale,
                           void* stream) {
  if ((mask == kSliding || mask == kChunked) && window <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hk = Hk;
  a.qs[0] = qsb; a.qs[1] = qss; a.qs[2] = qsh;
  a.ks[0] = ksb; a.ks[1] = kss; a.ks[2] = ksh;
  a.vs[0] = vsb; a.vs[1] = vss; a.vs[2] = vsh;
  a.mask = mask;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? launch_d<float>(a, B, D, st) : launch_d<__nv_bfloat16>(a, B, D, st);
}

}  // extern "C"
