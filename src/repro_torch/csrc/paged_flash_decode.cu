// Page-table-aware single-token GQA decode attend over a paged KV pool.
//
// Replaces: src/repro/kernels/paged_flash_decode/kernel.py,
//   paged_flash_decode_pallas (bodies _bf16_body and _int8_body).
//
// What bounds it on the H100: bytes.  Per (slot, kv-head) cell it must read
// pos+1 K rows and pos+1 V rows of D values (plus two f32 scales per row in
// the int8 body) and does about 4*g*D operations per row: with g = 3 that is
// ~1.5 flops per byte in bf16, far below the ~295 the card needs before its
// arithmetic is the limit.
//
// What the design does about it:
//   * one block per (slot, kv-head); the block walks the slot's page list
//     only up to page pos/page_size, so lanes past pos (probability exactly
//     0 in the reference: exp(-1e30 - m) underflows) are never read;
//   * the g query rows of the kv head share every K/V row read (GQA);
//   * the g x span score rows live in dynamic shared memory, so K and V are
//     each read once and nothing but the (g, D) output is written;
//   * a warp scores one key row at a time (lanes split D), a thread owns one
//     output column d for the PV sum, so each row read is coalesced.
// Softmax is deferred, as in the reference: row max, exp, sum, normalise.
// The int8 body follows the engine's A2/A3 sequence: q quantised per row
// with rintf (half to even, like jnp.round), an exact int32 QK dot, the
// (i32 * q_scale) * k_scale * D^-1/2 rescale in that order, v_scale folded
// into the probabilities, probabilities quantised to [0, 127], an int8 PV
// sum (exact integers) times w_scale.
//
// Pools are addressed through strides (token, head), so the slot layout's
// heads-major stacks feed the same kernel through an identity page table
// without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // repro.core.attention.NEG_INF
constexpr int kThreads = 128;
constexpr int kMaxG = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Block-wide reductions; `red` holds 32 floats of shared memory.  The
// leading barrier lets a caller reduce twice in a row with one buffer.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    int nw = blockDim.x >> 5;
    v = threadIdx.x < nw ? red[threadIdx.x] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    int nw = blockDim.x >> 5;
    v = threadIdx.x < nw ? red[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Lanes this cell reads: 0..pos.  A negative pos (no valid lane) reads the
// whole span, where the reference's all-masked softmax is uniform.
__device__ __forceinline__ int span_of(int p, int S) { return p < 0 ? S : min(p + 1, S); }

// Physical pool row of every lane < n into rows[]: lanes on unmapped (-1)
// pages read row 0, as kv_cache.phys_table maps them (a live slot masks
// them by position; an idle slot's garbage row then matches the plain
// version's exactly).
__device__ void page_rows(const int* __restrict__ page_ids, int b, int pp, int P, int n,
                          int* rows) {
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    int pid = page_ids[(long long)b * pp + s / P];
    rows[s] = pid < 0 ? 0 : pid * P + s % P;
  }
}

// Deferred softmax of each of the g rows of sc (row stride S) over lanes < n.
__device__ void softmax_rows(float* sc, int g, int S, int n, float* red) {
  for (int gi = 0; gi < g; ++gi) {
    float* row = sc + (long long)gi * S;
    float m = -INFINITY;
    for (int s = threadIdx.x; s < n; s += blockDim.x) m = fmaxf(m, row[s]);
    m = block_max(m, red);
    float sum = 0.f;
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = block_sum(sum, red);
    for (int s = threadIdx.x; s < n; s += blockDim.x) row[s] = row[s] / sum;
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dense_kernel(
    const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ page_ids, const int* __restrict__ pos, float* __restrict__ out,
    int Hk, int g, int D, int pp, int P, long long tok_stride, long long head_stride,
    float scale) {
  extern __shared__ float smem[];
  const int S = pp * P;
  const int b = blockIdx.x / Hk, h = blockIdx.x % Hk;
  const int p = pos[b];
  const int n = span_of(p, S);
  float* qs = smem;                       // (g, D)
  float* sc = qs + g * D;                 // (g, S)
  float* red = sc + (long long)g * S;     // (32,)
  int* rows = reinterpret_cast<int*>(red + 32);  // (S,)

  const float* qb = q + (long long)blockIdx.x * g * D;
  for (int i = threadIdx.x; i < g * D; i += blockDim.x) qs[i] = qb[i];
  page_rows(page_ids, b, pp, P, n, rows);
  __syncthreads();

  const T* kh = k + h * head_stride;
  const T* vh = v + h * head_stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int s = warp; s < n; s += nw) {
    const T* kr = kh + rows[s] * tok_stride;
    float acc[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0.f;
    for (int d = lane; d < D; d += 32) {
      float kd = to_f(kr[d]);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) acc[gi] += qs[gi * D + d] * kd;
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi >= g) break;
      float a = acc[gi];
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) sc[(long long)gi * S + s] = s <= p ? a * scale : kNegInf;
    }
  }
  __syncthreads();
  softmax_rows(sc, g, S, n, red);

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0.f;
    for (int s = 0; s < n; ++s) {
      float vd = to_f(vh[rows[s] * tok_stride + d]);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) acc[gi] += sc[(long long)gi * S + s] * vd;
    }
    for (int gi = 0; gi < g; ++gi) out[((long long)blockIdx.x * g + gi) * D + d] = acc[gi];
  }
}

__global__ void __launch_bounds__(kThreads) int8_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ page_ids, const int* __restrict__ pos, float* __restrict__ out,
    int Hk, int g, int D, int pp, int P, long long tok_stride, long long head_stride,
    long long sc_tok_stride, long long sc_head_stride, float scale) {
  extern __shared__ float smem[];
  const int S = pp * P;
  const int b = blockIdx.x / Hk, h = blockIdx.x % Hk;
  const int p = pos[b];
  const int n = span_of(p, S);
  int* qq = reinterpret_cast<int*>(smem);  // (g, D) quantised query
  float* sc = smem + g * D;                // (g, S) logits -> probs -> w codes
  float* red = sc + (long long)g * S;      // (32,)
  int* rows = reinterpret_cast<int*>(red + 32);  // (S,)
  __shared__ float q_scale[kMaxG], w_scale[kMaxG];

  // A2: per-row absmax/127 quantisation of the query
  const float* qb = q + (long long)blockIdx.x * g * D;
  for (int gi = 0; gi < g; ++gi) {
    float m = 0.f;
    for (int d = threadIdx.x; d < D; d += blockDim.x) m = fmaxf(m, fabsf(qb[gi * D + d]));
    m = block_max(m, red);
    float qs = fmaxf(m, 1e-8f) / 127.0f;
    if (threadIdx.x == 0) q_scale[gi] = qs;
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      qq[gi * D + d] = (int)fminf(fmaxf(rintf(qb[gi * D + d] / qs), -127.f), 127.f);
  }
  page_rows(page_ids, b, pp, P, n, rows);
  __syncthreads();

  const int8_t* kh = k + h * head_stride;
  const int8_t* vh = v + h * head_stride;
  const float* ksh = k_scale + h * sc_head_stride;
  const float* vsh = v_scale + h * sc_head_stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int s = warp; s < n; s += nw) {
    const int8_t* kr = kh + rows[s] * tok_stride;
    int acc[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0;
    for (int d = lane; d < D; d += 32) {
      int kd = kr[d];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) acc[gi] += qq[gi * D + d] * kd;
    }
    const float ks = ksh[rows[s] * sc_tok_stride];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi >= g) break;
      int a = acc[gi];
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0)
        sc[(long long)gi * S + s] = s <= p ? (float)a * q_scale[gi] * ks * scale : kNegInf;
    }
  }
  __syncthreads();
  softmax_rows(sc, g, S, n, red);

  // A3: fold v_scale into the probs, quantise them per row to [0, 127]
  for (int gi = 0; gi < g; ++gi) {
    float* row = sc + (long long)gi * S;
    float m = 0.f;
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      float w = row[s] * vsh[rows[s] * sc_tok_stride];
      row[s] = w;
      m = fmaxf(m, w);
    }
    m = block_max(m, red);
    float ws = fmaxf(m, 1e-20f) / 127.0f;
    if (threadIdx.x == 0) w_scale[gi] = ws;
    for (int s = threadIdx.x; s < n; s += blockDim.x)
      row[s] = fminf(fmaxf(rintf(row[s] / ws), 0.f), 127.f);
  }
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    int acc[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0;
    for (int s = 0; s < n; ++s) {
      int vd = vh[rows[s] * tok_stride + d];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) acc[gi] += (int)sc[(long long)gi * S + s] * vd;
    }
    for (int gi = 0; gi < g; ++gi)
      out[((long long)blockIdx.x * g + gi) * D + d] = (float)acc[gi] * w_scale[gi];
  }
}

size_t smem_bytes(int g, int D, int S) {
  return sizeof(float) * ((size_t)g * D + (size_t)g * S + 32) + sizeof(int) * (size_t)S;
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

size_t paged_flash_decode_smem_bytes(int g, int D, int pages_per_slot, int page_size) {
  return smem_bytes(g, D, pages_per_slot * page_size);
}

// kv_dtype: 0 = bf16, 1 = f32.  Returns cudaGetLastError() after the launch.
int paged_flash_decode_dense_launch(const void* q, const void* k, const void* v,
                                    const void* page_ids, const void* pos, void* out, int B,
                                    int Hk, int g, int D, int pp, int P, long long tok_stride,
                                    long long head_stride, int kv_dtype, float scale,
                                    void* stream) {
  const size_t smem = smem_bytes(g, D, pp * P);
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (kv_dtype == 0) {
    auto kern = dense_kernel<__nv_bfloat16>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<B * Hk, kThreads, smem, st>>>(
        (const float*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const int*)page_ids, (const int*)pos, (float*)out, Hk, g, D, pp, P, tok_stride,
        head_stride, scale);
  } else {
    auto kern = dense_kernel<float>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<B * Hk, kThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)page_ids,
        (const int*)pos, (float*)out, Hk, g, D, pp, P, tok_stride, head_stride, scale);
  }
  return (int)cudaGetLastError();
}

int paged_flash_decode_int8_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_ids, const void* pos, void* out, int B,
                                   int Hk, int g, int D, int pp, int P, long long tok_stride,
                                   long long head_stride, long long sc_tok_stride,
                                   long long sc_head_stride, float scale, void* stream) {
  const size_t smem = smem_bytes(g, D, pp * P);
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if ((err = allow_smem(int8_kernel, smem))) return err;
  int8_kernel<<<B * Hk, kThreads, smem, st>>>(
      (const float*)q, (const int8_t*)k, (const int8_t*)v, (const float*)k_scale,
      (const float*)v_scale, (const int*)page_ids, (const int*)pos, (float*)out, Hk, g, D, pp,
      P, tok_stride, head_stride, sc_tok_stride, sc_head_stride, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
