// Fused two-phase BGPP decode (bit-grained progressive prediction) over a
// paged bit-plane KV pool.
//
// Replaces: src/repro/kernels/bgpp_paged_attend/kernel.py,
//   bgpp_paged_attend_pallas (body _body, selection _topk_iter).
//
// What bounds it on the H100: bytes.  Per (slot, kv-head) cell it must read
// the packed sign and MSB magnitude plane of every valid lane (D/4 bytes a
// lane), one further plane for each progressive round's survivors (D/8 bytes
// a survivor), and the k_max final survivors' remaining planes, scales and
// int8 V row.  Its arithmetic (g*D adds per plane row, a sort of S keys per
// round) is a few operations per byte.
//
// What the design does about it:
//   * one block per (slot, kv-head) runs the whole pipeline of the
//     reference cell: quantise + MSB-truncate the g query rows; round 0
//     scores sign x MSB plane of every valid lane through the phys map;
//     each progressive round keeps survivors[r] candidates and fetches only
//     their next plane; the final k_max rows are rebuilt to int8 K from
//     their 7 planes + sign and the exact int8 A2/A3 attend runs on them.
//     Nothing wider than k_max full rows is read, matching the kv-read
//     counter's claim;
//   * lanes past pos are never read (their scores are NEG_INF, which orders
//     them after every valid lane by position, exactly as in the
//     reference); a final survivor whose quantised probability is 0
//     contributes nothing and its V row is not read;
//   * the g partial-score rows, the candidate list and the sort keys live
//     in shared memory (24 KB + 8 KB + 8 KB at S = 1024, g = 3).
// Selection is integer-exact: plane scores are integers below 2^24, exact
// in f32 in any summation order.  Top-k is one stable bitonic sort per
// round of 64-bit keys (score descending, position in the current list
// ascending), which selects the same set in the same order as lax.top_k's
// lowest-index tie-break.  The final attend keeps that selection order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // repro.core.attention.NEG_INF
constexpr int kThreads = 256;
constexpr int kMaxG = 8;
constexpr int kMaxRounds = 8;

struct Plan {
  int rounds;
  int k_max;
  int survivors[kMaxRounds];
};

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

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Sort key: ascending order of the key is descending score, then ascending
// position.  -0.0 folds into +0.0 so the two compare equal, as floats do.
__device__ __forceinline__ unsigned long long make_key(float score, int j) {
  unsigned u = __float_as_uint(score + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order-preserving
  return ((unsigned long long)(~u) << 32) | (unsigned)j;
}

__device__ void bitonic_sort(unsigned long long* keys, int N) {
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < N; i += blockDim.x) {
        int ixj = i ^ j;
        if (ixj > i) {
          unsigned long long a = keys[i], b = keys[ixj];
          bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Signed plane contribution of one packed row: sum_d qf[g][d] * (+-bit_d),
// accumulated into acc[g].  Integer-valued, so exact in any order.
__device__ __forceinline__ void plane_dot(const float* qf, int g, int D, const uint8_t* plane,
                                          const uint8_t* sign, float* acc) {
  for (int j = 0; j < D / 8; ++j) {
    unsigned pb = plane[j], sb = sign[j];
    if (!pb) continue;
    for (int t = 0; t < 8; ++t) {
      if (!((pb >> t) & 1u)) continue;
      const int d = 8 * j + t;
      const bool neg = (sb >> t) & 1u;
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) acc[gi] += neg ? -qf[gi * D + d] : qf[gi * D + d];
    }
  }
}

__global__ void __launch_bounds__(kThreads) bgpp_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ planes,
    const uint8_t* __restrict__ sign, const float* __restrict__ k_scale,
    const int8_t* __restrict__ v, const float* __restrict__ v_scale,
    const int* __restrict__ phys, const int* __restrict__ pos, float* __restrict__ out,
    int* __restrict__ out_idx, int Hk, int g, int D, int S, int nbits, int query_bits,
    Plan plan, long long pl_plane, long long pl_tok, long long pl_head, long long v_tok,
    long long v_head, long long sc_tok, long long sc_head, float scale) {
  extern __shared__ unsigned long long smem_u64[];
  const int N = next_pow2(S);
  const int K = plan.k_max;
  unsigned long long* keys = smem_u64;                      // (N,)
  float* qf = reinterpret_cast<float*>(keys + N);           // (g, D) truncated query
  int* qq = reinterpret_cast<int*>(qf + g * D);             // (g, D) quantised query
  float* part_a = reinterpret_cast<float*>(qq + g * D);     // (g, S)
  float* part_b = part_a + (long long)g * S;                // (g, S)
  float* score = part_b + (long long)g * S;                 // (S,)
  int* cand_a = reinterpret_cast<int*>(score + S);          // (S,)
  int* cand_b = cand_a + S;                                 // (S,)
  float* lg = reinterpret_cast<float*>(cand_b + S);         // (g, K)
  int* rowk = reinterpret_cast<int*>(lg + (long long)g * K);  // (K,)
  float* red = reinterpret_cast<float*>(rowk + K);          // (32,)
  __shared__ float q_scale[kMaxG], w_scale[kMaxG];
  __shared__ int any_valid;

  const int b = blockIdx.x / Hk, h = blockIdx.x % Hk;
  const int p = pos[b];
  const int* phys_b = phys + (long long)b * S;
  const uint8_t* sign_h = sign + h * pl_head;
  const uint8_t* planes_h = planes + h * pl_head;
  const int Dp = D / 8;

  // ---- quantise the g query rows; truncate to the top query_bits bits ---
  const float* qb = q + (long long)blockIdx.x * g * D;
  const int shift = max(nbits - query_bits, 0);
  for (int gi = 0; gi < g; ++gi) {
    float m = 0.f;
    for (int d = threadIdx.x; d < D; d += blockDim.x) m = fmaxf(m, fabsf(qb[gi * D + d]));
    m = block_max(m, red);
    const float dq = fmaxf(m, 1e-8f) / 127.0f;
    if (threadIdx.x == 0) q_scale[gi] = dq;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      int qi = (int)fminf(fmaxf(rintf(qb[gi * D + d] / dq), -127.f), 127.f);
      qq[gi * D + d] = qi;
      int mag = (abs(qi) >> shift) << shift;
      qf[gi * D + d] = (float)(qi < 0 ? -mag : mag);
    }
  }
  __syncthreads();

  // ---- round 0: sign x MSB plane of every valid lane ------------------
  const float w0 = (float)(1 << (nbits - 1));
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float acc[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0.f;
    float sc = kNegInf;
    if (s <= p) {
      const long long row = phys_b[s];
      plane_dot(qf, g, D, planes_h + (nbits - 1) * pl_plane + row * pl_tok,
                sign_h + row * pl_tok, acc);
      sc = -INFINITY;
      for (int gi = 0; gi < g; ++gi) sc = fmaxf(sc, acc[gi] * w0);
    }
    for (int gi = 0; gi < g; ++gi) part_a[(long long)gi * S + s] = acc[gi] * w0;
    score[s] = sc;
    cand_a[s] = s;
  }
  __syncthreads();

  // ---- progressive rounds, then the final k_max selection --------------
  int n_cur = S;
  for (int r = 1; r <= plan.rounds; ++r) {
    const bool final_sel = r == plan.rounds;
    const int k_r = final_sel ? K : plan.survivors[r];
    const int Nc = next_pow2(n_cur);
    for (int j = threadIdx.x; j < Nc; j += blockDim.x)
      keys[j] = j < n_cur ? make_key(score[j], j) : ~0ull;
    __syncthreads();
    bitonic_sort(keys, Nc);
    for (int j = threadIdx.x; j < k_r; j += blockDim.x) {
      const int li = (int)(keys[j] & 0xffffffffu);
      cand_b[j] = cand_a[li];
      for (int gi = 0; gi < g; ++gi)
        part_b[(long long)gi * S + j] = part_a[(long long)gi * S + li];
    }
    __syncthreads();
    { int* t = cand_a; cand_a = cand_b; cand_b = t; }
    { float* t = part_a; part_a = part_b; part_b = t; }
    n_cur = k_r;
    if (final_sel) break;
    const int p_r = nbits - 1 - r;
    const float wr = (float)(1 << p_r);
    for (int j = threadIdx.x; j < n_cur; j += blockDim.x) {
      const int lane = cand_a[j];
      float sc = kNegInf;
      if (lane <= p) {
        float acc[kMaxG];
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0.f;
        const long long row = phys_b[lane];
        plane_dot(qf, g, D, planes_h + p_r * pl_plane + row * pl_tok, sign_h + row * pl_tok,
                  acc);
        sc = -INFINITY;
        for (int gi = 0; gi < g; ++gi) {
          float v2 = part_a[(long long)gi * S + j] + acc[gi] * wr;
          part_a[(long long)gi * S + j] = v2;
          sc = fmaxf(sc, v2);
        }
      }
      score[j] = sc;
    }
    __syncthreads();
  }
  // cand_a[0..K) now holds the k_max survivors' logical lanes, in order

  // ---- phase 2: rebuild int8 K of the survivors, exact A2 logits -------
  if (threadIdx.x == 0) any_valid = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const int lane = cand_a[j];
    const long long row = phys_b[lane];
    rowk[j] = (int)row;
    if (out_idx) out_idx[(long long)blockIdx.x * K + j] = lane;
    if (lane <= p) {
      any_valid = 1;
      int acc[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0;
      const uint8_t* sr = sign_h + row * pl_tok;
      for (int jb = 0; jb < Dp; ++jb) {
        unsigned pb[8];
        for (int pl = 0; pl < nbits; ++pl) pb[pl] = planes_h[pl * pl_plane + row * pl_tok + jb];
        const unsigned sb = sr[jb];
        for (int t = 0; t < 8; ++t) {
          int mag = 0;
          for (int pl = 0; pl < nbits; ++pl) mag |= ((pb[pl] >> t) & 1u) << pl;
          const int kd = ((sb >> t) & 1u) ? -mag : mag;
          const int d = 8 * jb + t;
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi)
            if (gi < g) acc[gi] += qq[gi * D + d] * kd;
        }
      }
      const float ks = k_scale[row * sc_tok + h * sc_head];
      for (int gi = 0; gi < g; ++gi)
        lg[(long long)gi * K + j] = (float)acc[gi] * q_scale[gi] * ks * scale;
    } else {
      for (int gi = 0; gi < g; ++gi) lg[(long long)gi * K + j] = kNegInf;
    }
  }
  __syncthreads();

  // ---- softmax, v_scale fold, A3 prob quantisation ---------------------
  for (int gi = 0; gi < g; ++gi) {
    float* row = lg + (long long)gi * K;
    float m = -INFINITY;
    for (int j = threadIdx.x; j < K; j += blockDim.x) m = fmaxf(m, row[j]);
    m = block_max(m, red);
    float sum = 0.f;
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = block_sum(sum, red);
    float wm = 0.f;
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      const float pr = row[j] / sum;
      // a zero probability weighs nothing: its scale row need not be read
      const float w = (pr == 0.f && any_valid) ? 0.f
                                               : pr * v_scale[(long long)rowk[j] * sc_tok + h * sc_head];
      row[j] = w;
      wm = fmaxf(wm, w);
    }
    wm = block_max(wm, red);
    const float ws = fmaxf(wm, 1e-20f) / 127.0f;
    if (threadIdx.x == 0) w_scale[gi] = ws;
    for (int j = threadIdx.x; j < K; j += blockDim.x)
      row[j] = fminf(fmaxf(rintf(row[j] / ws), 0.f), 127.f);
  }
  __syncthreads();

  // ---- A3: int8 PV over the survivors, in selection order --------------
  const int8_t* vh = v + h * v_head;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    int acc[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0;
    for (int j = 0; j < K; ++j) {
      int wsum = 0;
      for (int gi = 0; gi < g; ++gi) wsum += (int)lg[(long long)gi * K + j];
      if (!wsum) continue;  // zero codes add nothing: skip the V row
      const int vd = vh[(long long)rowk[j] * v_tok + d];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) acc[gi] += (int)lg[(long long)gi * K + j] * vd;
    }
    for (int gi = 0; gi < g; ++gi)
      out[((long long)blockIdx.x * g + gi) * D + d] = (float)acc[gi] * w_scale[gi];
  }
}

size_t smem_bytes(int g, int D, int S, int k_max) {
  return sizeof(unsigned long long) * (size_t)next_pow2(S) +
         sizeof(float) * (size_t)g * D * 2 +   // qf, qq
         sizeof(float) * (size_t)g * S * 2 +   // part_a, part_b
         sizeof(float) * (size_t)S +           // score
         sizeof(int) * (size_t)S * 2 +         // cand_a, cand_b
         sizeof(float) * (size_t)g * k_max +   // lg
         sizeof(int) * (size_t)k_max +         // rowk
         sizeof(float) * 32;                   // red
}

}  // namespace

extern "C" {

size_t bgpp_paged_attend_smem_bytes(int g, int D, int S, int k_max) {
  return smem_bytes(g, D, S, k_max);
}

// Returns cudaGetLastError() after the launch.  `survivors` is a host array
// of `rounds` ints; `out_idx` may be null (else (B, Hk, k_max) int32).
int bgpp_paged_attend_launch(const void* q, const void* planes, const void* sign,
                             const void* k_scale, const void* v, const void* v_scale,
                             const void* phys, const void* pos, void* out, void* out_idx, int B,
                             int Hk, int g, int D, int S, int nbits, int rounds,
                             const void* survivors, int k_max, int query_bits,
                             long long pl_plane, long long pl_tok, long long pl_head,
                             long long v_tok, long long v_head, long long sc_tok,
                             long long sc_head, float scale, void* stream) {
  if (rounds < 1 || rounds > kMaxRounds || g > kMaxG || nbits > 8) return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.rounds = rounds;
  plan.k_max = k_max;
  for (int r = 0; r < kMaxRounds; ++r)
    plan.survivors[r] = r < rounds ? static_cast<const int*>(survivors)[r] : 0;
  const size_t smem = smem_bytes(g, D, S, k_max);
  cudaError_t e = cudaFuncSetAttribute(bgpp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  bgpp_kernel<<<B * Hk, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)planes, (const uint8_t*)sign, (const float*)k_scale,
      (const int8_t*)v, (const float*)v_scale, (const int*)phys, (const int*)pos, (float*)out,
      (int*)out_idx, Hk, g, D, S, nbits, query_bits, plan, pl_plane, pl_tok, pl_head, v_tok,
      v_head, sc_tok, sc_head, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
