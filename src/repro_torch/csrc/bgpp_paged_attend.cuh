// Device helpers shared by the fused BGPP decode's two bodies: the
// single-cluster kernel (bgpp_paged_attend.cu) and the body whose selection
// spans blocks (bgpp_paged_attend_long.cu): the shared-memory header, the
// query's quantisation and bit masks, plane-row loads, the popcount plane
// dot, the bit transpose and the sign-magnitude dp4a of the exact attend.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr float kNegInf = -1e30f;  // repro.core.attention.NEG_INF
constexpr int kThreads = 256;      // kernel.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kNbits = 7;       // magnitude planes (the sign is an eighth)
constexpr int kMaxLists = 8;    // rounds (at most kNbits) + the final list
constexpr int kUnroll = 4;      // rows a thread has in flight
constexpr int kMaxDevices = 64;
// Shared-memory header (bytes; kernel.py `header_bytes`): the query's int8
// codes (kMaxG, max(DP, 128)), its bit masks (kMaxG, 8, MW) u32 (planes
// 0..6 of the truncated magnitude, then the sign; MW = max(4, DP / 32)),
// then 136 words: the block's partial and the cluster-wide max, sum and w
// max of each g row, the query scales, the warps' scratch and the plan's
// list widths and caps.  2592 bytes up to DP 128, 4640 at DP 256.
template <int DP>
struct Header {
  static constexpr int MW = DP > 128 ? DP / 32 : 4;  // mask words a plane
  static constexpr int kCodes = 0, kMasks = kMaxG * (DP > 128 ? DP : 128),
                       kFloats = kMasks + kMaxG * 8 * MW * 4, kBytes = kFloats + 544;
};
constexpr int kPMax = 0, kPSum = 8, kPW = 16, kGMax = 24, kGSum = 32, kGW = 40, kQScale = 48,
              kScratch = 56,  // + kWarps * kMaxG = 120
              kWidths = 120;  // + 2 * kMaxLists ints (the plan) = 136 words

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Words of a packed plane row at the compiled width DP (D 16: the low half
// of one word).
template <int DP>
__host__ __device__ constexpr int row_words() {
  return DP >= 32 ? DP / 32 : 1;
}

// The first W words of the nb bytes at p, which may start on any byte
// (the bytes past nb read as zero): the aligned words that hold them, each
// pair funnel-shifted into place.  The aligned word after the last byte is
// not read; the last one read may hold a few bytes past nb, never outside
// its own aligned word.
template <int W>
__device__ __forceinline__ void load_words(const uint8_t* p, unsigned (&w)[W], int nb) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const unsigned* base = reinterpret_cast<const unsigned*>(at & ~(uintptr_t)3);
  const int off = (int)(at & 3);
  unsigned a[W + 1];
#pragma unroll
  for (int k = 0; k <= W; ++k) a[k] = 4 * k < off + nb ? __ldg(base + k) : 0u;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const int v = nb - 4 * c;  // bytes of word c inside the row
    const unsigned keep = v >= 4 ? ~0u : v <= 0 ? 0u : (1u << (8 * v)) - 1u;
    w[c] = __funnelshift_r(a[c], a[c + 1], 8 * off) & keep;
  }
}

// One packed plane row in words.  `wide`: the row is the compiled width's
// DP/8 bytes on a boundary of that many (16 at most), one or two vector
// loads; else the true nb = D/8 bytes at any alignment (load_words).
template <int DP>
__device__ __forceinline__ void load_row(const uint8_t* p, unsigned (&w)[row_words<DP>()],
                                         bool wide, int nb) {
  if (!wide) {
    load_words(p, w, nb);
  } else if constexpr (DP >= 128) {
#pragma unroll
    for (int c = 0; c < DP / 128; ++c) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + c);
      w[4 * c] = r.x, w[4 * c + 1] = r.y, w[4 * c + 2] = r.z, w[4 * c + 3] = r.w;
    }
  } else if constexpr (DP == 64) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = r.x, w[1] = r.y;
  } else if constexpr (DP == 32) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// Bytes [4c, 4c + 4) of a plane row (DP 16: [0, 2)).
template <int DP>
__device__ __forceinline__ unsigned load_chunk(const uint8_t* row, int c, bool wide, int nb) {
  if (!wide) {
    unsigned w[1];
    load_words(row + 4 * c, w, nb - 4 * c);
    return w[0];
  }
  if constexpr (DP == 16) return __ldg(reinterpret_cast<const unsigned short*>(row));
  else return __ldg(reinterpret_cast<const unsigned*>(row) + c);
}

// Signed plane dot of one packed row against the truncated query of each
// g row: sum_d qf[gi][d] * (k_d ? (s_d ? -1 : 1) : 0), as integers.
// masks: (kMaxG, 8, MW) words, plane p of |qf| at [gi][p], sign at [gi][7];
// only planes qlo.. of the query are nonzero.
template <int G, int W, int MW>
__device__ __forceinline__ void plane_dot(const unsigned* masks, int g, int qlo,
                                          const unsigned (&kb)[W], const unsigned (&ks)[W],
                                          int (&acc)[G]) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    acc[gi] = 0;
    if (gi >= g) continue;
    const unsigned* m = masks + gi * 8 * MW;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const unsigned x = m[7 * MW + w] ^ ks[w];
      const unsigned pm = kb[w] & ~x, nm = kb[w] & x;
      for (int p = qlo; p < kNbits; ++p) {
        const unsigned qp = m[MW * p + w];
        acc[gi] += (__popc(qp & pm) - __popc(qp & nm)) << p;
      }
    }
  }
}

// 8 x 8 bit transpose (three delta swaps): lo / hi hold rows 0-3 / 4-7, a
// byte each with bit c = column c; on return they hold columns 0-3 / 4-7, a
// byte each with bit p = row p.  (The same as bstc_matmul.cu's.)
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

// Four sign-magnitude bytes (bit 7 the sign) dotted with four int8 query
// codes: the magnitudes with the negative ones complemented (-1 - m as a
// signed byte), less the complement masks (-1 each), is the signed value.
__device__ __forceinline__ int sm_dot(unsigned x, int q) {
  const unsigned neg = ((x >> 7) & 0x01010101u) * 0xFFu;
  return __dp4a((int)((x & 0x7F7F7F7Fu) ^ neg), q, 0) - __dp4a((int)neg, q, 0);
}

// A final survivor's exact dot over chunk `ch` of its rows (CB bytes of each
// plane row: P[0..6] the magnitude planes, P[7] the sign): each 8 columns
// rebuilt to sign-magnitude bytes by a bit transpose, then dp4a with the
// query codes of each g row, added to dot[gi].
template <int G, int DP, int CB>
__device__ __forceinline__ void chunk_dot(const unsigned (&P)[8], int ch, const int8_t* codes,
                                          int g, int (&dot)[G]) {
#pragma unroll
  for (int grp = 0; grp < CB; ++grp) {  // 8 columns: planes 0..6 + sign -> bytes
    const unsigned s = grp | ((grp + 4) << 4);
    unsigned lo = __byte_perm(__byte_perm(P[0], P[1], s), __byte_perm(P[2], P[3], s), 0x5410);
    unsigned hi = __byte_perm(__byte_perm(P[4], P[5], s), __byte_perm(P[6], P[7], s), 0x5410);
    transpose8(lo, hi);
    const int col = ch * 8 * CB + 8 * grp;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= g) continue;
      const int* qw = reinterpret_cast<const int*>(codes + gi * DP + col);
      dot[gi] += sm_dot(lo, qw[0]) + sm_dot(hi, qw[1]);
    }
  }
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

// A2: quantise the g query rows at qb over their true Dt (codes past it are
// 0) into codes (kMaxG, DP), their scales into qscale[gi], then the
// truncated magnitudes' bit masks into masks (kMaxG, 8, MW).  Ends on a
// block barrier.
template <int DP>
__device__ __forceinline__ void quantise_query(const float* qb, int g, int Dt, int query_bits,
                                               int8_t* codes, unsigned* masks, float* qscale) {
  constexpr int MW = Header<DP>::MW;
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  if (tid < 32) {
    for (int gi = 0; gi < g; ++gi) {
      float m = 0.f;
      for (int d = tid; d < Dt; d += 32) m = fmaxf(m, fabsf(qb[gi * Dt + d]));
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (tid == 0) qscale[gi] = fmaxf(m, 1e-8f) / 127.0f;
    }
  }
  __syncthreads();
  for (int i = tid; i < g * DP; i += kThreads) {
    const int gi = i / DP, d = i - gi * DP;
    codes[i] = d < Dt ? (int8_t)fminf(fmaxf(rintf(qb[gi * Dt + d] / qscale[gi]), -127.f), 127.f)
                      : (int8_t)0;
  }
  __syncthreads();
  const int qlo = max(kNbits - query_bits, 0);  // the query keeps planes qlo..6
  for (int t = warp; t < g * MW; t += kWarps) {  // (g row, word): a warp's ballots
    const int gi = t / MW, w = t % MW, d = 32 * w + lane_id;
    const int c = d < DP ? (int)codes[gi * DP + d] : 0;
    const int mag = abs(c) >> qlo << qlo;
#pragma unroll
    for (int pl = 0; pl < kNbits; ++pl) {
      const unsigned bits = __ballot_sync(0xffffffffu, (mag >> pl) & 1);
      if (lane_id == 0) masks[gi * 8 * MW + MW * pl + w] = bits;
    }
    const unsigned neg = __ballot_sync(0xffffffffu, c < 0);
    if (lane_id == 0) masks[gi * 8 * MW + 7 * MW + w] = neg;
  }
  __syncthreads();
}

}  // namespace
