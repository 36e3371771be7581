// BRCR GEMM: out = w_q @ x through the bit-slice repetitiveness
// factorization, from the signed-plane group patterns of the int8 weight.
//
// Replaces: src/repro/kernels/brcr_gemm/kernel.py, brcr_gemm_pallas (body
//   _kernel): per signed plane p (+2^0..+2^6, then -2^0..-2^6) the MAV
//   Z = one-hot(patterns) @ x, then E @ Z, then +-2^p accumulation in f32;
//   (p, M tile, H tile) tiles whose patterns are all zero are skipped.
//
// What bounds it on the H100: bytes, on paper.  The patterns are one byte
// per (plane, group, column): 14 / m = 3.5 bytes a weight at m = 4, read
// once, against ~2 * N f32 adds a weight a column of x (the merge adds of
// the non-zero patterns, E @ Z and the accumulation), so at N <= 128 the
// bytes of the patterns set the bound.  This first kernel is far from it:
// its merge is a dependent chain of shared-memory read-modify-writes, one a
// non-zero pattern per column of x (PERF.md, K7).
//
// What the design does (the BRCR form, not the TPU's one-hot MXU
// contraction):
//   * one block per (32 group rows, up to 8 columns of x); the TPU's
//     sequential grid dimensions (plane, H tile) are loops inside the
//     block, so the block owns its output tile: no sum crosses blocks, no
//     atomics, and the result does not depend on scheduling;
//   * a lane owns one group row and a warp one column of x: for each H tile
//     of 256 columns the block stages the 32 x 256 pattern tile (words
//     where H allows, OR-ing them as it goes) and, unless the tile is all
//     zero (__syncthreads_or), the 256 x 8 tile of x as f32;
//   * merge: the lane walks its group row and adds x[h] to bin Z[c] of its
//     own 2^m-bin MAV in shared memory for every non-zero pattern c
//     (pattern 0 is free: E[:, 0] = 0); only that lane touches its bins,
//     so the bins need no atomics and the order of adds is fixed; bins are
//     padded to 2^m + 1 floats so the 32 lanes of a warp hit distinct banks;
//   * after the last H tile of a plane: reconstruct y_j = sum over c with
//     bit j of Z[c] (E @ Z, unrolled) and accumulate acc_j += +-2^p * y_j in
//     registers; a plane with no non-zero tile in the block skips this;
//   * M need only be a multiple of m, N and H may be any size: rows of
//     groups past G, columns past N and H are masked here (the Pallas
//     wrapper pads N and asserts tile-aligned M and H); x is read at its
//     strides as f32 or bf16, out written as f32.
// Integer x: every partial sum is an integer of at most sum|w*x|, so the
// result is exact while that stays below 2^24 per row.  Float x: the same
// sums in another order than the plain version.
// Simple and right first: no split over H or planes, no packed 4-bit
// pattern stream, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTG = 32;    // group rows a block: one a lane
constexpr int kTK = 256;   // columns of H a step
constexpr int kIdxRow = kTK + 4;  // padded pattern row (bytes): lanes on distinct banks

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int kM, int kTN, typename XT>
__global__ void __launch_bounds__(32 * kTN)
    brcr_gemm_kernel(const uint8_t* __restrict__ idx, const float* __restrict__ pw,
                     const XT* __restrict__ x, long long sx_h, long long sx_n,
                     float* __restrict__ out, long long so_m, long long so_n, int P, int G,
                     int H, int N) {
  constexpr int kBins = 1 << kM;
  constexpr int kThreads = 32 * kTN;
  __shared__ __align__(16) uint8_t idx_s[kTG][kIdxRow];
  __shared__ float x_s[kTN][kTK];
  __shared__ float z_s[kTN][kTG][kBins + 1];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g0 = blockIdx.x * kTG, n0 = blockIdx.y * kTN;
  const int g = g0 + lane, n = n0 + w;
  const bool mine = g < G && n < N;
  const bool words = (H & 3) == 0;  // 4-byte aligned pattern rows
  float* z = z_s[w][lane];

  float acc[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) acc[j] = 0.f;

  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int c = 0; c < kBins; ++c) z[c] = 0.f;
    bool plane_live = false;
    for (int h0 = 0; h0 < H; h0 += kTK) {
      __syncthreads();  // the last step's readers are done with idx_s / x_s
      unsigned any = 0;
      for (int i = tid; i < kTG * (kTK / 4); i += kThreads) {
        const int r = i / (kTK / 4), c4 = 4 * (i % (kTK / 4));
        const int gg = g0 + r, hh = h0 + c4;
        uint32_t v = 0;
        if (gg < G && hh < H) {
          const uint8_t* src = idx + ((long long)p * G + gg) * H + hh;
          if (words && hh + 4 <= H) {
            v = *reinterpret_cast<const uint32_t*>(src);
          } else {
            for (int e = 0; e < 4 && hh + e < H; ++e) v |= (uint32_t)src[e] << (8 * e);
          }
        }
        *reinterpret_cast<uint32_t*>(&idx_s[r][c4]) = v;
        any |= v;
      }
      if (!__syncthreads_or(any != 0)) continue;  // all-zero tile: no x, no adds
      plane_live = true;
      for (int i = tid; i < kTN * kTK; i += kThreads) {
        const int nn = i / kTK, hh = i % kTK;
        float v = 0.f;
        if (n0 + nn < N && h0 + hh < H) v = to_f(x[(h0 + hh) * sx_h + (n0 + nn) * sx_n]);
        x_s[nn][hh] = v;
      }
      __syncthreads();
      if (mine) {
        const int hmax = min(kTK, H - h0);
        for (int hh = 0; hh < hmax; hh += 4) {
          const uint32_t pk = *reinterpret_cast<const uint32_t*>(&idx_s[lane][hh]);
          if (!pk) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = (pk >> (8 * e)) & 0xff;
            if (c) z[c] += x_s[w][hh + e];
          }
        }
      }
    }
    if (plane_live && mine) {  // plane_live is the same in every thread
      float y[kM];
#pragma unroll
      for (int j = 0; j < kM; ++j) y[j] = 0.f;
#pragma unroll
      for (int c = 1; c < kBins; ++c) {
        const float zc = z[c];
#pragma unroll
        for (int j = 0; j < kM; ++j)
          if ((c >> j) & 1) y[j] += zc;
      }
      const float wp = pw[p];
#pragma unroll
      for (int j = 0; j < kM; ++j) acc[j] += wp * y[j];
    }
  }
  if (mine) {
#pragma unroll
    for (int j = 0; j < kM; ++j) out[((long long)g * kM + j) * so_m + n * so_n] = acc[j];
  }
}

struct Args {
  const uint8_t* idx;
  const float* pw;
  const void* x;
  long long sx_h, sx_n;
  float* out;
  long long so_m, so_n;
  int P, G, H, N;
};

template <int kM, int kTN, typename XT>
void launch_tn(const Args& a, cudaStream_t st) {
  const dim3 grid((a.G + kTG - 1) / kTG, (a.N + kTN - 1) / kTN);
  brcr_gemm_kernel<kM, kTN, XT><<<grid, 32 * kTN, 0, st>>>(
      a.idx, a.pw, (const XT*)a.x, a.sx_h, a.sx_n, a.out, a.so_m, a.so_n, a.P, a.G, a.H, a.N);
}

template <int kM, typename XT>
void launch_m(const Args& a, cudaStream_t st) {
  if (a.N <= 1)
    launch_tn<kM, 1, XT>(a, st);
  else if (a.N <= 2)
    launch_tn<kM, 2, XT>(a, st);
  else if (a.N <= 4)
    launch_tn<kM, 4, XT>(a, st);
  else
    launch_tn<kM, 8, XT>(a, st);
}

template <typename XT>
int launch_x(const Args& a, int m, cudaStream_t st) {
  if (m == 2)
    launch_m<2, XT>(a, st);
  else if (m == 4)
    launch_m<4, XT>(a, st);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// idx (P, G, H) uint8 contiguous; pw (P,) f32; x (H, N) at element strides
// (sx_h, sx_n), x_dtype 0 = f32, 1 = bf16; out (G*m, N) f32 at element
// strides (so_m, so_n); m in {2, 4}; N <= 65535 * 8 (the wrapper checks).
// Returns cudaGetLastError().
int brcr_gemm_launch(const void* idx, const void* pw, const void* x, int x_dtype,
                     long long sx_h, long long sx_n, void* out, long long so_m, long long so_n,
                     int P, int G, int H, int N, int m, void* stream) {
  if (G <= 0 || N <= 0) return 0;
  if (P < 0 || H < 0 || (N + 7) / 8 > 65535) return (int)cudaErrorInvalidValue;
  const Args a = {(const uint8_t*)idx, (const float*)pw, x, sx_h, sx_n, (float*)out,
                  so_m, so_n, P, G, H, N};
  cudaStream_t st = (cudaStream_t)stream;
  const int bad = x_dtype == 0 ? launch_x<float>(a, m, st)
                               : launch_x<__nv_bfloat16>(a, m, st);
  if (bad) return bad;
  return (int)cudaGetLastError();
}

}  // extern "C"
