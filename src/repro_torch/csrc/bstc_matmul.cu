// Fused BSTC decode + GEMV: out = (w_q @ x) [* scale] straight from the
// two-state-coded weight planes, for the decode step's few columns.
//
// Replaces: src/repro/kernels/bstc_matmul/kernel.py, bstc_matmul_pallas.
//
// What bounds it on the H100: bytes.  At decode x has N <= 8 columns (one
// per batch slot), so each weight element is used N times: 2N operations
// per ~1 byte of coded weight (sign + 7 magnitude planes, less what the
// coded planes save), far below the ~295 operations a byte the card needs
// before arithmetic is the limit.  The weight stays coded in device memory
// and is decoded in registers; nothing dense is ever written.
//
// What the design does about it:
//   * one warp per group row (m = 4 output rows), 4 warps a block; the
//     block's warps walk H together, 32 bitmap/plane/sign bytes (256
//     columns) at a time, a lane a byte, so every plane row is read once,
//     contiguously, and x's slice is staged once a block in shared memory
//     (padded one float in 32, so a lane's 8 columns hit distinct banks);
//   * x and out are strided: the decode step's activations are (N, H)
//     rows, read in place as x = a.T, and the result is written as the
//     (N, M) rows the next layer reads, so no copy surrounds a launch;
//   * coded planes: popcount + warp exclusive scan + the row's tile offset
//     give each set column its pattern slot (bstc_tile.cuh); the pattern's
//     m bits are the plane's bits of the m rows;
//   * raw planes and the sign: one byte a row a lane;
//   * |w| <= 127 is exact in f32, so w * x is exact for f32 and bf16 x and
//     the sums are the only rounding; the scale is applied once at the end,
//     as the reference's bstc_matmul_ref does;
//   * partial sums stay in registers, one warp reduction at the end.
// Simple and right first: no split over H, no tensor cores, no async copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bstc_tile.cuh"

namespace {

constexpr int kGroup = 4;        // BSTC/BRCR group m the kernel is built for
constexpr int kWarps = 4;        // group rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 256;      // columns a step: 32 lanes x 8 bits
constexpr int kChunkPad = kChunk + kChunk / 32;
constexpr int kMaxPlanes = 8;

struct Planes {
  const uint8_t* bitmap[kMaxPlanes];  // coded: (G, H/8)
  const int* offsets[kMaxPlanes];     // coded: (G, H/tile_k)
  const uint8_t* patterns[kMaxPlanes];  // coded: (G, cap)
  int cap[kMaxPlanes];
  int shift[kMaxPlanes];               // coded plane's index p
  const uint8_t* raw[kMaxPlanes];      // raw: (M, H/8)
  int raw_shift[kMaxPlanes];
  int n_enc, n_raw;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int pad(int c) { return c + (c >> 5); }

template <typename XT, int NB>
__global__ void __launch_bounds__(kThreads)
    bstc_matmul_kernel(Planes pl, const uint8_t* __restrict__ sign, const XT* __restrict__ x,
                       long long sx_h, long long sx_n, const float* __restrict__ scale,
                       float* __restrict__ out, long long so_m, long long so_n, int M, int H,
                       int N, int tile_k) {
  __shared__ float xs[NB][kChunkPad];
  const int lane = threadIdx.x & 31;
  const int G = M / kGroup;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = g < G;
  const int n0 = blockIdx.y * NB;
  const int nb = min(NB, N - n0);
  const int hb = H >> 3, tb = tile_k >> 3, n_tiles = H / tile_k;

  float acc[kGroup][NB];
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[r][n] = 0.f;
  int run[kMaxPlanes];

  for (int kt = 0; kt < n_tiles; ++kt) {
#pragma unroll
    for (int e = 0; e < kMaxPlanes; ++e)
      run[e] = (live && e < pl.n_enc) ? pl.offsets[e][(long long)g * n_tiles + kt] : 0;
    const int b_end = (kt + 1) * tb;
    for (int b0 = kt * tb; b0 < b_end; b0 += 32) {
      const int nbytes = min(32, b_end - b0);
      // stage x[8*b0 .. 8*b0 + 8*nbytes) x [n0, n0 + nb) (zeros past the edge)
      __syncthreads();
      for (int i = threadIdx.x; i < NB * kChunk; i += kThreads) {
        const int c = i % kChunk, n = i / kChunk;
        float v = 0.f;
        if (n < nb && c < 8 * nbytes) v = to_f(x[(8 * b0 + c) * sx_h + (n0 + n) * sx_n]);
        xs[n][pad(c)] = v;
      }
      __syncthreads();
      if (!live) continue;  // the block's barriers above stay uniform
      const bool ok = lane < nbytes;
      const long long b = b0 + lane;

      int mag[kGroup][8];
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) mag[r][j] = 0;

      // coded planes: warp-wide scan for the stream slots (all lanes join)
#pragma unroll
      for (int e = 0; e < kMaxPlanes; ++e) {
        if (e < pl.n_enc) {
          const unsigned bm = ok ? pl.bitmap[e][(long long)g * hb + b] : 0u;
          int total;
          const int excl = bstc::warp_exclusive_scan(__popc(bm), total);
          if (bm) {
            int patt[8];
            bstc::gather_byte(bm, run[e] + excl, pl.patterns[e] + (long long)g * pl.cap[e],
                              pl.cap[e], patt);
            const int s = pl.shift[e];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int r = 0; r < kGroup; ++r) mag[r][j] += ((patt[j] >> r) & 1) << s;
          }
          run[e] += total;
        }
      }
      if (!ok) continue;
      const long long row0 = (long long)g * kGroup;
      // raw planes
#pragma unroll
      for (int e = 0; e < kMaxPlanes; ++e) {
        if (e < pl.n_raw) {
          const int s = pl.raw_shift[e];
#pragma unroll
          for (int r = 0; r < kGroup; ++r) {
            const unsigned byte = pl.raw[e][(row0 + r) * hb + b];
#pragma unroll
            for (int j = 0; j < 8; ++j) mag[r][j] += ((byte >> j) & 1u) << s;
          }
        }
      }
      // x of the lane's 8 columns, then sign and the exact-integer FMAs
      float xv[8][NB];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int n = 0; n < NB; ++n) xv[j][n] = xs[n][pad(8 * lane + j)];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const unsigned sb = sign[(row0 + r) * hb + b];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float w = (float)(((sb >> j) & 1u) ? -mag[r][j] : mag[r][j]);
#pragma unroll
          for (int n = 0; n < NB; ++n) acc[r][n] = fmaf(w, xv[j][n], acc[r][n]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float v = acc[r][n];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(bstc::kFullMask, v, o);
      acc[r][n] = v;
    }
  if (lane < kGroup) {
    const int row = g * kGroup + lane;
    const float s = scale != nullptr ? scale[row] : 1.f;
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (r == lane)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          if (n < nb) out[row * so_m + (n0 + n) * so_n] = acc[r][n] * s;
  }
}

struct Strides {
  long long x_h, x_n, out_m, out_n;
};

template <typename XT, int NB>
void launch_nb(const Planes& pl, const uint8_t* sign, const void* x, const float* scale,
               float* out, const Strides& sd, int M, int H, int N, int tile_k,
               cudaStream_t st) {
  const int G = M / kGroup;
  dim3 grid((G + kWarps - 1) / kWarps, (N + NB - 1) / NB);
  bstc_matmul_kernel<XT, NB><<<grid, kThreads, 0, st>>>(pl, sign, (const XT*)x, sd.x_h, sd.x_n,
                                                         scale, out, sd.out_m, sd.out_n, M, H,
                                                         N, tile_k);
}

template <typename XT>
void launch_x(const Planes& pl, const uint8_t* sign, const void* x, const float* scale,
              float* out, const Strides& sd, int M, int H, int N, int tile_k,
              cudaStream_t st) {
  if (N <= 1)
    launch_nb<XT, 1>(pl, sign, x, scale, out, sd, M, H, N, tile_k, st);
  else if (N <= 2)
    launch_nb<XT, 2>(pl, sign, x, scale, out, sd, M, H, N, tile_k, st);
  else if (N <= 4)
    launch_nb<XT, 4>(pl, sign, x, scale, out, sd, M, H, N, tile_k, st);
  else
    launch_nb<XT, 8>(pl, sign, x, scale, out, sd, M, H, N, tile_k, st);
}

}  // namespace

extern "C" {

// desc: host array [n_enc, n_raw, then per coded plane (bitmap, offsets,
// patterns, cap, p), then per raw plane (plane, p)], pointers as integers.
// sign (M, H/8) u8; x (H, N) at element strides (x_h, x_n), x_dtype 0 =
// f32, 1 = bf16; scale (M,) f32 or null; out (M, N) f32 at element strides
// (out_m, out_n).  m = 4, M % 4 == 0, H % tile_k == 0, tile_k % 8 == 0 (the
// wrapper checks).  Returns cudaGetLastError().
int bstc_matmul_launch(const long long* desc, const void* sign, const void* x, int x_dtype,
                       long long x_h, long long x_n, const void* scale, void* out,
                       long long out_m, long long out_n, int M, int H, int N, int tile_k,
                       void* stream) {
  Planes pl = {};
  pl.n_enc = (int)desc[0];
  pl.n_raw = (int)desc[1];
  if (pl.n_enc < 0 || pl.n_raw < 0 || pl.n_enc + pl.n_raw > kMaxPlanes)
    return (int)cudaErrorInvalidValue;
  const long long* d = desc + 2;
  for (int e = 0; e < pl.n_enc; ++e, d += 5) {
    pl.bitmap[e] = (const uint8_t*)d[0];
    pl.offsets[e] = (const int*)d[1];
    pl.patterns[e] = (const uint8_t*)d[2];
    pl.cap[e] = (int)d[3];
    pl.shift[e] = (int)d[4];
  }
  for (int e = 0; e < pl.n_raw; ++e, d += 2) {
    pl.raw[e] = (const uint8_t*)d[0];
    pl.raw_shift[e] = (int)d[1];
  }
  cudaStream_t st = (cudaStream_t)stream;
  const Strides sd = {x_h, x_n, out_m, out_n};
  if (x_dtype == 0)
    launch_x<float>(pl, (const uint8_t*)sign, x, (const float*)scale, (float*)out, sd, M, H,
                    N, tile_k, st);
  else
    launch_x<__nv_bfloat16>(pl, (const uint8_t*)sign, x, (const float*)scale, (float*)out, sd,
                            M, H, N, tile_k, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
