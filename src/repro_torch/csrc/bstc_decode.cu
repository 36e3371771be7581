// BSTC plane decode: packed indicator bitmap + pattern stream -> the
// (G, H) uint8 group-pattern tensor (BRCR's input format).
//
// Replaces: src/repro/kernels/bstc_decode/kernel.py, bstc_decode_pallas.
//
// What bounds it on the H100: bytes.  Per group row it reads H/8 bitmap
// bytes, its nnz pattern bytes and one offset a tile, and writes H pattern
// bytes; a popcount, a warp scan and one gather a column are far below the
// card's arithmetic rate.
//
// What the design does about it: one block of 8 warps per (8 group rows,
// H tile); a warp owns one group row and walks the tile 32 bitmap bytes
// (256 columns) at a time, a lane a byte.  Bitmap reads and the 8-byte
// pattern stores of a warp are contiguous; the pattern gathers of a warp
// fall in one short run of its row's stream.  The output is integer and
// bit-identical to the plain version (bstc_tile.cuh states the addressing).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bstc_tile.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per group row
constexpr int kThreads = 32 * kRowsPerBlock;

__global__ void __launch_bounds__(kThreads)
    bstc_decode_kernel(const uint8_t* __restrict__ bitmap, const int* __restrict__ offsets,
                       const uint8_t* __restrict__ patterns, uint8_t* __restrict__ out, int G,
                       int H, int tile_k, int cap) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (g >= G) return;  // whole warp: no block-wide barrier below
  const int kt = blockIdx.y;
  const int n_tiles = H / tile_k;
  const int hb = H >> 3, tb = tile_k >> 3;
  const uint8_t* bm_row = bitmap + (long long)g * hb;
  const uint8_t* stream = patterns + (long long)g * cap;
  uint8_t* out_row = out + (long long)g * H;
  int run = offsets[(long long)g * n_tiles + kt];
  const int b_end = (kt + 1) * tb;
  for (int b0 = kt * tb; b0 < b_end; b0 += 32) {
    const int b = b0 + lane;
    const bool ok = b < b_end;
    const unsigned bm = ok ? bm_row[b] : 0u;
    int total;
    const int excl = bstc::warp_exclusive_scan(__popc(bm), total);
    if (ok) {
      int patt[8];
      bstc::gather_byte(bm, run + excl, stream, cap, patt);
      unsigned long long packed = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) packed |= (unsigned long long)patt[j] << (8 * j);
      *reinterpret_cast<unsigned long long*>(out_row + 8LL * b) = packed;
    }
    run += total;
  }
}

}  // namespace

extern "C" {

// bitmap (G, H/8) u8, offsets (G, H/tile_k) i32, patterns (G, cap) u8 ->
// out (G, H) u8.  Returns cudaGetLastError() after the launch.
int bstc_decode_launch(const void* bitmap, const void* offsets, const void* patterns, void* out,
                       int G, int H, int tile_k, int cap, void* stream) {
  dim3 grid((G + kRowsPerBlock - 1) / kRowsPerBlock, H / tile_k);
  bstc_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bitmap, (const int*)offsets, (const uint8_t*)patterns, (uint8_t*)out, G,
      H, tile_k, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
