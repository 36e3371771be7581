// BSTC plane decode: packed indicator bitmap + pattern stream -> the
// (G, H) uint8 group-pattern tensor (BRCR's input format).
//
// Replaces: src/repro/kernels/bstc_decode/kernel.py, bstc_decode_pallas.
//
// What bounds it on the H100: latency, then bytes.  Per group row it reads
// H/8 bitmap bytes, its pattern stream and one offset a tile, and writes H
// pattern bytes; a popcount, a warp scan and one gather a column are far
// below the card's arithmetic rate.  A row is only a few KB, so what a
// warp waits on between its loads is what sets the time.
//
// What the design does about it (kernel.py ``plan`` gives the geometry):
//   * one warp per (group row, segment of whole H tiles): the prepared tile
//     offsets give each segment its stream slot, so segments of a row
//     decode on their own (with one tile a row, a row is one segment);
//   * each lane takes 16 bitmap bytes (128 columns) in one 16-byte load, so
//     a warp covers 4096 columns a pass; longer segments loop with the
//     carried total, the next pass's load issued before this pass's
//     gathers;
//   * a block holds ``R`` rows and copies their pattern streams (``cap``
//     bytes a row) into shared memory with ``cp.async`` (16 bytes a copy
//     where cap allows), issued together with each warp's first bitmap
//     load; the gathers then read shared memory;
//   * per lane: popcounts of its four 32-bit words, one warp exclusive
//     scan, then its 128 columns written as eight 16-byte stores; a bitmap
//     byte's 8 patterns are the 8 stream bytes from its first slot (three
//     aligned 32-bit shared loads, two funnel shifts), placed by two byte
//     permutes whose selectors and masks come from a 16-entry table of
//     nibbles, about 2.5 instructions a column.
// Rows that do not allow 16-byte loads (H or tile_k not a multiple of 128,
// or unaligned pointers) take the byte-wise instance of the same code.
// The output is integer and bit-identical to the plain version, including
// the clamp of an out-of-range stream slot to cap - 1 and pattern 0 where
// the bit is 0 (bstc_tile.cuh states the addressing).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bstc_tile.cuh"

namespace {

constexpr int kStride = 4096;  // columns a warp decodes a pass (kernel.py STRIDE)
constexpr int kMaxWarps = 16;  // warps a block (kernel.py MAX_WARPS)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy `rows` pattern rows of `cap` bytes (global row stride cap) into
// shared rows of `cap_s` bytes, `copy` bytes a copy (16, 8, 4 by cp.async;
// 1 by plain loads), every thread of the block taking its share.
__device__ __forceinline__ void copy_streams(uint8_t* smem, const uint8_t* __restrict__ src,
                                             int rows, int cap, int cap_s, int copy) {
  const int per_row = cap / copy;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * copy;
    uint8_t* d = smem + r * cap_s + c;
    const uint8_t* s = src + (long long)r * cap + c;
    if (copy == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(d)), "l"(s)
                   : "memory");
    } else if (copy == 8) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(d)), "l"(s)
                   : "memory");
    } else if (copy == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(d)), "l"(s)
                   : "memory");
    } else {
      *d = *s;
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The lane's 16 bitmap bytes of the pass starting at column `cs`, zero
// past the segment's end `c1`.
template <bool kWide>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ bm_row, long long cs,
                                            long long c1, int lane) {
  const long long b = (cs >> 3) + 16 * lane, e = c1 >> 3;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (kWide) {
    if (b < e) v = __ldg(reinterpret_cast<const uint4*>(bm_row + b));
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (b + i < e) w[i >> 2] |= (uint32_t)bm_row[b + i] << (8 * (i & 3));
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return v;
}

// Rank selectors and byte masks of a 4-bit nibble of the bitmap, for
// __byte_perm: nibble n's selector holds, for each of its 4 columns c, the
// count of set bits of n below c (a byte index into the stream bytes at the
// nibble's first slot); its mask keeps byte c where bit c is set.
struct NibbleTable {
  uint2 e[16];  // (selector, mask)
};

__device__ __forceinline__ void fill_table(NibbleTable& t) {
  if (threadIdx.x < 16) {
    const uint32_t n = threadIdx.x;
    uint32_t sel = 0u, mask = 0u, r = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sel |= r << (4 * c);
      if ((n >> c) & 1u) {
        mask |= 0xffu << (8 * c);
        ++r;
      }
    }
    t.e[n] = make_uint2(sel, mask);
  }
}

// The lane's 8 output words (32 columns) of bitmap word `w` from stream
// slot `p` on, when every set column's slot lies in [0, cap): per
// bitmap byte, the 8 stream bytes from its first slot come from three
// aligned 32-bit shared loads and two funnel shifts, and two byte
// permutes with the nibbles' selectors place them (masked where the bit
// is 0).  `s32` is the row's stream as words, padded by 16 bytes.
__device__ __forceinline__ void gather_fast(uint32_t w, int& p, const uint32_t* s32,
                                            const NibbleTable& t, uint32_t (&o)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bitmap byte i of the word: 8 columns
    const uint32_t bm = (w >> (8 * i)) & 0xffu;
    const int a = p >> 2;
    const uint32_t sh = (uint32_t)(p & 3) * 8u;
    const uint32_t x0 = s32[a], x1 = s32[a + 1], x2 = s32[a + 2];
    const uint32_t lo = __funnelshift_r(x0, x1, sh), hi = __funnelshift_r(x1, x2, sh);
    const uint2 t0 = t.e[bm & 15u], t1 = t.e[bm >> 4];
    o[2 * i] = __byte_perm(lo, 0u, t0.x) & t0.y;
    o[2 * i + 1] = __byte_perm(lo, hi, t1.x + (uint32_t)__popc(bm & 15u) * 0x1111u) & t1.y;
    p += __popc(bm);
  }
}

// The same 32 columns a column at a time, every slot clamped to
// [0, cap - 1] as the plain version clamps it (only operands whose
// offsets or patterns disagree with the bitmap get here).
__device__ __forceinline__ void gather_clamped(uint32_t w, int& p, const uint8_t* s, int cap,
                                               uint32_t (&o)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint32_t word = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t bit = (w >> (4 * q + c)) & 1u;
      const uint32_t b = s[min(max(p, 0), cap - 1)];
      word |= (b & (0u - bit)) << (8 * c);
      p += (int)bit;
    }
    o[q] = word;
  }
}

// Decode the lane's 128 columns of one pass (bitmap words `v`, pass start
// column `cs`, segment end `c1`) from the row's shared stream `s`; `run` is
// the stream slot of the pass's first column.  Returns the next pass's.
template <bool kWide>
__device__ __forceinline__ int decode_pass(uint4 v, int run, long long cs, long long c1,
                                           const uint8_t* s, int cap, const NibbleTable& t,
                                           uint8_t* __restrict__ out_row, int lane) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const int count = __popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]);
  int total;
  const int excl = bstc::warp_exclusive_scan(count, total);
  const long long col = cs + 128LL * lane;
  if (col < c1) {
    int p = run + excl;  // stream slot of the lane's next set column
    const bool fast = p >= 0 && p + count <= cap;
    uint8_t* dst = out_row + col;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // 32 columns: two 16-byte stores
      uint32_t o[8];
      if (fast) {
        gather_fast(w[k], p, reinterpret_cast<const uint32_t*>(s), t, o);
      } else {
        gather_clamped(w[k], p, s, cap, o);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = 32 * k + 16 * h;
        if (kWide) {
          *reinterpret_cast<uint4*>(dst + at) =
              make_uint4(o[4 * h], o[4 * h + 1], o[4 * h + 2], o[4 * h + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (col + at + i < c1)
              dst[at + i] = (uint8_t)(o[4 * h + (i >> 2)] >> (8 * (i & 3)));
        }
      }
    }
  }
  return run + total;
}

struct Args {
  const uint8_t* bitmap;   // (G, H/8)
  const int* offsets;      // (G, H/tile_k)
  const uint8_t* patterns;  // (G, cap)
  uint8_t* out;            // (G, H)
  int G, H, tile_k, cap;
  int R, WR, tps, NS, cap_s, copy;  // kernel.py plan
};

template <bool kWide>
__global__ void __launch_bounds__(32 * kMaxWarps) bstc_decode_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ NibbleTable table;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp / a.WR, sw = warp - r * a.WR;
  const int g0 = blockIdx.x * a.R, g = g0 + r;
  const int n_tiles = a.H / a.tile_k;
  const long long hb = a.H >> 3;
  const uint8_t* bm_row = a.bitmap + (long long)g * hb;
  uint8_t* out_row = a.out + (long long)g * a.H;
  const bool busy = g < a.G && sw < a.NS;
  // the first segment's offset and bitmap pass, in flight with the copy
  int seg = sw, run = 0;
  long long c0 = 0, c1 = 0;
  uint4 cur = make_uint4(0u, 0u, 0u, 0u);
  if (busy) {
    c0 = (long long)seg * a.tps * a.tile_k;
    c1 = min((long long)(seg + 1) * a.tps * a.tile_k, (long long)a.H);
    run = __ldg(a.offsets + (long long)g * n_tiles + seg * a.tps);
    cur = load_chunk<kWide>(bm_row, c0, c1, lane);
  }
  fill_table(table);
  copy_streams(smem, a.patterns + (long long)g0 * a.cap, min(a.R, a.G - g0), a.cap, a.cap_s,
               a.copy);
  __syncthreads();
  if (!busy) return;  // whole warps: no barrier below
  const uint8_t* s = smem + r * a.cap_s;
  while (true) {
    for (long long cs = c0; cs < c1; cs += kStride) {
      const uint4 nxt = cs + kStride < c1 ? load_chunk<kWide>(bm_row, cs + kStride, c1, lane)
                                          : make_uint4(0u, 0u, 0u, 0u);
      run = decode_pass<kWide>(cur, run, cs, c1, s, a.cap, table, out_row, lane);
      cur = nxt;
    }
    seg += a.WR;
    if (seg >= a.NS) break;
    c0 = (long long)seg * a.tps * a.tile_k;
    c1 = min((long long)(seg + 1) * a.tps * a.tile_k, (long long)a.H);
    run = __ldg(a.offsets + (long long)g * n_tiles + seg * a.tps);
    cur = load_chunk<kWide>(bm_row, c0, c1, lane);
  }
}

template <bool kWide>
int launch(const Args& a, int blocks, int smem, cudaStream_t stream) {
  if (smem > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        bstc_decode_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return (int)err;
  }
  bstc_decode_kernel<kWide><<<blocks, 32 * a.R * a.WR, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bitmap (G, H/8) u8, offsets (G, H/tile_k) i32, patterns (G, cap) u8 ->
// out (G, H) u8.  plan = kernel.py Plan: rows a block R, warps a row WR,
// tiles a segment tps, segments a row NS, shared row bytes cap_s, copy
// bytes, 16-byte rows (wide), blocks, shared memory bytes.  Returns
// cudaGetLastError() after the launch.
int bstc_decode_launch(const void* bitmap, const void* offsets, const void* patterns, void* out,
                       int G, int H, int tile_k, int cap, int R, int WR, int tps, int NS,
                       int cap_s, int copy, int wide, int blocks, int smem, void* stream) {
  if (G <= 0) return 0;
  if (H <= 0 || H % 8 || tile_k <= 0 || H % tile_k || tile_k % 8 || cap <= 0 || R <= 0 ||
      WR <= 0 || R * WR > kMaxWarps || tps <= 0 || NS <= 0 || cap_s < cap + 12 || cap_s % 16 ||
      (copy != 16 && copy != 8 && copy != 4 && copy != 1) || cap % copy ||
      (long long)blocks * R < G)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)bitmap, (const int*)offsets, (const uint8_t*)patterns,
               (uint8_t*)out, G, H, tile_k, cap, R, WR, tps, NS, cap_s, copy};
  return wide ? launch<true>(a, blocks, smem, (cudaStream_t)stream)
              : launch<false>(a, blocks, smem, (cudaStream_t)stream);
}

}  // extern "C"
