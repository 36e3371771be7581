// Two-state (BSTC) tile decode shared by bstc_decode.cu (K4) and
// bstc_matmul.cu (K3).
//
// A coded plane of an (M, H) weight is grouped into G = M/m rows.  Row g
// has an indicator bitmap (H bits, 8:1 packed little-endian: bit j of byte
// b is column 8b+j), a stream of the patterns of its non-zero columns in
// column order (one byte each, cap bytes a row), and, per H tile of tile_k
// columns, the count of set bits before the tile (the tile's offset into
// the stream).  Column h's pattern sits at
//     tile_offset + (set bits of the tile before h)
// which is the reference's cumsum(bitmap)[h] - 1.  Out-of-range positions
// clamp to cap-1, and columns whose bit is 0 decode to pattern 0.
//
// The decode walks a row one warp at a time, one bitmap byte (8 columns)
// per lane: a popcount per lane and a warp-wide exclusive scan give each
// lane the stream slot of its first set column.

#pragma once

#include <stdint.h>

namespace bstc {

constexpr unsigned kFullMask = 0xffffffffu;

// Exclusive prefix sum of `v` over the 32 lanes of the warp; `total` gets
// the sum over all lanes.  Every lane of the warp must call it.
__device__ __forceinline__ int warp_exclusive_scan(int v, int& total) {
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += t;
  }
  total = __shfl_sync(kFullMask, incl, 31);
  return incl - v;
}

// Patterns of the 8 columns of one bitmap byte `bm`; `first` is the stream
// slot of the byte's first set column, `row` the group row's stream.
__device__ __forceinline__ void gather_byte(unsigned bm, int first,
                                            const uint8_t* __restrict__ row, int cap,
                                            int (&patt)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int pos = first + __popc(bm & ((1u << j) - 1u));
    pos = min(max(pos, 0), cap - 1);
    patt[j] = ((bm >> j) & 1u) ? (int)row[pos] : 0;
  }
}

}  // namespace bstc
