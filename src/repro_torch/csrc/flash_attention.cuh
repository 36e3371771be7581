// The mask predicates shared by the flash-attention forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu).
//
// Query position qi (row i of the queries plus q_offset) sees key position
// kj under: full (always), causal (kj <= qi), sliding (causal and
// qi - kj < w), chunked (causal and the same aligned chunk of w) and
// prefix_causal (causal, or both inside the first w positions).

#pragma once

namespace {

constexpr float kNegInf = -1e30f;  // repro.core.attention.NEG_INF

enum MaskKind { kFull = 0, kCausal = 1, kSliding = 2, kChunked = 3, kPrefix = 4 };

// Does query position qi see key position kj?
__device__ __forceinline__ bool visible(int mask, int w, int qi, int kj) {
  if (mask == kFull) return true;
  const bool causal = kj <= qi;
  if (mask == kCausal) return causal;
  if (mask == kSliding) return causal && qi - kj < w;
  if (mask == kPrefix) return causal || (qi < w && kj < w);
  return causal && qi / w == kj / w;
}

// Does the tile of query positions [q_lo, q_hi] x keys [k_lo, k_hi] hold a
// visible pair?  The union of the rows' visible key ranges is one interval
// ([q_lo - w + 1, q_hi] sliding, [q_lo / w * w, q_hi] chunked, [0,
// max(q_hi, w - 1)] prefix_causal when q_lo < w), so the test is exact.
__device__ __forceinline__ bool tile_live(int mask, int w, int q_lo, int q_hi, int k_lo,
                                          int k_hi) {
  if (mask == kFull) return true;
  if (mask == kPrefix) return k_lo <= q_hi || (k_lo < w && q_lo < w);
  if (k_lo > q_hi) return false;
  if (mask == kCausal) return true;
  if (mask == kSliding) return k_hi >= q_lo - w + 1;
  return k_hi / w >= q_lo / w;
}

// Does every query position of [q_lo, q_hi] see every key of [k_lo, k_hi]?
__device__ __forceinline__ bool tile_whole(int mask, int w, int q_lo, int q_hi, int k_lo,
                                           int k_hi) {
  if (mask == kFull) return true;
  if (mask == kPrefix) return k_hi <= q_lo || (q_lo < w && k_hi < w);
  if (k_hi > q_lo) return false;
  if (mask == kCausal) return true;
  if (mask == kSliding) return q_hi - k_lo < w;
  return k_lo / w == q_hi / w;
}

}  // namespace
