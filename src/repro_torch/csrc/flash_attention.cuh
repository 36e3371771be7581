// What the flash-attention forward (flash_attention.cu) and its backward
// (flash_attention_bwd.cu) share: the mask predicates, and the tensor-core
// helpers of their bf16 bodies (cp.async staging, ldmatrix, mma.sync
// m16n8k16, the bf16 hi / lo split, the swizzled tile layout, ex2).
//
// Query position qi (row i of the queries plus q_offset) sees key position
// kj under: full (always), causal (kj <= qi), sliding (causal and
// qi - kj < w), chunked (causal and the same aligned chunk of w) and
// prefix_causal (causal, or both inside the first w positions).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// bf16 bodies: staging, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Stage the 16-byte chunk of bf16 row `row` that starts at column c0 into
// shared memory at dst: `valid` of its 8 columns lie inside the true D (the
// rest are zero; valid <= 0: all zero, nothing read).  `wide` rows go by
// cp.async (src-size zero-fills), others by element loads and one store.
// Only NARROW instances carry the element path and partial chunks: a
// launch whose rows are all 16-byte aligned and whose D is a multiple of
// 8 (every chunk whole or wholly past D) runs an instance without them.
// (Not NARROW: `row` already points at the chunk, c0 is unused.)
template <bool NARROW>
__device__ __forceinline__ void stage16(uint32_t dst, const __nv_bfloat16* row, int c0,
                                        int valid, bool wide) {
  if constexpr (!NARROW) {
    cp_async16(dst, row, valid > 0 ? 16 : 0);
    return;
  }
  if (wide) {
    const int bytes = valid <= 0 ? 0 : valid >= 8 ? 16 : 2 * valid;
    cp_async16(dst, bytes ? row + c0 : row, bytes);
    return;
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
  const unsigned short* p = reinterpret_cast<const unsigned short*>(row + c0);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < valid) w[e >> 1] |= (unsigned)__ldg(p + e) << (16 * (e & 1));
  st_shared16(dst, make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> bf16x2 p_hi and the bf16x2 rest p_lo = bf16(p - p_hi); the
// lower 16 bits hold x, the lower column of an mma A fragment.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// The chunk XOR of tile row r: rows are (rows, D) bf16, U = D / 8 chunks of
// 16 bytes each, and chunk c of row r is stored at chunk c ^ swz_mask(r).
// The 8 consecutive rows (from a multiple of 8) that one ldmatrix phase
// reads at one chunk then land in 8 distinct 16-byte bank groups.  With
// U < 8 a row spans U bank groups, so rows are swizzled in runs of 8 / U.
// The mask depends on r & 7 alone.
template <int D>
__device__ __forceinline__ int swz_mask(int r) {
  constexpr int U = D / 8;
  if constexpr (U >= 8) {
    return r & 7;
  } else {
    return (r / (8 / U)) & (U - 1);
  }
}

// Byte offset of chunk c of row r in a swizzled tile.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return 2 * (r * D + ((c ^ swz_mask<D>(r)) << 3));
}

// 2^x, a subnormal result flushed to 0 (a p below 2^-126 adds nothing at
// f32 to a row sum that holds a p of 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
