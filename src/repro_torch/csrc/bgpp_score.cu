// One BGPP round: the masked bit-plane score of every key for every query
// row, out[r, s] = alive[r, s] ? sum_d q[r, d] * (1 - 2 sign[s, d]) * bit[s, d] : 0,
// in int32 (wrapping as the reference's int32 sum does).
//
// Replaces: src/repro/kernels/bgpp_score/kernel.py, bgpp_score_pallas
//   (body _kernel): a key tile with no alive key skips both its plane fetch
//   and its adds (the paper's early termination); live tiles score every
//   key and mask by alive.
//
// What bounds it on the H100: bytes, once the arithmetic is per word.  A
// live key costs D/8 plane bytes and D/8 sign bytes (32 bytes at D 128);
// the alive flags (one byte a row and key) and the scores (four) are read
// and written once whatever the data.  The first design (one block per
// query row and 128-key tile, one key a thread, a branchless negate-add
// per bit) fell short of that in four ways, and this one answers each:
//   * the g rows of a kv head each re-read the kv head's planes -> one
//     block per (slot, kv head, key tile) scores all g rows of the group,
//     the tile's plane and sign rows staged once in shared memory;
//   * one key a thread, each load 4 bytes of a row 128 bytes from the next
//     -> 16-byte cp.async copies of whole rows, neighbouring threads on
//     neighbouring chunks and keys; a key that no row of the group needs is
//     not copied, and a tile that no row needs reads no plane byte (its
//     scores are written as zeros);
//   * ~5 integer instructions a bit -> word arithmetic: each row's q is
//     split once, in the block, into a sign mask sq (one bit a d) and the
//     bit planes M_j of |q| as unsigned, only the planes set in some |q|
//     of the row (4 for the predictor's MSB-truncated q), one (row, word)
//     a warp by ballots.  A 32-dim word then adds sum_j 2^j (popc(M_j & b)
//     - 2 popc(M_j & b & (s ^ sq))): two popcounts a plane and word, exact
//     modulo 2^32 for any int32 q (INT_MIN's magnitude is plane 31 alone).
//     A warp pass whose keys no row of the group needs (most of a live
//     tile after round 0) scores nothing and writes zeros;
//   * the alive flags and the scores move 16 bytes a thread where the rows
//     allow (S a multiple of 16): a dead tile costs one load and a few
//     stores a thread;
//   * a 65,535-row grid limit and 32 blocks for the one-query walkthrough
//     -> a one-dimensional grid of (slot, tile, kv head), the kv heads of
//     a tile adjacent (their rows share 32-byte sectors of the batched
//     layout); LPK = min(4, words a row) lanes share a key's words (their
//     sums meet by shuffles), so a 128-thread block takes 128 / LPK keys a
//     pass, and kernel.py `plan` gives a block KPT passes (1..8): the
//     largest tile that still leaves four blocks an SM (S 4096, one query:
//     128 blocks of 32 keys; S 32768 at the decode geometry: 256 keys).
// Not taken: the int8 tensor cores (mma m16n8k32 with +-1/0 operands built
// from the bits).  q may be any int32 (the wrapper takes it), which int8
// operands hold only as four byte planes; a group's g rows (3 at the
// decode geometry) fill 3 of the mma's 16 rows; and brcr_gemm.cu's one-hot
// MAV is bound by building its operands from bits, not by the mma.
// Integer arithmetic throughout: the result equals the plain version bit
// for bit, and two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // kernel.py THREADS
constexpr int kPlanes = 32;    // bit planes of |q| as a 32-bit unsigned

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

struct Args {
  const int* q;          // (Q, D) int32, row r = head r % hq of batch r / hq
  const uint8_t* plane;  // rows of Dp bytes at (batch, token, head) strides
  const uint8_t* sign;
  const uint8_t* alive;  // (Q, S) bool
  int* out;              // (Q, S) int32
  int S, D, Dp, hq, hk, g;
  int WP, LPK, TS, tiles;  // kernel.py plan: words a staged row, lanes a key, keys a tile
  int wide;                // every plane / sign row start 16-byte aligned and Dp % 16 == 0
  int vec;                 // S % 16 == 0 and alive 16-byte aligned: 16-byte alive / score rows
  long long pb, ps, ph, sb, ss, sh;
};

constexpr int kQRows = 1, kQWords = 4;  // q held in registers: rows a warp, words a row
constexpr int kMinBlocks = 12;          // blocks an SM the registers are bounded for

__device__ __forceinline__ unsigned magnitude(int v) {
  return v < 0 ? 0u - (unsigned)v : (unsigned)v;
}

// Split words [w0, w0 + nw) of one row's q (one warp, lane d holding dim
// 32 (w0 + w) + d in v[w]; dims past D hold 0) given `used`, the OR of the
// row's |q| over all its words: the sign masks qs[w], and the bit planes
// qm[(p, w)] of |q| as unsigned for every plane j set in `used` (p-th in
// order; INT_MIN's magnitude is plane 31 alone), with their shifts and
// count.  Words and planes past D are zero, so the staged bytes past a
// row's Dp add nothing.
template <int NW>
__device__ __forceinline__ void split_row(const int (&v)[NW], int w0, int nw, unsigned used,
                                          int WP, uint32_t* qs, uint32_t* qm, int* qsh,
                                          int* qnp) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    if (w >= nw) break;
    const unsigned mag = magnitude(v[w]);
    const unsigned neg = __ballot_sync(0xffffffffu, v[w] < 0);
    if (lane == 0) qs[w0 + w] = neg;
    int p = 0;
    for (unsigned u = used; u; u &= u - 1, ++p) {
      const int j = __ffs(u) - 1;
      const unsigned bits = __ballot_sync(0xffffffffu, (mag >> j) & 1u);
      if (lane == 0) {
        qm[p * WP + w0 + w] = bits;
        if (w0 + w == 0) qsh[p] = j;
      }
    }
    if (lane == 0 && w0 + w == 0) *qnp = p;
  }
}

// Shared memory (kernel.py smem_bytes): the tile's plane and sign rows
// (TS, WP) u32 each, the (g, TS) alive bytes and (g, TS) int32 scores
// (all 16-byte aligned), then per row of the group its sign mask (WP), its
// magnitude planes (32, WP) and their shifts (32) and the planes used, and
// the rows-alive mask.
__global__ void __launch_bounds__(kThreads, kMinBlocks) bgpp_score_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int TS = a.TS, WP = a.WP, g = a.g;
  uint32_t* kb = sm;                                        // (TS, WP) plane words
  uint32_t* ks = kb + TS * WP;                              // (TS, WP) sign words
  uint8_t* alv = reinterpret_cast<uint8_t*>(ks + TS * WP);  // (g, TS) alive
  int* outs = reinterpret_cast<int*>(alv + g * TS);         // (g, TS) scores
  uint32_t* qs = reinterpret_cast<uint32_t*>(outs + g * TS);  // (g, WP) sign masks
  uint32_t* qm = qs + g * WP;                               // (g, 32, WP) magnitude planes
  int* qsh = reinterpret_cast<int*>(qm + g * kPlanes * WP);  // (g, 32) plane shifts
  int* qnp = qsh + g * kPlanes;                             // (g,) planes used
  unsigned* rows = reinterpret_cast<unsigned*>(qnp + g);    // bit min(gi, 31): row gi lives

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // block -> (slot, tile, kv head), kv heads fastest
  const int h = blockIdx.x % a.hk;
  const int tile = (blockIdx.x / a.hk) % a.tiles;
  const int b = blockIdx.x / (a.hk * a.tiles);
  const int s0 = tile * TS;
  const long long row0 = (long long)b * a.hq + (long long)h * g;  // the group's first row
  const int n = min(TS, a.S - s0);

  // The group's q rows in registers, warp w holding row w (lane d: dims
  // 32 j + d; g <= 4 and D <= 128, the decode geometry's).  With one pass
  // a tile (short contexts, where a live tile's chain of waits sets the
  // time) they load with the alive bytes, so a live tile does not wait for
  // them and a dead one never reads them; with more (long contexts, where
  // the dead tiles' traffic sets it) only a live tile loads them.  Larger
  // groups or widths read q in the split.  Few registers keep twelve
  // blocks an SM.
  const bool q_in_regs = g <= kQRows * (kThreads / 32) && WP <= kQWords;
  const bool q_early = q_in_regs && TS == kThreads / a.LPK;
  int qr[kQRows][kQWords];
  const auto load_q = [&] {
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      const int gi = warp + r * (kThreads / 32);
#pragma unroll
      for (int w = 0; w < kQWords; ++w) {
        const int d = 32 * w + lane;
        qr[r][w] = gi < g && w < WP && d < a.D ? __ldg(a.q + (row0 + gi) * a.D + d) : 0;
      }
    }
  };
  if (q_early) load_q();

  // ---- the group's alive bytes, 16 at a time where rows allow; the rows
  // with a live key gather in `rows` (zeroed here, ORed after the barrier)
  if (tid == 0) *rows = 0u;
  unsigned mine = 0u;  // bit min(gi, 31): this thread saw a live key of row gi
  const auto row_bit = [](int gi) { return 1u << min(gi, 31); };
  if (a.vec) {  // S % 16 == 0, so n is too
    const int per = TS / 16;
    for (int i = tid; i < g * per; i += kThreads) {
      const int gi = i / per, k = 16 * (i - gi * per);
      const uint4 v = k < n ? __ldg(reinterpret_cast<const uint4*>(a.alive + (row0 + gi) * a.S +
                                                                   s0 + k))
                            : make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint4*>(alv)[i] = v;
      if (v.x | v.y | v.z | v.w) mine |= row_bit(gi);
    }
  } else {
    for (int i = tid; i < g * TS; i += kThreads) {
      const int gi = i / TS, k = i - gi * TS;
      const uint8_t v = k < n ? a.alive[(row0 + gi) * a.S + s0 + k] : 0;
      alv[i] = v;
      if (v) mine |= row_bit(gi);
    }
  }
  if (!__syncthreads_or(mine != 0u)) {  // a dead tile: no plane byte, no adds
    if (a.vec) {
      const int per = TS / 4;
      for (int i = tid; i < g * per; i += kThreads) {
        const int gi = i / per, k = 4 * (i - gi * per);
        if (k < n)
          *reinterpret_cast<int4*>(a.out + (row0 + gi) * a.S + s0 + k) = make_int4(0, 0, 0, 0);
      }
    } else {
      for (int i = tid; i < g * TS; i += kThreads) {
        const int gi = i / TS, k = i - gi * TS;
        if (k < n) a.out[(row0 + gi) * a.S + s0 + k] = 0;
      }
    }
    return;
  }
  {
    const unsigned wm = __reduce_or_sync(0xffffffffu, mine);
    if (lane == 0 && wm) atomicOr(rows, wm);
  }
  if (q_in_regs && !q_early) load_q();

  // ---- stage the plane and sign rows of the keys some row needs, and the
  // group's q rows (zero past D) with their sign masks and |q|'s OR, all in
  // flight together
  const uint8_t* pbase = a.plane + b * a.pb + h * a.ph;
  const uint8_t* sbase = a.sign + b * a.sb + h * a.sh;
  const auto key_live = [&](int k) {
    bool l = false;
    for (int gi = 0; gi < g; ++gi) l |= alv[gi * TS + k] != 0;
    return l;
  };
  if (a.wide) {
    const int chunks = a.Dp / 16;  // 16-byte chunks a row; staged rows hold WP / 4
    for (int i = tid; i < n * chunks; i += kThreads) {
      const int k = i / chunks, c = i - k * chunks;
      if (!key_live(k)) continue;
      const long long s = s0 + k;
      cp_async16(smem_addr(kb + k * WP + 4 * c), pbase + s * a.ps + 16 * c);
      cp_async16(smem_addr(ks + k * WP + 4 * c), sbase + s * a.ss + 16 * c);
    }
  } else {  // rows that are not 16-byte aligned: byte by byte
    uint8_t* kb8 = reinterpret_cast<uint8_t*>(kb);
    uint8_t* ks8 = reinterpret_cast<uint8_t*>(ks);
    for (int i = tid; i < n * a.Dp; i += kThreads) {
      const int k = i / a.Dp, j = i - k * a.Dp;
      if (!key_live(k)) continue;
      const long long s = s0 + k;
      kb8[k * WP * 4 + j] = pbase[s * a.ps + j];
      ks8[k * WP * 4 + j] = sbase[s * a.ss + j];
    }
  }
  // ---- split each row's q: one row a warp, from registers (or from q)
  if (q_in_regs) {
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      const int gi = warp + r * (kThreads / 32);
      if (gi >= g) break;
      unsigned used = 0u;
#pragma unroll
      for (int w = 0; w < kQWords; ++w) used |= magnitude(qr[r][w]);
      split_row(qr[r], 0, WP, __reduce_or_sync(0xffffffffu, used), WP, qs + gi * WP,
                qm + gi * kPlanes * WP, qsh + gi * kPlanes, qnp + gi);
    }
  } else {  // wide rows or large groups: 32 dims a load from q
    const auto q_at = [&](int gi, int w) {
      const int d = 32 * w + lane;
      return w < WP && d < a.D ? __ldg(a.q + (row0 + gi) * a.D + d) : 0;
    };
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      unsigned used = 0u;
      for (int w = 0; w < WP; ++w) used |= magnitude(q_at(gi, w));
      used = __reduce_or_sync(0xffffffffu, used);
      for (int w0 = 0; w0 < WP; w0 += kQWords) {
        int v[kQWords];
#pragma unroll
        for (int w = 0; w < kQWords; ++w) v[w] = q_at(gi, w0 + w);
        split_row(v, w0, min(kQWords, WP - w0), used, WP, qs + gi * WP,
                  qm + gi * kPlanes * WP, qsh + gi * kPlanes, qnp + gi);
      }
    }
  }
  cp_wait_all();
  __syncthreads();

  // ---- score: LPK lanes a key, each a word of every LPK; a warp pass with
  // no live key of the group (most, after round 0) only writes zeros
  const int LPK = a.LPK, wl = tid % LPK, kpp = kThreads / LPK;
  const unsigned live_rows = *rows;
  for (int k = tid / LPK; k < TS; k += kpp) {  // block-uniform trips (TS % kpp == 0)
    if (!__any_sync(0xffffffffu, key_live(k))) {
      if (wl == 0)
        for (int gi = 0; gi < g; ++gi) outs[gi * TS + k] = 0;
      continue;
    }
    for (int gi = 0; gi < g; ++gi) {
      if (gi < 31 && !((live_rows >> gi) & 1u)) {  // no live key of this row in the tile
        if (wl == 0) outs[gi * TS + k] = 0;
        continue;
      }
      const int np = qnp[gi];
      const uint32_t* m = qm + gi * kPlanes * WP;
      unsigned acc = 0;
      for (int w = wl; w < WP; w += LPK) {
        const uint32_t bw = kb[k * WP + w], x = ks[k * WP + w] ^ qs[gi * WP + w];
        for (int p = 0; p < np; ++p) {
          const uint32_t y = m[p * WP + w] & bw;
          acc += (unsigned)(__popc(y) - 2 * __popc(y & x)) << qsh[gi * kPlanes + p];
        }
      }
      for (int o = 1; o < LPK; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (wl == 0) outs[gi * TS + k] = alv[gi * TS + k] ? (int)acc : 0;
    }
  }
  __syncthreads();
  if (a.vec) {
    const int per = TS / 4;
    for (int i = tid; i < g * per; i += kThreads) {
      const int gi = i / per, k = 4 * (i - gi * per);
      if (k < n)
        *reinterpret_cast<int4*>(a.out + (row0 + gi) * a.S + s0 + k) =
            reinterpret_cast<const int4*>(outs)[i];
    }
  } else {
    for (int i = tid; i < g * TS; i += kThreads) {
      const int gi = i / TS, k = i - gi * TS;
      if (k < n) a.out[(row0 + gi) * a.S + s0 + k] = outs[i];
    }
  }
}

}  // namespace

extern "C" {

// q (Q, D) int32 contiguous, Q = B * hq; plane / sign: uint8 rows of
// Dp = D / 8 bytes at byte strides (batch, token, head) = (pb, ps, ph) /
// (sb, ss, sh); alive (Q, S) bool contiguous; out (Q, S) int32
// contiguous.  Query row r is head r % hq of batch r / hq and reads kv head
// (r % hq) / g, g = hq / hk.  WP / LPK / TS / smem from kernel.py `plan`.
// Returns cudaGetLastError().
int bgpp_score_launch(const void* q, const void* plane, const void* sign, const void* alive,
                      void* out, int B, int S, int D, int hq, int hk, int WP, int LPK, int TS,
                      int smem, int wide, long long pb, long long ps, long long ph,
                      long long sb, long long ss, long long sh, void* stream) {
  // 16-byte alive and score rows: every tile start a multiple of 16 lanes
  const int vec = S % 16 == 0 && (uintptr_t)alive % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (B <= 0 || S <= 0) return 0;
  if (D <= 0 || D % 8 || hk <= 0 || hq % hk || WP * 32 < D || LPK <= 0 || LPK > 32 ||
      (LPK & (LPK - 1)) || WP % LPK || TS % (kThreads / LPK))
    return (int)cudaErrorInvalidValue;
  Args a{(const int*)q, (const uint8_t*)plane, (const uint8_t*)sign, (const uint8_t*)alive,
         (int*)out, S, D, D / 8, hq, hk, hq / hk, WP, LPK, TS, (S + TS - 1) / TS, wide, vec,
         pb, ps, ph, sb, ss, sh};
  const long long blocks = (long long)B * a.tiles * hk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        bgpp_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return (int)err;
  }
  bgpp_score_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
