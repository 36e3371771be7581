// Fused two-phase BGPP decode over a paged bit-plane KV pool, past the
// single-cluster body's context cap: the selection of every round spans
// blocks.
//
// Replaces: src/repro/kernels/bgpp_paged_attend/kernel.py,
//   bgpp_paged_attend_pallas (body _body, selection _topk_iter), at the
//   context lengths bgpp_paged_attend.cu refuses.  That body ranks a
//   cell's candidates inside one cluster of at most 8 blocks, each sorting
//   at most 4096 keys, which caps a slot at 32768 lanes; the reference's
//   long_500k shape has 524,288, and its own body takes any length.
//
// The function is the single-cluster body's (kernels/bgpp_paged_attend/
// ref.py): round r keeps the top min(nv, width[r + 1]) of its list, by
// score descending and, among equal scores, by position in the list (the
// previous round's selection order; lane order at round 0), and the exact
// int8 attend runs over the final k_max.  Only the valid lanes 0..nv-1 are
// stored and ranked: a lane past the slot's position scores NEG_INF in every
// round and so follows every valid lane in lane order, implied.
//
// A launch is a sequence of kernels on one stream over B * Hk cells, each
// cell split into tiles of kTile entries, one block a tile (kernel.py
// `plan`: 128 blocks a cell at S 524,288):
//   * score (one launch a round): every entry of the round's list gets its
//     next plane (round 0: sign and MSB plane of every valid lane, in lane
//     order; round r: plane 6 - r of the previous list's entry at that rank,
//     found through the previous round's sorted keys), added to its g
//     partial scores as the single-cluster body adds them, and a 64-bit
//     key: (2^22 - score) above its position i in the list.  Scores are
//     integers of magnitude below 2^22 (127 * 120 * 256 at D 256), so the
//     high word is 23 bits;
//   * sort (three passes a round): a stable least-significant-digit radix
//     sort of the list's keys by the three 8-bit digits of the high word.
//     The list is in position order, so a stable sort by score alone gives
//     the order of (score descending, position ascending): one sort of the
//     composite key, all keys distinct.  A pass is a tile histogram, a
//     per-cell scan (one block a cell) and a stable scatter (warp match for
//     the equal digits, warps and iterations in order); a pass whose digit
//     is one value in the whole cell moves nothing and is skipped (`flags`
//     says which of two key buffers holds each pass's result).  The next
//     round's list is the first width[r + 1] sorted keys, each naming its
//     entry by the position in its low word;
//   * attend (four launches): the exact A2 logits of the final survivors
//     (int8 K rebuilt from the 7 planes and sign by bit transposes, dp4a),
//     each block's max and sum of exp; the row's max and sum from the
//     blocks' in block order, p * v_scale and each block's largest w; the
//     row's largest w, the codes rint(w / w_scale) in [0, 127] and each
//     block's exact int32 PV sums, added into the cell's 64-bit
//     accumulators; the accumulators times w_scale.  The reference
//     quantises w against the row's largest w, known only once every
//     survivor is scored, hence the sweeps (as paged_flash_decode_long.cu's
//     int8 body).
// No float sum depends on timing (each is in a fixed order), the integer
// ones are exact, and the sort is a function of the keys: two launches give
// the same bits.  The workspace (kernel.py `workspace_ints`, allocated by
// the wrapper) holds two key buffers, two lists (lane and g partials each),
// the histograms and the attend's per-survivor rows, scales and logits.
//
// What bounds it on the H100: the sort passes and the dependent chain of
// loads a round-r entry needs (sorted key, entry, pool row, plane row), not
// the bytes the function must read.  Every instance is G = 8 (registers for
// any g <= 8) with the narrow loads, at the compiled widths 128 and 256
// (kernel.py `long_dim`): a narrower D runs at 128 with its true D at run
// time, as the single-cluster body runs a D between its widths (query codes
// past D are 0, plane bytes and V columns past D are not read), so the
// source builds in the time of the other files.

#include "bgpp_paged_attend.cuh"

namespace {

constexpr int G = kMaxG;
constexpr int kTile = 4096;  // kernel.py LONG_TILE: entries a block in every sweep
constexpr int kPer = kTile / kThreads;
constexpr int kScoreBias = 1 << 22;  // scores lie in (-2^22, 2^22)
constexpr int kPasses = 3;           // 8-bit digits of the key's 23-bit high word
constexpr int kDigits = 256;

// The workspace's arrays, in the order kernel.py `workspace_ints` sizes
// them (cells = B * Hk, W the widest list's T tiles of lanes, K = k_max and
// F its tiles; kernel.py sizes the last three arrays at F tiles, the PV
// sums at DP 256).
struct Ws {
  u64* keys;        // (2, cells, W)
  long long* acc;   // (cells, g, DP) the PV sums
  int* lanes;       // (2, cells, W) the lists' lanes
  int* part;        // (2, cells, g, W) and partial scores
  int* hist;        // (cells, T, kDigits) tile counts, then offsets
  int* flags;       // (kMaxLists, kPasses + 1, cells) key buffer of each pass
  float* stats;     // (cells, F, 3, g) a block's max, sum, largest w
  int* rows;        // (cells, K) the survivors' pool rows
  float* vs;        // (cells, K) and v_scales
  float* logit;     // (cells, g, K) logits, then p * v_scale
};

struct Args {
  const float* q;
  const uint8_t *planes, *sign;
  const float* k_scale;
  const int8_t* v;
  const float* v_scale;
  const int *phys, *pos;
  float* out;
  int* out_idx;
  Ws ws;
  int cells, Hk, g, Dt, S, K, rounds, query_bits, W, T, F, wide;
  int width[kMaxLists];
  long long pl_plane, pl_tok, pl_head, v_tok, v_head, sc_tok, sc_head;
  float scale;
};

__device__ __forceinline__ int valid_lanes(const Args& a, int b) {
  const int p = a.pos[b];
  return p < 0 ? 0 : min(p + 1, a.S);
}

// entries of round r's list in the cell: its valid candidates
__device__ __forceinline__ int list_len(const Args& a, int r, int nv) {
  return min(nv, a.width[r]);
}

__device__ __forceinline__ int& flag(const Args& a, int r, int pass, int cell) {
  return a.ws.flags[(r * (kPasses + 1) + pass) * a.cells + cell];
}

// ---- score: round r's list, its next plane, its keys ----------------------

template <int DP>
__global__ void __launch_bounds__(kThreads) long_score(Args a, int r, int tpc) {
  using H = Header<DP>;
  constexpr int W = row_words<DP>(), MW = H::MW;
  constexpr int UN = DP > 128 ? 2 : kUnroll;  // rows a thread has in flight
  __shared__ __align__(16) char sm[H::kBytes];
  const int cell = blockIdx.x / tpc, tile = blockIdx.x % tpc, b = cell / a.Hk, h = cell % a.Hk;
  const int tid = threadIdx.x;
  const int src = r == 0 ? 1 : flag(a, r - 1, kPasses, cell);  // the previous sorted keys
  if (tile == 0 && tid == 0) flag(a, r, 0, cell) = 1 - src;    // this round's keys
  const int nv = valid_lanes(a, b), n = list_len(a, r, nv), i0 = tile * kTile;
  if (i0 >= n) return;
  int8_t* codes = reinterpret_cast<int8_t*>(sm + H::kCodes);
  unsigned* masks = reinterpret_cast<unsigned*>(sm + H::kMasks);
  float* hdr = reinterpret_cast<float*>(sm + H::kFloats);
  quantise_query<DP>(a.q + (long long)cell * a.g * a.Dt, a.g, a.Dt, a.query_bits, codes, masks,
                     hdr + kQScale);
  const int qlo = max(kNbits - a.query_bits, 0), pl = kNbits - 1 - r, nb = a.Dt / 8;
  const bool wide_pl = a.wide & 1;
  const int* phys_b = a.phys + (long long)b * a.S;
  const uint8_t* plane = a.planes + h * a.pl_head + pl * a.pl_plane;
  const uint8_t* sign_h = a.sign + h * a.pl_head;
  const long long W0 = a.W, cw = (long long)cell * W0;
  const u64* prev_keys = a.ws.keys + src * a.cells * W0 + cw;
  const int* prev_lanes = a.ws.lanes + ((r + 1) & 1) * a.cells * W0 + cw;
  const int* prev_part = a.ws.part + (((r + 1) & 1) * a.cells * a.g) * W0 + cw * a.g;
  u64* keys = a.ws.keys + (1 - src) * a.cells * W0 + cw;
  int* lanes = a.ws.lanes + (r & 1) * a.cells * W0 + cw;
  int* part = a.ws.part + ((r & 1) * a.cells * a.g) * W0 + cw * a.g;
  const int i1 = min(n, i0 + kTile);
  for (int u0 = 0; u0 < kPer; u0 += UN) {
    int idx[UN], from[UN], lane[UN], row[UN];
    unsigned kb[UN][W], ks[UN][W];
#pragma unroll
    for (int u = 0; u < UN; ++u) {  // the entry at this rank: its place in the previous list
      idx[u] = i0 + (u0 + u) * kThreads + tid;
      from[u] = idx[u] < i1 && r > 0 ? (int)(prev_keys[idx[u]] & 0xffffffffu) : idx[u];
    }
#pragma unroll
    for (int u = 0; u < UN; ++u)
      lane[u] = idx[u] >= i1 ? -1 : r == 0 ? idx[u] : prev_lanes[from[u]];
#pragma unroll
    for (int u = 0; u < UN; ++u) row[u] = lane[u] >= 0 ? __ldg(phys_b + lane[u]) : -1;
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      if (row[u] < 0) continue;
      const long long off = (long long)row[u] * a.pl_tok;
      load_row<DP>(plane + off, kb[u], wide_pl, nb);
      load_row<DP>(sign_h + off, ks[u], wide_pl, nb);
    }
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      if (idx[u] >= i1) continue;
      const int i = idx[u];
      int acc[G];
      plane_dot<G, W, MW>(masks, a.g, qlo, kb[u], ks[u], acc);
      int score = INT_MIN;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi >= a.g) continue;
        const int s = (r == 0 ? 0 : prev_part[gi * W0 + from[u]]) + (acc[gi] << pl);
        part[gi * W0 + i] = s;
        score = max(score, s);
      }
      lanes[i] = lane[u];
      keys[i] = ((u64)(unsigned)(kScoreBias - score) << 32) | (unsigned)i;
    }
  }
}

// ---- sort: one LSD pass (digit `pass` of the high word) -------------------

__device__ __forceinline__ int digit(u64 key, int pass) {
  return (int)((key >> (32 + 8 * pass)) & (kDigits - 1));
}

__global__ void __launch_bounds__(kThreads) long_hist(Args a, int r, int pass, int tpc) {
  __shared__ int cnt[kDigits];
  const int cell = blockIdx.x / tpc, tile = blockIdx.x % tpc, tid = threadIdx.x;
  const int n = list_len(a, r, valid_lanes(a, cell / a.Hk)), i0 = tile * kTile;
  if (i0 >= n) return;
  const u64* keys = a.ws.keys + (flag(a, r, pass, cell) * a.cells + cell) * (long long)a.W;
  cnt[tid] = 0;
  __syncthreads();
  for (int i = i0 + tid; i < min(n, i0 + kTile); i += kThreads)
    atomicAdd(&cnt[digit(keys[i], pass)], 1);
  __syncthreads();
  a.ws.hist[((long long)cell * a.T + tile) * kDigits + tid] = cnt[tid];
}

// One block a cell, a thread a digit: the digit's total over the cell's
// tiles, the totals' exclusive scan, then each tile's offset for the digit
// in place of its count (tiles in order: the scatter is stable).  A pass
// whose digit has one value over the cell keeps the keys where they are.
__global__ void __launch_bounds__(kDigits) long_scan(Args a, int r, int pass) {
  __shared__ int warp_tot[kDigits / 32];
  __shared__ int one_value;
  const int cell = blockIdx.x, d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const int n = list_len(a, r, valid_lanes(a, cell / a.Hk)), nt = (n + kTile - 1) / kTile;
  int* hist = a.ws.hist + (long long)cell * a.T * kDigits + d;
  int tot = 0;
  for (int t = 0; t < nt; ++t) tot += hist[t * kDigits];
  if (d == 0) one_value = n == 0;
  __syncthreads();
  if (tot == n && n > 0) one_value = 1;
  int x = tot;  // inclusive scan: lanes, then warps in order
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += warp_tot[w];
  const int src = flag(a, r, pass, cell);
  if (d == 0) flag(a, r, pass + 1, cell) = one_value ? src : 1 - src;
  if (one_value) return;
  int run = x - tot;
  for (int t = 0; t < nt; ++t) {
    const int c = hist[t * kDigits];
    hist[t * kDigits] = run;
    run += c;
  }
}

// The tile's keys to their places: the tile's offset for the digit, plus the
// keys of that digit before them in the tile (earlier iterations, earlier
// warps, lower lanes).
__global__ void __launch_bounds__(kThreads) long_scatter(Args a, int r, int pass, int tpc) {
  __shared__ int base[kDigits];
  __shared__ int wcnt[kWarps][kDigits];
  const int cell = blockIdx.x / tpc, tile = blockIdx.x % tpc, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = list_len(a, r, valid_lanes(a, cell / a.Hk)), i0 = tile * kTile;
  const int src = flag(a, r, pass, cell), dst = flag(a, r, pass + 1, cell);
  if (i0 >= n || src == dst) return;
  const long long W0 = a.W;
  const u64* from = a.ws.keys + (src * a.cells + cell) * W0;
  u64* to = a.ws.keys + (dst * a.cells + cell) * W0;
  base[tid] = a.ws.hist[((long long)cell * a.T + tile) * kDigits + tid];
  for (int it = 0; it < kPer; ++it) {
    const int i = i0 + it * kThreads + tid;
    const bool live = i < n;
    const u64 key = live ? from[i] : 0;
    const int d = live ? digit(key, pass) : -1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcnt[w][tid] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = __popc(peers & ((1u << lane) - 1));
    if (live && before == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    int run = base[tid];  // thread tid: digit tid over the warps, in order
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w][tid];
      wcnt[w][tid] = run;
      run += c;
    }
    base[tid] = run;
    __syncthreads();
    if (live) to[wcnt[warp][d] + before] = key;
    __syncthreads();
  }
}

// ---- attend: the final survivors ------------------------------------------

// the final list: k_max entries of the cell in selection order, valid ones
// first (m of them; with no valid lane, lanes 0..k_max-1 weigh the same)
__device__ __forceinline__ int final_count(const Args& a, int nv) {
  return nv > 0 ? min(nv, a.K) : a.K;
}

// A block's float statistic over its survivors, g rows: stats[cell][f][s][gi]
__device__ __forceinline__ float* stat_at(const Args& a, int cell, int f, int s) {
  return a.ws.stats + (((long long)cell * a.F + f) * 3 + s) * a.g;
}

template <int DP>
__global__ void __launch_bounds__(kThreads) long_logits(Args a) {
  using H = Header<DP>;
  __shared__ __align__(16) char sm[H::kBytes];
  const int cell = blockIdx.x / a.F, f = blockIdx.x % a.F, b = cell / a.Hk, h = cell % a.Hk;
  const int tid = threadIdx.x, R = a.rounds;
  const int nv = valid_lanes(a, b), nR = min(nv, a.K), m = final_count(a, nv);
  const int j0 = f * kTile, j1 = min(a.K, j0 + kTile);
  const long long W0 = a.W, cw = (long long)cell * W0;
  const u64* keys = a.ws.keys + flag(a, R - 1, kPasses, cell) * a.cells * W0 + cw;
  const int* lanes = a.ws.lanes + ((R - 1) & 1) * a.cells * W0 + cw;
  const int* phys_b = a.phys + (long long)b * a.S;
  if (f == 0)  // the accumulators of the PV sweep (two launches later)
    for (int i = tid; i < a.g * DP; i += kThreads) a.ws.acc[(long long)cell * a.g * DP + i] = 0;
  const auto lane_of = [&](int j) {
    return j < nR ? lanes[(int)(keys[j] & 0xffffffffu)] : nv + (j - nR);
  };
  if (a.out_idx)
    for (int j = j0 + tid; j < j1; j += kThreads) a.out_idx[(long long)cell * a.K + j] = lane_of(j);
  if (j0 >= m) return;
  int8_t* codes = reinterpret_cast<int8_t*>(sm + H::kCodes);
  unsigned* masks = reinterpret_cast<unsigned*>(sm + H::kMasks);
  float* hdr = reinterpret_cast<float*>(sm + H::kFloats);
  quantise_query<DP>(a.q + (long long)cell * a.g * a.Dt, a.g, a.Dt, a.query_bits, codes, masks,
                     hdr + kQScale);
  const bool wide_pl = a.wide & 1;
  const int nb = a.Dt / 8, je = min(m, j1);
  const uint8_t* planes_h = a.planes + h * a.pl_head;
  const uint8_t* sign_h = a.sign + h * a.pl_head;
  const float* ksh = a.k_scale + h * a.sc_head;
  const float* vsh = a.v_scale + h * a.sc_head;
  int* rows = a.ws.rows + (long long)cell * a.K;
  float* vs_of = a.ws.vs + (long long)cell * a.K;
  float* logit = a.ws.logit + (long long)cell * a.g * a.K;
  constexpr int CB = DP >= 32 ? 4 : 2;  // bytes of a plane row a thread
  constexpr int CH = DP / (8 * CB);     // threads a survivor
  for (int t0 = 0; t0 < (je - j0) * CH; t0 += kThreads) {  // block-uniform trips
    const int t = t0 + tid, j = j0 + t / CH, ch = t % CH;
    const bool act = t < (je - j0) * CH;
    int dot[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) dot[gi] = 0;
    int row = 0;
    float ks = 0.f, vs = 0.f;
    if (act) {
      row = __ldg(phys_b + (nv > 0 ? lane_of(j) : j));
      const long long off = (long long)row * a.pl_tok;
      if (ch == 0) {
        ks = __ldg(ksh + (long long)row * a.sc_tok);
        vs = __ldg(vsh + (long long)row * a.sc_tok);
      }
      if (nv > 0) {
        unsigned P[8];
#pragma unroll
        for (int pl = 0; pl < kNbits; ++pl)
          P[pl] = load_chunk<DP>(planes_h + pl * a.pl_plane + off, ch, wide_pl, nb);
        P[7] = load_chunk<DP>(sign_h + off, ch, wide_pl, nb);
        chunk_dot<G, DP, CB>(P, ch, codes, a.g, dot);
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int o = 1; o < CH; o <<= 1) dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], o);
    if (act && ch == 0) {
      rows[j] = row;
      vs_of[j] = vs;
      for (int gi = 0; gi < a.g; ++gi)
        logit[(long long)gi * a.K + j] =
            nv > 0 ? (float)dot[gi] * hdr[kQScale + gi] * ks * a.scale : kNegInf;
    }
  }
  __syncthreads();
  // the block's max m_b and sum s_b = sum exp(x - m_b), each in a fixed order
  float st[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    st[gi] = -INFINITY;
    if (gi >= a.g) continue;
    for (int j = j0 + tid; j < je; j += kThreads) st[gi] = fmaxf(st[gi], logit[(long long)gi * a.K + j]);
  }
  block_reduce<G, true>(st, a.g, hdr, kPMax);
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    st[gi] = 0.f;
    if (gi >= a.g) continue;
    const float mb = hdr[kPMax + gi];
    for (int j = j0 + tid; j < je; j += kThreads) st[gi] += expf(logit[(long long)gi * a.K + j] - mb);
  }
  block_reduce<G, false>(st, a.g, hdr, kPSum);
  __syncthreads();
  if (tid < a.g) {
    stat_at(a, cell, f, 0)[tid] = hdr[kPMax + tid];
    stat_at(a, cell, f, 1)[tid] = hdr[kPSum + tid];
  }
}

// the row's softmax: the max M of the blocks' m_b and the sum of s_b exp(m_b
// - M), blocks in order; p * v_scale in place of the logits; each block's
// largest w
__global__ void __launch_bounds__(kThreads) long_weights(Args a) {
  __shared__ float hdr[kScratch + kWarps * kMaxG];
  const int cell = blockIdx.x / a.F, f = blockIdx.x % a.F, tid = threadIdx.x;
  const int m = final_count(a, valid_lanes(a, cell / a.Hk)), nf = (m + kTile - 1) / kTile;
  const int j0 = f * kTile, je = min(m, j0 + kTile);
  if (j0 >= m) return;
  if (tid < a.g) {
    float mx = -INFINITY;
    for (int c = 0; c < nf; ++c) mx = fmaxf(mx, stat_at(a, cell, c, 0)[tid]);
    float tot = 0.f;
    for (int c = 0; c < nf; ++c) {
      const float s = stat_at(a, cell, c, 1)[tid];
      if (s > 0.f) tot += s * expf(stat_at(a, cell, c, 0)[tid] - mx);
    }
    hdr[kGMax + tid] = mx;
    hdr[kGSum + tid] = tot;
  }
  __syncthreads();
  float* logit = a.ws.logit + (long long)cell * a.g * a.K;
  const float* vs_of = a.ws.vs + (long long)cell * a.K;
  float st[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    st[gi] = 0.f;
    if (gi >= a.g) continue;
    const float mx = hdr[kGMax + gi], tot = hdr[kGSum + gi];
    for (int j = j0 + tid; j < je; j += kThreads) {
      float& x = logit[(long long)gi * a.K + j];
      const float pr = expf(x - mx) / tot;
      const float w = pr == 0.f ? 0.f : pr * vs_of[j];  // a zero probability weighs nothing
      x = w;
      st[gi] = fmaxf(st[gi], w);
    }
  }
  block_reduce<G, true>(st, a.g, hdr, kPW);
  __syncthreads();
  if (tid < a.g) stat_at(a, cell, f, 2)[tid] = hdr[kPW + tid];
}

// the row's w_scale from the blocks' largest w
__device__ __forceinline__ float w_scale(const Args& a, int cell, int nf, int gi) {
  float mx = 0.f;
  for (int c = 0; c < nf; ++c) mx = fmaxf(mx, stat_at(a, cell, c, 2)[gi]);
  return fmaxf(mx, 1e-20f) / 127.0f;
}

template <int DP>
__global__ void __launch_bounds__(kThreads) long_pv(Args a) {
  __shared__ float wsc[kMaxG];
  __shared__ int sum[kMaxG * DP];
  const int cell = blockIdx.x / a.F, f = blockIdx.x % a.F, h = cell % a.Hk;
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const int m = final_count(a, valid_lanes(a, cell / a.Hk)), nf = (m + kTile - 1) / kTile;
  const int j0 = f * kTile, je = min(m, j0 + kTile);
  if (j0 >= m) return;
  if (tid < a.g) wsc[tid] = w_scale(a, cell, nf, tid);
  for (int i = tid; i < a.g * DP; i += kThreads) sum[i] = 0;
  __syncthreads();
  const bool wide_v = a.wide & 2;
  const float* logit = a.ws.logit + (long long)cell * a.g * a.K;
  const int* rows = a.ws.rows + (long long)cell * a.K;
  constexpr int TPR = DP / 8, RPW = 32 / TPR;  // threads a V row (8 B each), rows a warp
  const int sub = lane_id % TPR, rs = lane_id / TPR;
  const int8_t* vat = a.v + h * a.v_head + sub * 8;
  int acc[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[gi][jj] = 0;
  for (int i0 = j0 + warp * RPW + rs; i0 < je; i0 += kUnroll * kWarps * RPW) {
    uint2 raw[kUnroll];
    int cd[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i0 + u * kWarps * RPW;
      bool any = false;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        cd[u][gi] = gi < a.g && j < je
                        ? (int)fminf(fmaxf(rintf(logit[(long long)gi * a.K + j] / wsc[gi]), 0.f), 127.f)
                        : 0;
        any |= cd[u][gi] != 0;
      }
      // zero codes add nothing: the V row is not read; nor are its columns
      // past Dt
      const int8_t* vr = vat + (long long)(any ? rows[j] : 0) * a.v_tok;
      if (!any || sub * 8 >= a.Dt) {
        raw[u] = make_uint2(0, 0);
      } else if (wide_v) {
        raw[u] = __ldg(reinterpret_cast<const uint2*>(vr));
      } else {
        unsigned w2[2];
        load_words(reinterpret_cast<const uint8_t*>(vr), w2, 8);
        raw[u] = make_uint2(w2[0], w2[1]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned wv[2] = {raw[u].x, raw[u].y};
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          acc[gi][jj] += cd[u][gi] * ((int)(wv[jj >> 2] << (24 - 8 * (jj & 3))) >> 24);
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1) acc[gi][jj] += __shfl_xor_sync(0xffffffffu, acc[gi][jj], o);
  if (rs == 0)  // the block's sums: integers, exact in any order
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (gi < a.g)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) atomicAdd(&sum[gi * DP + sub * 8 + jj], acc[gi][jj]);
  __syncthreads();
  unsigned long long* cacc = reinterpret_cast<unsigned long long*>(a.ws.acc + (long long)cell * a.g * DP);
  for (int i = tid; i < a.g * DP; i += kThreads)
    if (sum[i]) atomicAdd(cacc + i, (unsigned long long)(long long)sum[i]);
}

__global__ void __launch_bounds__(kThreads) long_out(Args a, int DP) {
  const int cell = blockIdx.x, tid = threadIdx.x;
  const int m = final_count(a, valid_lanes(a, cell / a.Hk)), nf = (m + kTile - 1) / kTile;
  const long long* acc = a.ws.acc + (long long)cell * a.g * DP;
  float* ob = a.out + (long long)cell * a.g * a.Dt;
  for (int i = tid; i < a.g * a.Dt; i += kThreads) {
    const int gi = i / a.Dt, d = i - gi * a.Dt;
    ob[i] = (float)acc[gi * DP + d] * w_scale(a, cell, nf, gi);
  }
}

int check() { return (int)cudaGetLastError(); }

template <int DP>
int run(const Args& a, cudaStream_t st) {
  int err = 0;
  for (int r = 0; r < a.rounds && !err; ++r) {
    const int tpc = (a.width[r] + kTile - 1) / kTile, tiles = a.cells * tpc;
    long_score<DP><<<tiles, kThreads, 0, st>>>(a, r, tpc);
    if ((err = check())) break;
    for (int pass = 0; pass < kPasses && !err; ++pass) {
      long_hist<<<tiles, kThreads, 0, st>>>(a, r, pass, tpc);
      long_scan<<<a.cells, kDigits, 0, st>>>(a, r, pass);
      long_scatter<<<tiles, kThreads, 0, st>>>(a, r, pass, tpc);
      err = check();
    }
  }
  if (err) return err;
  const int blocks = a.cells * a.F;
  long_logits<DP><<<blocks, kThreads, 0, st>>>(a);
  long_weights<<<blocks, kThreads, 0, st>>>(a);
  long_pv<DP><<<blocks, kThreads, 0, st>>>(a);
  long_out<<<a.cells, kThreads, 0, st>>>(a, DP);
  return check();
}

}  // namespace

extern "C" {

// The body for contexts past the single cluster (kernel.py `plan` with
// `spans`).  `widths`: rounds + 1 host ints (S, survivors[1..rounds-1],
// k_max).  `ws`: ws_ints int32 of workspace (kernel.py `workspace_ints`),
// checked against what the arrays need.  Other arguments as
// bgpp_paged_attend_launch's.  Returns the launches' cudaError_t.
int bgpp_paged_attend_long_launch(const void* q, const void* planes, const void* sign,
                                  const void* k_scale, const void* v, const void* v_scale,
                                  const void* phys, const void* pos, void* out, void* out_idx,
                                  void* ws, long long ws_ints, int B, int Hk, int g, int Dt, int DP,
                                  int S, int nbits, int rounds, const void* widths, int query_bits,
                                  long long pl_plane, long long pl_tok, long long pl_head,
                                  long long v_tok, long long v_head, long long sc_tok,
                                  long long sc_head, int wide, float scale, void* stream) {
  const int* wd = static_cast<const int*>(widths);
  if (rounds < 1 || rounds >= kMaxLists || g < 1 || g > kMaxG || nbits != kNbits || Dt < 8 ||
      Dt % 8 || Dt > DP || (wide & 1 && Dt != DP) || wd[0] != S || S < 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = (const float*)q;
  a.planes = (const uint8_t*)planes;
  a.sign = (const uint8_t*)sign;
  a.k_scale = (const float*)k_scale;
  a.v = (const int8_t*)v;
  a.v_scale = (const float*)v_scale;
  a.phys = (const int*)phys;
  a.pos = (const int*)pos;
  a.out = (float*)out;
  a.out_idx = (int*)out_idx;
  a.cells = B * Hk, a.Hk = Hk, a.g = g, a.Dt = Dt, a.S = S, a.K = wd[rounds], a.rounds = rounds;
  a.query_bits = query_bits, a.wide = wide;
  a.T = (S + kTile - 1) / kTile, a.F = (a.K + kTile - 1) / kTile, a.W = a.T * kTile;
  for (int r = 0; r < kMaxLists; ++r) a.width[r] = r <= rounds ? wd[r] : 0;
  a.pl_plane = pl_plane, a.pl_tok = pl_tok, a.pl_head = pl_head, a.v_tok = v_tok;
  a.v_head = v_head, a.sc_tok = sc_tok, a.sc_head = sc_head, a.scale = scale;
  // the workspace's arrays (kernel.py workspace_ints)
  const long long C = a.cells, W = a.W;
  int* p = (int*)ws;
  a.ws.keys = (u64*)p, p += 4 * C * W;
  a.ws.acc = (long long*)p, p += 2 * C * g * DP;
  a.ws.lanes = p, p += 2 * C * W;
  a.ws.part = p, p += 2 * C * g * W;
  a.ws.hist = p, p += C * a.T * kDigits;
  a.ws.flags = p, p += (long long)kMaxLists * (kPasses + 1) * C;
  a.ws.stats = (float*)p, p += C * a.F * 3 * g;
  a.ws.rows = p, p += C * a.K;
  a.ws.vs = (float*)p, p += C * a.K;
  a.ws.logit = (float*)p, p += C * g * a.K;
  if (p - (int*)ws > ws_ints) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (DP) {
    case 128: return run<128>(a, st);
    case 256: return run<256>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
