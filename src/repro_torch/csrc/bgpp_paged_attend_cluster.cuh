// The single-cluster fused BGPP decode's kernel, shared by the translation
// units that compile its template instances, one a register-array size G
// (bgpp_paged_attend.cu: G = 1 and the C entry point; bgpp_paged_attend_g2,
// _g4 and _g8.cu), so the build compiles them side by side.  The design is
// set out at the head of bgpp_paged_attend.cu.

#pragma once

#include <cooperative_groups.h>

#include "bgpp_paged_attend.cuh"

namespace cg = cooperative_groups;

// What the translation units share: the plan of a launch, its arguments and
// each G's entry (bgpp_paged_attend.cu holds G = 1 and the C entry point,
// bgpp_paged_attend_g{2,4,8}.cu the others).
namespace bgpp_cluster {

struct Plan {
  int rounds, k_max;
  int width[kMaxLists];  // entries of the list of round r: S, survivors[r], k_max
  int cap[kMaxLists];    // ranks a block owns in that list (kernel.py plan)
};

struct Args {
  const void *q, *planes, *sign, *k_scale, *v, *v_scale, *phys, *pos;
  void *out, *out_idx, *ws;
  int B, Hk, g, Dt, S, query_bits, C, smem;
  Plan plan;
  long long pl_plane, pl_tok, pl_head, v_tok, v_head, sc_tok, sc_head;
  int wide;
  float scale;
  cudaStream_t st;
};

int run_g1(int DP, const Args& a);
int run_g2(int DP, const Args& a);
int run_g4(int DP, const Args& a);
int run_g8(int DP, const Args& a);

}  // namespace bgpp_cluster

namespace {

using bgpp_cluster::Args;
using bgpp_cluster::Plan;

constexpr int kMaxCluster = 8;  // kernel.py MAX_CLUSTER
constexpr int kMaxSlots = 16;   // kernel.py MAX_SLOTS: keys a thread in the block sort
constexpr int kStage = 2048;  // kernel.py STAGE: the other blocks' keys staged at once

// Sort key: ascending order of the key is descending score, then ascending
// position in the current list.  Scores are integers of magnitude < 2^25.
__device__ __forceinline__ u64 make_key(int score, int j) {
  return ((u64)(0x80000000u - (unsigned)score) << 32) | (unsigned)j;
}

// ---- block sort ------------------------------------------------------------

// One bitonic step between slots e and e | JJ of this thread (stride
// JJ * kThreads): element i = e * kThreads + tid.
template <int JJ>
__device__ __forceinline__ void slot_step(u64 (&v)[kMaxSlots], int E, int k) {
#pragma unroll
  for (int e = 0; e < kMaxSlots; ++e) {
    if ((e & JJ) || e >= E) continue;
    const bool up = ((e * kThreads + (int)threadIdx.x) & k) == 0;
    const u64 a = v[e], b = v[e | JJ];
    if ((a > b) == up) {
      v[e] = b;
      v[e | JJ] = a;
    }
  }
}

__device__ __forceinline__ u64 keep(u64 mine, u64 other, int i, int j, int k) {
  const bool lower = (i & j) == 0, up = (i & k) == 0;
  return (lower == up) ? (mine < other ? mine : other) : (mine < other ? other : mine);
}

// Sort keys[0, n) ascending (bitonic over N = pow2(n) elements, padding
// ~0).  Element i = e * kThreads + tid lives in slot e of thread tid, so
// strides below 32 are warp shuffles, strides below kThreads go through
// `keys` (which holds max(kThreads, N) entries) and longer ones stay in the
// thread.  Returns with keys[0, n) sorted.
__device__ void block_sort(u64* keys, int n) {
  u64 v[kMaxSlots];
  const int N = next_pow2(max(n, 1));
  const int E = max(1, N / kThreads);
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < kMaxSlots; ++e) {
    const int i = e * kThreads + tid;
    v[e] = (e < E && i < n) ? keys[i] : ~0ull;
  }
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kThreads) {
        switch (j / kThreads) {
          case 1: slot_step<1>(v, E, k); break;
          case 2: slot_step<2>(v, E, k); break;
          case 4: slot_step<4>(v, E, k); break;
          default: slot_step<8>(v, E, k); break;
        }
      } else if (j >= 32) {
        __syncthreads();  // the last readers of `keys` are done
#pragma unroll
        for (int e = 0; e < kMaxSlots; ++e)
          if (e < E) keys[e * kThreads + tid] = v[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kMaxSlots; ++e) {
          if (e >= E) continue;
          const int i = e * kThreads + tid;
          v[e] = keep(v[e], keys[i ^ j], i, j, k);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kMaxSlots; ++e) {
          if (e >= E) continue;
          const u64 o = __shfl_xor_sync(0xffffffffu, v[e], j);
          v[e] = keep(v[e], o, e * kThreads + tid, j, k);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kMaxSlots; ++e) {
    const int i = e * kThreads + tid;
    if (e < E && i < n) keys[i] = v[e];
  }
  __syncthreads();
}

// Rank each of keys[0, n) (n <= kThreads; thread i holds key i) among them
// by counting the keys below it, then move it to keys[rank]: the block's
// sorted run.  Returns the rank of the thread's key.
__device__ __forceinline__ int rank_few(u64* keys, int n) {
  const int tid = threadIdx.x;
  const u64 key = tid < n ? keys[tid] : ~0ull;
  int cnt = 0;
  if (tid < n) {
    const ulonglong2* k2 = reinterpret_cast<const ulonglong2*>(keys);
#pragma unroll 4
    for (int j = 0; j < n / 2; ++j) {
      const ulonglong2 kk = k2[j];
      cnt += (int)(kk.x < key) + (int)(kk.y < key);
    }
    if (n & 1) cnt += (int)(keys[n - 1] < key);
  }
  __syncthreads();
  if (tid < n) keys[cnt] = key;
  __syncthreads();
  return cnt;
}

// ---- cluster reductions (as paged_flash_decode.cu's) -----------------------

// The C cluster blocks' copies of at[i], all loads in flight together.
template <typename A>
__device__ __forceinline__ void gather_ranks(cg::cluster_group& cluster, A* at, int i,
                                             A (&y)[kMaxCluster]) {
  const int C = cluster.num_blocks();
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c)
    if (c < C) y[c] = cluster.map_shared_rank(at, c)[i];
}

// After a cluster barrier: combine hdr[src + gi] of the cluster's blocks in
// rank order into this block's hdr[dst + gi], gi < g.
template <bool kMax>
__device__ void cluster_reduce(cg::cluster_group& cluster, float* hdr, int src, int dst, int g) {
  if (threadIdx.x < g) {
    float y[kMaxCluster];
    gather_ranks(cluster, hdr, src + threadIdx.x, y);
    float x = y[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < (int)cluster.num_blocks()) x = kMax ? fmaxf(x, y[c]) : x + y[c];
    hdr[dst + threadIdx.x] = x;
  }
  __syncthreads();
}

// Reduce each thread's part[gi] over the cluster (block, then ranks in
// order) into hdr[dst + gi]; src is the block's slot.
template <int G, bool kMax>
__device__ void cluster_stat(cg::cluster_group& cluster, float (&part)[G], int g, float* hdr,
                             int src, int dst) {
  block_reduce<G, kMax>(part, g, hdr, src);
  cluster.sync();
  cluster_reduce<kMax>(cluster, hdr, src, dst, g);
}

// ---- the kernel ------------------------------------------------------------

// A list of the pipeline in shared memory: L entries of `stride` ints (the
// lane, then g partial scores, later the logits, probabilities and codes;
// padded to whole 16-byte words, so an entry moves to another block as
// 16-byte stores).
struct List {
  int* base;
  int stride;
  __device__ int* at(int i) const { return base + i * stride; }
};

// Blocks an SM the register budget is set for: two at G <= 4 up to D 128.
template <int G, int DP>
__host__ __device__ constexpr int min_blocks() {
  return G <= 4 && DP <= 128 ? 2 : 1;
}

// wide: bit 0, plane rows are the compiled width's whole aligned words;
// bit 1, V rows start on 8-byte boundaries.  Only the G = 8 instances
// (one block an SM, registers to spare) carry the narrow loads and the
// workspace lists (ws non-null: (B * Hk * C, 2, L, ES) ints): a launch
// that needs either runs there whatever its g, so the other instances keep
// their registers for the wide path with lists in shared memory alone.
template <int G, int DP>
__global__ void __launch_bounds__(kThreads, min_blocks<G, DP>()) bgpp_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ planes,
    const uint8_t* __restrict__ sign, const float* __restrict__ k_scale,
    const int8_t* __restrict__ v, const float* __restrict__ v_scale,
    const int* __restrict__ phys, const int* __restrict__ pos, float* __restrict__ out,
    int* __restrict__ out_idx, int* ws, int Hk, int g, int Dt, int S, int query_bits, Plan plan,
    long long pl_plane, long long pl_tok, long long pl_head, long long v_tok, long long v_head,
    long long sc_tok, long long sc_head, int wide, float scale) {
  using H = Header<DP>;
  constexpr int W = row_words<DP>(), MW = H::MW;  // 32-bit words of a plane row, of a mask
  constexpr int UN = DP > 128 ? 2 : kUnroll;     // rows a thread has in flight
  constexpr bool kNarrow = G == 8;
  const bool wide_pl = !kNarrow || (wide & 1), wide_v = !kNarrow || (wide & 2);
  const bool in_ws = kNarrow && ws != nullptr;  // the lists lie in the workspace
  const int nb = Dt / 8;  // bytes of a packed row
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const int cell = blockIdx.x / C, b = cell / Hk, h = cell % Hk;
  const int R = plan.rounds, L = plan.cap[0];
  extern __shared__ uint4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  int8_t* codes = reinterpret_cast<int8_t*>(sm + H::kCodes);     // (kMaxG, DP)
  unsigned* masks = reinterpret_cast<unsigned*>(sm + H::kMasks);  // (kMaxG, 8, MW)
  float* hdr = reinterpret_cast<float*>(sm + H::kFloats);
  int* widths = reinterpret_cast<int*>(hdr + kWidths);  // the plan's list widths
  int* caps = widths + kMaxLists;                       // and caps
  u64* keys = reinterpret_cast<u64*>(sm + H::kBytes);  // (max(kThreads, pow2(L)),)
  u64* stage = keys + max(kThreads, next_pow2(L));   // (kStage,) other blocks' keys
  int* const after_stage = reinterpret_cast<int*>(stage + kStage);
  const int ES = (1 + g + 3) / 4 * 4;  // ints an entry
  // block c's two lists: after the stage, or its blocks of the workspace
  const auto lists_of = [&](int c) {
    return in_ws ? ws + (long long)(blockIdx.x - rank + c) * 2 * L * ES : after_stage;
  };
  int* lists = lists_of(rank);
  const auto list_at = [&](int r) { return List{lists + (r & 1) * L * ES, ES}; };
  int* pv = in_ws ? after_stage : lists + 2 * L * ES;  // (kWarps, g, DP)
  if (tid < kMaxLists) {
    widths[tid] = plan.width[tid];
    caps[tid] = plan.cap[tid];
  }

  const int p = pos[b];
  const int nv = p < 0 ? 0 : min(p + 1, S);  // valid lanes: 0..nv-1
  // entries of the list of round r that block c holds (its valid ranks)
  const auto count = [&](int r, int c) {
    return max(0, min(min(nv, widths[r]) - c * caps[r], caps[r]));
  };
  const int* phys_b = phys + (long long)b * S;
  const uint8_t* planes_h = planes + h * pl_head;
  const uint8_t* sign_h = sign + h * pl_head;

  // the thread's first round-0 lane: its pool row and sign / MSB plane
  // rows, in flight while the query is quantised (widths[0] = S >= nv,
  // caps[0] = L)
  const int pre_row = tid < max(0, min(nv - rank * L, L)) ? __ldg(phys_b + rank * L + tid) : -1;
  unsigned pre_kb[W], pre_ks[W];
  if (pre_row >= 0) {
    const long long off = (long long)pre_row * pl_tok;
    load_row<DP>(planes_h + (kNbits - 1) * pl_plane + off, pre_kb, wide_pl, nb);
    load_row<DP>(sign_h + off, pre_ks, wide_pl, nb);
  }

  // ---- A2: the query's codes, scales and bit masks
  quantise_query<DP>(q + (long long)cell * g * Dt, g, Dt, query_bits, codes, masks,
                     hdr + kQScale);
  const int qlo = max(kNbits - query_bits, 0);  // the query keeps planes qlo..6
  // ---- round 0: sign x MSB plane of the block's valid lanes ---------------
  // Then round r's fetch: plane 6 - r of the block's survivors, added to
  // their partials; every entry gets its sort key.
  const auto score_list = [&](int r) {
    const List cur = list_at(r);
    const int n = count(r, rank), base = rank * caps[r], pl = kNbits - 1 - r;
    const uint8_t* plane = planes_h + pl * pl_plane;
    for (int i0 = tid; i0 < n; i0 += UN * kThreads) {
      int rows[UN];
      unsigned kb[UN][W], ks[UN][W];
      const bool first = r == 0 && i0 == tid;  // lane tid is prefetched
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int i = i0 + u * kThreads;
        rows[u] = first && u == 0 ? pre_row
                                  : i < n ? __ldg(phys_b + (r == 0 ? base + i : cur.at(i)[0]))
                                          : -1;
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        if (first && u == 0) {
#pragma unroll
          for (int w = 0; w < W; ++w) kb[0][w] = pre_kb[w], ks[0][w] = pre_ks[w];
        } else if (rows[u] >= 0) {
          const long long off = (long long)rows[u] * pl_tok;
          load_row<DP>(plane + off, kb[u], wide_pl, nb);
          load_row<DP>(sign_h + off, ks[u], wide_pl, nb);
        }
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= n) continue;
        int acc[G];
        plane_dot<G, W, MW>(masks, g, qlo, kb[u], ks[u], acc);
        int* ent = cur.at(i);
        int score = INT_MIN;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          if (gi >= g) continue;
          const int s = (r == 0 ? 0 : ent[1 + gi]) + (acc[gi] << pl);
          ent[1 + gi] = s;
          score = max(score, s);
        }
        if (r == 0) ent[0] = base + i;
        keys[i] = make_key(score, base + i);
      }
    }
  };
  __syncthreads();  // the plan's widths and caps are in place
  score_list(0);

  // ---- selection: list r -> the top of it, in order, as list r + 1 --------
  const int K = plan.k_max;
  for (int r = 0; r < R; ++r) {
    const List cur = list_at(r);
    const int n = count(r, rank), base = rank * caps[r];
    const int nxt = min(nv, widths[r + 1]), capn = caps[r + 1];
    const bool final_sel = r + 1 == R;
    __syncthreads();  // the keys are in place
    // the block's run: keys[0, n) sorted; the thread's places in it (few
    // keys: counted, thread i placing key i; else sorted, the thread taking
    // places e * kThreads + tid)
    const bool few = n <= kThreads;
    const int loc0 = few ? rank_few(keys, n) : 0;
    if (!few) block_sort(keys, n);
    // The other blocks' runs: copied here by 16-byte loads when they fit
    // the stage (each from an even offset), else read where they lie.
    const bool staged = (C - 1) * (caps[r] + 1) <= kStage;
    int pairs[kMaxCluster + 1];  // 16-byte words of the runs before block c
    pairs[0] = 0;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      pairs[c + 1] = pairs[c] + (c < C && c != rank ? (count(r, c) + 1) / 2 : 0);
    cluster.sync();  // every block's sorted run is visible
    if (staged) {
      for (int t0 = 0; t0 < pairs[kMaxCluster]; t0 += 2 * kThreads) {
        ulonglong2 got[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // both loads in flight
          const int t = t0 + k * kThreads + tid;
          int c = 0, off = 0;
#pragma unroll
          for (int cc = 1; cc < kMaxCluster; ++cc)
            if (t >= pairs[cc]) c = cc, off = pairs[cc];
          if (t < pairs[kMaxCluster])
            got[k] = reinterpret_cast<const ulonglong2*>(cluster.map_shared_rank(keys, c))[t - off];
        }
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (t0 + k * kThreads + tid < pairs[kMaxCluster])
            reinterpret_cast<ulonglong2*>(stage)[t0 + k * kThreads + tid] = got[k];
      }
      __syncthreads();
    }
    // block c's run: its copy in the stage, or where it lies
    const auto run_of = [&](int c) -> const u64* {
      return staged ? stage + 2 * pairs[c] : cluster.map_shared_rank(keys, c);
    };
    const int nxt_off = ((r + 1) & 1) * L * ES;  // the next list in a block's pair
    const int places = few ? 1 : next_pow2(n) / kThreads;
#pragma unroll 1
    for (int e = 0; e < places; ++e) {
      const int loc = few ? loc0 : e * kThreads + tid;
      if ((few && tid >= n) || loc >= n || loc >= nxt) continue;  // local rank >= nxt: no survivor
      const u64 key = keys[loc];
      // + the other runs' keys below it: the key's rank in the cell (the
      // C - 1 binary searches advance together)
      int lo[kMaxCluster], len[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) lo[c] = 0, len[c] = c < C && c != rank ? count(r, c) : 0;
      for (bool more = true; more;) {
        more = false;
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (len[c] <= 0) continue;
          const int half = len[c] >> 1;
          if (run_of(c)[lo[c] + half] < key) {
            lo[c] += half + 1;
            len[c] -= half + 1;
          } else {
            len[c] = half;
          }
          more |= len[c] > 0;
        }
      }
      int at = loc;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) at += lo[c];
      if (at >= nxt) continue;
      const int li = (int)(unsigned)(key & 0xffffffffu) - base;
      const int owner = at / capn, slot = at - owner * capn;
      const int4* src = reinterpret_cast<const int4*>(cur.at(li));
      int* const nxt_owner = in_ws ? lists_of(owner) + nxt_off
                                   : cluster.map_shared_rank(lists + nxt_off, owner);
      int4* dst = reinterpret_cast<int4*>(nxt_owner + slot * ES);
      for (int k = 0; k < ES / 4; ++k) dst[k] = src[k];
      if (final_sel && out_idx) out_idx[(long long)cell * K + at] = cur.at(li)[0];
    }
    if (final_sel && out_idx) {  // ranks past the valid lanes: lanes nv, nv + 1, ...
      const int j1 = min(K, (rank + 1) * capn);
      for (int j = max(nxt, rank * capn) + tid; j < j1; j += kThreads)
        out_idx[(long long)cell * K + j] = nv + (j - nxt);
    }
    cluster.sync();  // the survivors are in place; the runs are no longer read
    if (!final_sel) score_list(r + 1);
  }

  // ---- phase 2: the final survivors' int8 K rows, exact A2 logits --------
  // Their pool rows take the place of their lanes, their v_scale goes to
  // the stage (neither is read again).
  const List fin = list_at(R);
  const int capF = caps[R];
  float* vs_of = reinterpret_cast<float*>(stage);
  const float* vsh = v_scale + h * sc_head;
  // with no valid lane every one of lanes 0..k_max-1 weighs the same
  const int m = nv > 0 ? count(R, rank) : max(0, min(K - rank * capF, capF));
  if (nv == 0) {
    for (int i = tid; i < m; i += kThreads) {
      const int row = __ldg(phys_b + rank * capF + i);
      int* ent = fin.at(i);
      ent[0] = row;
      vs_of[i] = __ldg(vsh + (long long)row * sc_tok);
      for (int gi = 0; gi < g; ++gi) reinterpret_cast<float*>(ent)[1 + gi] = kNegInf;
    }
  } else {
    constexpr int CB = DP >= 32 ? 4 : 2;  // bytes of a plane row a thread
    constexpr int CH = DP / (8 * CB);     // threads a survivor
    const float* ksh = k_scale + h * sc_head;
    for (int t0 = 0; t0 < m * CH; t0 += kThreads) {  // block-uniform trips
      const int t = t0 + tid, i = t / CH, ch = t % CH;
      const bool act = t < m * CH;
      int dot[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) dot[gi] = 0;
      int row = 0;
      float ks = 0.f, vs = 0.f;
      if (act) {
        row = __ldg(phys_b + fin.at(i)[0]);
        const long long off = (long long)row * pl_tok;
        if (ch == 0) {
          ks = __ldg(ksh + (long long)row * sc_tok);
          vs = __ldg(vsh + (long long)row * sc_tok);
        }
        unsigned P[8];
#pragma unroll
        for (int pl = 0; pl < kNbits; ++pl)
          P[pl] = load_chunk<DP>(planes_h + pl * pl_plane + off, ch, wide_pl, nb);
        P[7] = load_chunk<DP>(sign_h + off, ch, wide_pl, nb);
        chunk_dot<G, DP, CB>(P, ch, codes, g, dot);
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int o = 1; o < CH; o <<= 1) dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], o);
      if (act && ch == 0) {  // (the survivor's threads read its lane before the shuffles)
        int* ent = fin.at(i);
        ent[0] = row;
        vs_of[i] = vs;
        for (int gi = 0; gi < g; ++gi)
          reinterpret_cast<float*>(ent)[1 + gi] = (float)dot[gi] * hdr[kQScale + gi] * ks * scale;
      }
    }
  }
  __syncthreads();

  // ---- softmax over the cluster, v_scale fold, A3 code quantisation -------
  const auto lg = [&](int i, int gi) -> float& { return reinterpret_cast<float*>(fin.at(i))[1 + gi]; };
  // Each block's max m_c and sum s_c = sum exp(x - m_c) go out together; the
  // cell's max is M = max m_c and its sum sum_c s_c exp(m_c - M), in rank
  // order.  Then p = exp(x - M) / sum, as the plain version's softmax.
  float st[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    st[gi] = -INFINITY;
    if (gi >= g) continue;
    for (int i = tid; i < m; i += kThreads) st[gi] = fmaxf(st[gi], lg(i, gi));
  }
  block_reduce<G, true>(st, g, hdr, kPMax);
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    st[gi] = 0.f;
    if (gi >= g) continue;
    const float mb = hdr[kPMax + gi];
    for (int i = tid; i < m; i += kThreads) st[gi] += expf(lg(i, gi) - mb);
  }
  block_reduce<G, false>(st, g, hdr, kPSum);
  cluster.sync();
  if (tid < g) {
    float mc[kMaxCluster], sc[kMaxCluster];
    gather_ranks(cluster, hdr, kPMax + tid, mc);
    gather_ranks(cluster, hdr, kPSum + tid, sc);
    float mx = mc[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < C) mx = fmaxf(mx, mc[c]);
    float tot = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < C && sc[c] > 0.f) tot += sc[c] * expf(mc[c] - mx);
    hdr[kGMax + tid] = mx;
    hdr[kGSum + tid] = tot;
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    st[gi] = 0.f;
    if (gi >= g) continue;
    const float mx = hdr[kGMax + gi], tot = hdr[kGSum + gi];
    for (int i = tid; i < m; i += kThreads) {
      const float pr = expf(lg(i, gi) - mx) / tot;
      const float w = pr == 0.f ? 0.f : pr * vs_of[i];  // a zero probability weighs nothing
      lg(i, gi) = w;
      st[gi] = fmaxf(st[gi], w);
    }
  }
  cluster_stat<G, true>(cluster, st, g, hdr, kPW, kGW);
  for (int gi = 0; gi < g; ++gi) {
    const float ws = fmaxf(hdr[kGW + gi], 1e-20f) / 127.0f;
    for (int i = tid; i < m; i += kThreads) lg(i, gi) = fminf(fmaxf(rintf(lg(i, gi) / ws), 0.f), 127.f);
  }
  __syncthreads();

  // ---- A3: int8 PV over the block's survivors, exact int32 sums -----------
  constexpr int TPR = DP / 8, RPW = 32 / TPR;  // threads a V row (8 B each), rows a warp
  const int sub = lane_id % TPR, rs = lane_id / TPR;
  const int8_t* vat = v + h * v_head + sub * 8;
  int acc[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[gi][j] = 0;
  for (int i0 = warp * RPW + rs; i0 < m; i0 += kUnroll * kWarps * RPW) {
    uint2 raw[kUnroll];
    int cd[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarps * RPW;
      bool any = false;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        cd[u][gi] = gi < g && i < m ? (int)lg(i, gi) : 0;
        any |= cd[u][gi] != 0;
      }
      // zero codes add nothing: the V row is not read; nor are its
      // columns past Dt
      const int8_t* vr = vat + (long long)(any ? fin.at(i)[0] : 0) * v_tok;
      if (!any || sub * 8 >= Dt) {
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
        for (int j = 0; j < 8; ++j)
          acc[gi][j] += cd[u][gi] * ((int)(wv[j >> 2] << (24 - 8 * (j & 3))) >> 24);
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1) acc[gi][j] += __shfl_xor_sync(0xffffffffu, acc[gi][j], o);
  const int E = g * DP;
  if (rs == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (gi < g)
#pragma unroll
        for (int j = 0; j < 8; ++j) pv[warp * E + gi * DP + sub * 8 + j] = acc[gi][j];
  }
  // the warps' sums, then the C blocks' in rank order: rank c writes a slice
  __syncthreads();
  for (int i = tid; i < E; i += kThreads) {
    int x = pv[i];
    for (int w = 1; w < kWarps; ++w) x += pv[w * E + i];
    pv[i] = x;
  }
  cluster.sync();
  const int per = (E + C - 1) / C, e0 = rank * per, e1 = min(E, e0 + per);
  float* ob = out + (long long)cell * g * Dt;
  for (int i = e0 + tid; i < e1; i += kThreads) {
    int y[kMaxCluster];
    gather_ranks(cluster, pv, i, y);
    int x = y[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < C) x += y[c];
    const int gi = i / DP, d = i - gi * DP;
    if (d < Dt) ob[gi * Dt + d] = (float)x * (fmaxf(hdr[kGW + gi], 1e-20f) / 127.0f);
  }
  cluster.sync();  // every block's shared memory stays alive until all have read it
}

// One cluster launch of `blocks` blocks, C to a cluster.  Dynamic shared
// memory above 48 KB must be opted into per kernel and device: that is done
// only when a launch first needs more than was allowed before.
template <auto Kern, typename... Args>
int launch_clusters(int blocks, int C, int smem, cudaStream_t st, Args... args) {
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return (int)err;
  if (smem > (48 << 10) && (dev >= kMaxDevices || smem > allowed[dev])) {
    err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return (int)err;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kern, args...);
  return (int)(err ? err : cudaGetLastError());
}

template <int G, int DP>
int run(const Args& a) {
  return launch_clusters<bgpp_kernel<G, DP>>(
      a.B * a.Hk * a.C, a.C, a.smem, a.st, (const float*)a.q, (const uint8_t*)a.planes,
      (const uint8_t*)a.sign, (const float*)a.k_scale, (const int8_t*)a.v,
      (const float*)a.v_scale, (const int*)a.phys, (const int*)a.pos, (float*)a.out,
      (int*)a.out_idx, (int*)a.ws, a.Hk, a.g, a.Dt, a.S, a.query_bits, a.plan, a.pl_plane, a.pl_tok,
      a.pl_head, a.v_tok, a.v_head, a.sc_tok, a.sc_head, a.wide, a.scale);
}

// The launch's template instance: G, the register arrays' size, is the
// smallest of 1, 2, 4, 8 that holds g; DP, the compiled width, is 16, 32,
// 64, 128 or 256 (kernel.py `padded_dim`; ops.py checks both).
template <int G>
int by_d(int DP, const Args& a) {
  switch (DP) {
    case 16: return run<G, 16>(a);
    case 32: return run<G, 32>(a);
    case 64: return run<G, 64>(a);
    case 128: return run<G, 128>(a);
    case 256: return run<G, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
