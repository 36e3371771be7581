// Page-table-aware single-token GQA decode attend over a paged KV pool,
// past the shared-memory cap of paged_flash_decode.cu: each block walks its
// lanes in passes.
//
// Replaces: src/repro/kernels/paged_flash_decode/kernel.py,
//   paged_flash_decode_pallas (bodies _bf16_body and _int8_body), at the
//   context lengths the single-pass bodies refuse.  Those keep a block's
//   whole (g, L) score row in shared memory, which caps a slot at C * L
//   lanes (83,456 at g 5, D 128, page 16; 208,896 at g 2, D 256): below the
//   reference's long_500k shape (524,288 lanes).  Nothing caps the
//   reference's own wrapper, and its plain version takes any length.
//
// The cluster, the block's lanes [c*L, (c+1)*L) and the row loads are those
// of paged_flash_decode.cu (kernels/paged_flash_decode/kernel.py `plan`
// picks these bodies and C = 8 when the single pass does not fit).  A
// block walks its lanes in passes of PL lanes, whole pages, as many as the
// single-pass layout holds in shared memory; a pass loads only its own
// page bases and keeps only its own (g, PL) scores.  Passes use block
// barriers alone, so a slot whose position ends in an earlier pass skips
// the later ones (a block past the position walks none) and still joins
// every cluster barrier after them.  Every instance is G = 8 with the
// narrow loads (one block an SM): g <= 8, any D up to 256, rows at any
// alignment.
//
// bf16 / f32 body, one sweep: a pass's logits, its max m, the running max
// M' = max(M, m), exp(s - M') and the pass's sum, and its PV added to the
// thread's accumulators after rescaling them (and the running sum) by
// exp(M - M'): the online softmax over passes, in pass order.  The cluster
// then merges its blocks' (M_b, s_b, acc_b) in rank order: the max M of the
// M_b, the sum sum_b s_b exp(M_b - M), and each block's accumulators times
// exp(M_b - M) / sum before the ranks add their slices, as the single-pass
// body adds its blocks' PV sums.
//
// int8 body, three sweeps, because the reference quantises every
// probability against the row's largest p * v_scale, which is known only
// once every lane is scored: (1) the logits (the single-pass body's exact
// int32 dp4a dots and rescale) give the block's online max and sum, merged
// over the cluster into the row's max and sum; (2) the logits again give
// p = exp(s - max) / sum times v_scale and the row's largest such w, over
// the cluster; (3) the logits again give the codes rint(w / w_scale) in
// [0, 127] and the exact int32 PV sums.  Each sweep recomputes the same
// logits bit for bit, so p and w are those of one softmax.  A block's PV
// sum stays within int32 (kernel.py `plan` caps its lanes at 2^31 / 127^2);
// the blocks' sums add as 64-bit integers before w_scale.
//
// What bounds it on the H100: bytes, as the single-pass body.  The bf16
// body reads each K and V row once; the int8 body reads each K row and its
// scale three times and V once.  No reduction uses atomics and every order
// is fixed: two launches give the same bits.

#include "paged_flash_decode.cuh"

namespace {

constexpr int G = kMaxG;  // one instance per width: the g rows in registers of 8

// A block's walk over one pass: the lanes [lo, hi) of the pass, the pass's
// page bases in shared memory and the thread's chunk `sub` of a row and row
// offset `rs` in a warp step (as paged_flash_decode.cu's Cell).
struct Pass {
  int lo, hi, page0, sub, rs, first, step;
  PageDiv div;
  const int* base;
  __device__ long long row(int s) const {
    const int pg = div.page(s);
    const int r = base[pg - page0];
    return r < 0 ? 0 : r + (s - pg * div.P);
  }
  __device__ int lane_of(int s0, int u) const { return s0 + u * step + rs; }
};

// Start the pass at lane plo (a page boundary) of a block whose lanes end at
// hi: its page bases into `pages` (unmapped -1 pages read row 0, as
// kv_cache.phys_table maps them), after every thread is done with the
// previous pass's.
__device__ Pass begin_pass(int plo, int hi, int PL, const int* __restrict__ page_ids,
                           long long brow, int pp, const PageDiv& div, int* pages, int tpr) {
  __syncthreads();
  const int page0 = plo / div.P;
  for (int j = threadIdx.x; j < PL / div.P; j += kThreads) {
    const int pid = page0 + j < pp ? __ldg(page_ids + brow + page0 + j) : -1;
    pages[j] = pid < 0 ? -1 : pid * div.P;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, rpw = 32 / tpr;
  Pass w;
  w.lo = plo;
  w.hi = min(plo + PL, hi);
  w.page0 = page0;
  w.sub = lane % tpr;
  w.rs = lane / tpr;
  w.first = plo + warp * rpw;
  w.step = kWarps * rpw;
  w.div = div;
  w.base = pages;
  return w;
}

// The pass's max of each g row (scores sc, row stride PL, n lanes), then the
// block's running max M' = max(M, m) in hdr[kGMax + gi] and the rescale
// exp(M - M') in hdr[kPW + gi]; then sc holds exp(s - M') and the running
// sum hdr[kGSum + gi] is rescaled and grows by the pass's.  Block barriers
// only.
__device__ void pass_softmax(float* hdr, float* sc, int g, int PL, int n) {
  __syncthreads();  // the logits are in place
  float part[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    part[gi] = -INFINITY;
    if (gi >= g) continue;
    for (int i = threadIdx.x; i < n; i += kThreads) part[gi] = fmaxf(part[gi], sc[gi * PL + i]);
  }
  block_reduce<G, true>(part, g, hdr, kPMax);
  __syncthreads();
  if (threadIdx.x < g) {
    const float m_old = hdr[kGMax + threadIdx.x];
    const float m_new = fmaxf(m_old, hdr[kPMax + threadIdx.x]);
    hdr[kPW + threadIdx.x] = expf(m_old - m_new);  // 0 at the first pass (m_old = -inf)
    hdr[kGMax + threadIdx.x] = m_new;
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    part[gi] = 0.f;
    if (gi >= g) continue;
    const float m = hdr[kGMax + gi];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float e = expf(sc[gi * PL + i] - m);
      sc[gi * PL + i] = e;
      part[gi] += e;
    }
  }
  block_reduce<G, false>(part, g, hdr, kPSum);
  __syncthreads();
  if (threadIdx.x < g)
    hdr[kGSum + threadIdx.x] = hdr[kGSum + threadIdx.x] * hdr[kPW + threadIdx.x] +
                               hdr[kPSum + threadIdx.x];
  __syncthreads();
}

// Merge the blocks' running (max, sum) over the cluster, in rank order: on
// return hdr[kGMax + gi] is the row's max M and hdr[kGSum + gi] its sum
// sum_b s_b exp(M_b - M), and hdr[kPW + gi] is this block's weight
// exp(M_b - M) / sum (0 for a block with no lane).
__device__ void cluster_merge(cg::cluster_group& cluster, float* hdr, int g) {
  __syncthreads();
  if (threadIdx.x < g) {
    hdr[kPMax + threadIdx.x] = hdr[kGMax + threadIdx.x];
    hdr[kPSum + threadIdx.x] = hdr[kGSum + threadIdx.x];
  }
  cluster.sync();
  if (threadIdx.x < g) {
    const int C = cluster.num_blocks();
    float mc[kMaxCluster], sc[kMaxCluster];
    gather_ranks(cluster, hdr, kPMax + threadIdx.x, mc);
    gather_ranks(cluster, hdr, kPSum + threadIdx.x, sc);
    float mx = mc[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < C) mx = fmaxf(mx, mc[c]);
    float tot = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < C && sc[c] > 0.f) tot += sc[c] * expf(mc[c] - mx);
    const float mine = hdr[kPMax + threadIdx.x], own = hdr[kPSum + threadIdx.x];
    hdr[kGMax + threadIdx.x] = mx;
    hdr[kGSum + threadIdx.x] = tot;
    hdr[kPW + threadIdx.x] = own > 0.f ? expf(mine - mx) / tot : 0.f;
  }
  __syncthreads();
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) dense_pass_kernel(
    const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ page_ids, const int* __restrict__ pos, float* __restrict__ out,
    int Hk, int g, int Dt, int pp, PageDiv div, int L, int PL, long long tok_stride,
    long long head_stride, int wide, float scale) {
  using R = Rows<T, DP>;
  constexpr int VEC = R::VEC, TPR = R::TPR, CH = R::CH, N = kUnroll * G;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* hdr = reinterpret_cast<float*>(smem4);
  float* part = hdr + kHeader;                       // (kWarps, g, DP)
  float* sc = part + kWarps * g * DP;                // (g, PL) a pass's logits -> exp
  int* pages = reinterpret_cast<int*>(sc + g * PL);  // (PL / P,) a pass's page bases
  const int cell = blockIdx.x / cluster.num_blocks(), b = cell / Hk, h = cell % Hk;
  const int p = pos[b];
  const int lo = cluster.block_rank() * L;
  const int hi = max(lo, min(lo + L, span_of(p, pp * div.P)));  // hi == lo: no pass
  const int sub = (threadIdx.x & 31) % TPR, rs = (threadIdx.x & 31) / TPR;
  const Span<CH> sp(Dt, sub, R::EPC, wide != 0);
  const int E = g * DP;
  const long long row_bytes = tok_stride * (long long)sizeof(T);
  const char* kat = reinterpret_cast<const char*>(k + h * head_stride) + sub * CH * 16;
  const char* vat = reinterpret_cast<const char*>(v + h * head_stride) + sub * CH * 16;
  float qv[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int d = sub * VEC + j;
      qv[gi][j] = gi < g && d < Dt ? q[((long long)cell * g + gi) * Dt + d] : 0.f;
    }
  float acc[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[gi][j] = 0.f;
  if (threadIdx.x < kMaxG) {  // the running max and sum (published by the first pass's barrier)
    hdr[kGMax + threadIdx.x] = -INFINITY;
    hdr[kGSum + threadIdx.x] = 0.f;
  }

  uint4 raw[kUnroll][CH], nxt[kUnroll][CH];
  for (int plo = lo; plo < hi; plo += PL) {
    const Pass w = begin_pass(plo, hi, PL, page_ids, (long long)b * pp, pp, div, pages, TPR);
    // QK: the pass's logits (K rows read only up to pos)
    const int klim = p < 0 ? w.lo : w.hi;
    load_rows<T, true>(raw, w, kat, row_bytes, w.first, klim, sp);
    for (int s0 = w.first; s0 < w.hi; s0 += w.step * kUnroll) {
      load_rows<T, true>(nxt, w, kat, row_bytes, s0 + w.step * kUnroll, klim, sp);
      float val[N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[VEC];
        unpack<T>(raw[u], kf);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) a = fmaf(qv[gi][j], kf[j], a);
          val[u * G + gi] = a;
        }
      }
      fold<TPR>(val, w.sub);
      constexpr int CNT = N >= TPR ? N / TPR : 1, GRP = N >= TPR ? 1 : TPR / N;
      if (w.sub % GRP == 0) {
#pragma unroll
        for (int j = 0; j < CNT; ++j) {
          const int idx = w.sub * N / TPR + j, gi = idx % G;
          const int s = w.lane_of(s0, idx / G);
          if (gi < g && s < w.hi) sc[gi * PL + (s - w.lo)] = s <= p ? val[j] * scale : kNegInf;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < CH; ++i) raw[u][i] = nxt[u][i];
    }
    load_rows<T, true>(raw, w, vat, row_bytes, w.first, w.hi, sp);  // V, ahead of the softmax
    pass_softmax(hdr, sc, g, PL, w.hi - w.lo);
    // PV of the pass, onto the rescaled accumulators
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float cf = gi < g ? hdr[kPW + gi] : 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[gi][j] *= cf;
    }
    for (int s0 = w.first; s0 < w.hi; s0 += w.step * kUnroll) {
      load_rows<T, true>(nxt, w, vat, row_bytes, s0 + w.step * kUnroll, w.hi, sp);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = w.lane_of(s0, u);
        if (s >= w.hi) continue;
        float vf[VEC];
        unpack<T>(raw[u], vf);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          if (gi >= g) break;
          const float pr = sc[gi * PL + (s - w.lo)];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[gi][j] = fmaf(pr, vf[j], acc[gi][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < CH; ++i) raw[u][i] = nxt[u][i];
    }
  }

  cluster_merge(cluster, hdr, g);
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1)
        acc[gi][j] += __shfl_xor_sync(0xffffffffu, acc[gi][j], o);
  if (rs == 0) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (gi < g) {
        const float wb = hdr[kPW + gi];  // exp(M_b - M) / sum
#pragma unroll
        for (int j = 0; j < VEC; ++j) part[warp * E + gi * DP + sub * VEC + j] = acc[gi][j] * wb;
      }
  }
  cluster_output(cluster, part, E, DP, Dt, out + (long long)cell * g * Dt, hdr, false);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) int8_pass_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ page_ids, const int* __restrict__ pos, float* __restrict__ out,
    int Hk, int g, int Dt, int pp, PageDiv div, int L, int PL, long long tok_stride,
    long long head_stride, long long sc_tok_stride, long long sc_head_stride, int wide,
    float scale) {
  using R = Rows<int8_t, DP>;
  constexpr int VEC = R::VEC, TPR = R::TPR, N = kUnroll * G;
  static_assert(R::CH == 1, "an int8 row is at most 32 chunks");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* hdr = reinterpret_cast<float*>(smem4);
  int* part = reinterpret_cast<int*>(hdr + kHeader);   // (kWarps, g, DP)
  float* sc = hdr + kHeader + kWarps * g * DP;         // (g, PL) logits -> w -> codes
  int* pages = reinterpret_cast<int*>(sc + g * PL);    // (PL / P,)
  const int cell = blockIdx.x / cluster.num_blocks(), b = cell / Hk, h = cell % Hk;
  const int p = pos[b];
  const int lo = cluster.block_rank() * L;
  const int hi = max(lo, min(lo + L, span_of(p, pp * div.P)));
  const int sub = (threadIdx.x & 31) % TPR, rs = (threadIdx.x & 31) / TPR;
  const Span<1> sp(Dt, sub, R::EPC, wide != 0);
  const int E = g * DP;
  const char* kat = reinterpret_cast<const char*>(k + h * head_stride) + sub * 16;
  const char* vat = reinterpret_cast<const char*>(v + h * head_stride) + sub * 16;
  const float* ksh = k_scale + h * sc_head_stride;
  const float* vsh = v_scale + h * sc_head_stride;
  const long long brow = (long long)b * pp;

  // A2: per-row absmax/127 quantisation of the query over its true Dt,
  // staged as bytes in `part` (free until the PV sums), zero past Dt
  const float* qb = q + (long long)cell * g * Dt;
  if (threadIdx.x < 32) {
    for (int gi = 0; gi < g; ++gi) {
      float m = 0.f;
      for (int d = threadIdx.x; d < Dt; d += 32) m = fmaxf(m, fabsf(qb[gi * Dt + d]));
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (threadIdx.x == 0) hdr[kQScale + gi] = fmaxf(m, 1e-8f) / 127.0f;
    }
  }
  if (threadIdx.x < kMaxG) {
    hdr[kGMax + threadIdx.x] = -INFINITY;
    hdr[kGSum + threadIdx.x] = 0.f;
  }
  __syncthreads();
  int8_t* codes = reinterpret_cast<int8_t*>(part);
  for (int i = threadIdx.x; i < E; i += kThreads) {
    const int gi = i / DP, d = i - gi * DP;
    codes[i] = d < Dt ? (int8_t)fminf(fmaxf(rintf(qb[gi * Dt + d] / hdr[kQScale + gi]), -127.f),
                                      127.f)
                      : (int8_t)0;
  }
  __syncthreads();
  int qc[G][4];  // the thread's 16 codes of each row, packed for dp4a
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int4 w4 = gi < g ? *reinterpret_cast<const int4*>(codes + gi * DP + sub * VEC)
                           : make_int4(0, 0, 0, 0);
    qc[gi][0] = w4.x;
    qc[gi][1] = w4.y;
    qc[gi][2] = w4.z;
    qc[gi][3] = w4.w;
  }

  uint4 raw[kUnroll][1], nxt[kUnroll][1];
  float ks[kUnroll], ks_nxt[kUnroll];
  float wm[G];  // the thread's largest w = p * v_scale of each row (sweep 1)
  int acc[G][VEC];  // the exact PV sums (sweep 2)
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    wm[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[gi][j] = 0;
  }
  // p * v_scale of the pass's lane i and row gi, from its logit (the row's
  // max and sum in hdr after sweep 0)
  const auto weight = [&](int i, int gi, float vsi) {
    return expf(sc[gi * PL + i] - hdr[kGMax + gi]) / hdr[kGSum + gi] * vsi;
  };
  // Sweep 0: the block's online max and sum, then the row's over the
  // cluster; sweep 1: the row's largest w, over the cluster; sweep 2: the
  // codes against w_scale and the PV sums.  Each pass of each sweep starts
  // with the pass's logits, the same bits every time.
#pragma unroll 1
  for (int sweep = 0; sweep < 3; ++sweep) {
    for (int plo = lo; plo < hi; plo += PL) {
      const Pass w = begin_pass(plo, hi, PL, page_ids, brow, pp, div, pages, TPR);
      // QK: exact int32 dots, rescaled in the reference's order (K rows
      // read only up to pos)
      const int klim = p < 0 ? w.lo : w.hi;
      const auto load_k = [&](uint4(&r)[kUnroll][1], float(&kss)[kUnroll], int s0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = w.lane_of(s0, u);
          const long long row = s < klim ? w.row(s) : 0;
          r[u][0] = s < klim ? load_chunk<int8_t, true>(kat + row * tok_stride, sp.valid[0],
                                                        sp.wide)
                             : make_uint4(0, 0, 0, 0);
          kss[u] = s < klim ? __ldg(ksh + row * sc_tok_stride) : 0.f;
        }
      };
      load_k(raw, ks, w.first);
      for (int s0 = w.first; s0 < w.hi; s0 += w.step * kUnroll) {
        load_k(nxt, ks_nxt, s0 + w.step * kUnroll);
        int val[N];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            int a = __dp4a((int)raw[u][0].x, qc[gi][0], 0);
            a = __dp4a((int)raw[u][0].y, qc[gi][1], a);
            a = __dp4a((int)raw[u][0].z, qc[gi][2], a);
            val[u * G + gi] = __dp4a((int)raw[u][0].w, qc[gi][3], a);
          }
        fold<TPR>(val, w.sub);
        constexpr int CNT = N >= TPR ? N / TPR : 1, GRP = N >= TPR ? 1 : TPR / N;
        if (w.sub % GRP == 0) {
#pragma unroll
          for (int j = 0; j < CNT; ++j) {
            const int idx = w.sub * N / TPR + j, gi = idx % G, u = idx / G;
            float ksu = ks[0];
#pragma unroll
            for (int uu = 1; uu < kUnroll; ++uu) ksu = u == uu ? ks[uu] : ksu;
            const int s = w.lane_of(s0, u);
            if (gi < g && s < w.hi)
              sc[gi * PL + (s - w.lo)] =
                  s <= p ? (float)val[j] * hdr[kQScale + gi] * ksu * scale : kNegInf;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          raw[u][0] = nxt[u][0];
          ks[u] = ks_nxt[u];
        }
      }
      const int n = w.hi - w.lo;
      if (sweep == 0) {
        pass_softmax(hdr, sc, g, PL, n);
        continue;
      }
      __syncthreads();  // the pass's logits are in place
      if (sweep == 1) {
        for (int i = threadIdx.x; i < n; i += kThreads) {
          const float vsi = __ldg(vsh + w.row(w.lo + i) * sc_tok_stride);
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
            if (gi < g) wm[gi] = fmaxf(wm[gi], weight(i, gi, vsi));
        }
        continue;
      }
      load_rows<int8_t, true>(raw, w, vat, tok_stride, w.first, w.hi, sp);  // V, ahead of the codes
      for (int i = threadIdx.x; i < n; i += kThreads) {  // a thread's lanes: its own codes
        const float vsi = __ldg(vsh + w.row(w.lo + i) * sc_tok_stride);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          if (gi >= g) break;
          const float ws = fmaxf(hdr[kGW + gi], 1e-20f) / 127.0f;
          sc[gi * PL + i] = fminf(fmaxf(rintf(weight(i, gi, vsi) / ws), 0.f), 127.f);
        }
      }
      __syncthreads();
      for (int s0 = w.first; s0 < w.hi; s0 += w.step * kUnroll) {
        load_rows<int8_t, true>(nxt, w, vat, tok_stride, s0 + w.step * kUnroll, w.hi, sp);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = w.lane_of(s0, u);
          if (s >= w.hi) continue;
          const unsigned wv[4] = {raw[u][0].x, raw[u][0].y, raw[u][0].z, raw[u][0].w};
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            if (gi >= g) break;
            const int code = (int)sc[gi * PL + (s - w.lo)];
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[gi][j] += code * sbyte(wv[j >> 2], j & 3);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) raw[u][0] = nxt[u][0];
      }
    }
    if (sweep == 0) {
      cluster_merge(cluster, hdr, g);
    } else if (sweep == 1) {
      block_reduce<G, true>(wm, g, hdr, kPW);
      cluster.sync();
      cluster_reduce<true>(cluster, hdr, kPW, kGW, g);
    }
  }
  __syncthreads();  // every thread is done with the query codes in `part`
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1)
        acc[gi][j] += __shfl_xor_sync(0xffffffffu, acc[gi][j], o);
  if (rs == 0) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (gi < g)
#pragma unroll
        for (int j = 0; j < VEC; ++j) part[warp * E + gi * DP + sub * VEC + j] = acc[gi][j];
  }
  cluster_output<int, long long>(cluster, part, E, DP, Dt, out + (long long)cell * g * Dt, hdr,
                                 true);
}

struct PassArgs {
  const void *q, *k, *v, *k_scale, *v_scale, *page_ids, *pos;
  void* out;
  int B, Hk, g, Dt, pp;
  PageDiv div;
  int C, L, PL, smem;
  long long tok_stride, head_stride, sc_tok_stride, sc_head_stride;
  int wide;
  float scale;
  cudaStream_t st;
};

template <typename T, int DP>
int run_dense(const PassArgs& a) {
  return launch_clusters<dense_pass_kernel<T, DP>>(
      a.B * a.Hk * a.C, a.C, a.smem, a.st, (const float*)a.q, (const T*)a.k, (const T*)a.v,
      (const int*)a.page_ids, (const int*)a.pos, (float*)a.out, a.Hk, a.g, a.Dt, a.pp, a.div,
      a.L, a.PL, a.tok_stride, a.head_stride, a.wide, a.scale);
}

template <int DP>
int run_int8(const PassArgs& a) {
  return launch_clusters<int8_pass_kernel<DP>>(
      a.B * a.Hk * a.C, a.C, a.smem, a.st, (const float*)a.q, (const int8_t*)a.k,
      (const int8_t*)a.v, (const float*)a.k_scale, (const float*)a.v_scale,
      (const int*)a.page_ids, (const int*)a.pos, (float*)a.out, a.Hk, a.g, a.Dt, a.pp, a.div,
      a.L, a.PL, a.tok_stride, a.head_stride, a.sc_tok_stride, a.sc_head_stride, a.wide,
      a.scale);
}

// body: 0 bf16, 1 f32, 2 int8; DP the compiled width (kernel.py `padded_dim`)
template <int DP>
int by_body(int body, const PassArgs& a) {
  switch (body) {
    case 0: return run_dense<__nv_bfloat16, DP>(a);
    case 1: return run_dense<float, DP>(a);
    case 2: return run_int8<DP>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// body: 0 = bf16, 1 = f32, 2 = int8 (k_scale / v_scale and their strides
// then used).  Dt is the true head width, DP the compiled one it runs at;
// the page size P divides by (magic, shift); C blocks a cell, L lanes a
// block, PL lanes a pass and smem bytes a block come from kernel.py `plan`
// (its pass bodies); wide: every pool row starts on a 16-byte boundary.
// Returns the launch's cudaError_t.
int paged_flash_decode_pass_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_ids, const void* pos, void* out, int B,
                                   int Hk, int g, int Dt, int DP, int pp, int P, unsigned magic,
                                   unsigned shift, int C, int L, int PL, int smem,
                                   long long tok_stride, long long head_stride,
                                   long long sc_tok_stride, long long sc_head_stride, int wide,
                                   int body, float scale, void* stream) {
  if (P < 1 || Dt < 1 || Dt > DP || g < 1 || g > kMaxG || L % P || PL < P || PL % P)
    return (int)cudaErrorInvalidValue;
  const PassArgs a{q, k, v, k_scale, v_scale, page_ids, pos, out, B, Hk, g, Dt, pp,
                   PageDiv{P, magic, shift}, C, L, PL, smem, tok_stride, head_stride,
                   sc_tok_stride, sc_head_stride, wide, scale, (cudaStream_t)stream};
  switch (DP) {
    case 16: return by_body<16>(body, a);
    case 32: return by_body<32>(body, a);
    case 64: return by_body<64>(body, a);
    case 128: return by_body<128>(body, a);
    case 256: return by_body<256>(body, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
