// Page-table-aware single-token GQA decode attend over a paged KV pool.
//
// Replaces: src/repro/kernels/paged_flash_decode/kernel.py,
//   paged_flash_decode_pallas (bodies _bf16_body and _int8_body).
//
// What bounds it on the H100: bytes.  Per (slot, kv-head) cell it must read
// pos+1 K rows and pos+1 V rows of D values (plus two f32 scales per row in
// the int8 body) and does about 4*g*D operations per row: with g = 3 that is
// ~1.5 flops per byte in bf16, far below the ~295 the card needs before its
// arithmetic is the limit.  So the design fills the card, widens the loads
// and keeps the per-row instruction count low:
//   * one thread-block cluster of C blocks per (slot, kv-head) cell (C <= 8,
//     chosen on the host from static shapes: kernels/paged_flash_decode/
//     kernel.py `plan`), so B*Hk*C blocks spread over the SMs, two blocks an
//     SM fitting in registers (g <= 4).  Block c of a cluster owns the lanes
//     [c*L, (c+1)*L) (whole pages) and reads them only up to the slot's
//     position: lanes past pos have probability exactly 0 in the reference
//     (exp(-1e30 - m) underflows).  A block whose lanes all lie past it
//     reads nothing but joins every cluster barrier;
//   * the warps split the block's rows; a row's TPR threads each load 16
//     bytes of it (8 bf16, 4 f32 or 16 int8 values; f32 at D 256: two
//     chunks a thread), double-buffered a few rows ahead, and the g query
//     rows of the kv head share every row read (GQA).  The row geometry is
//     a template constant, and a row's partial dot products are summed by
//     one halving butterfly over all the rows and query rows of a batch
//     (each shuffle carries a distinct value);
//   * head widths: instances at the compiled widths DP = 16, 32, 64, 128
//     and 256; any other D runs at the next one, with the true D at run
//     time: q, K and V past D read as zero and the output past D is not
//     written, which is exact (zero columns add nothing to q.k or to p.v).
//     Rows whose starts are not all 16-byte aligned (e.g. int8 at D 24),
//     and a chunk that straddles D, load element by element;
//   * the block's page ids are read once into shared memory, so a row's
//     pool index is a shared load and a division by the page size (any
//     page size >= 1: a multiply-high by a magic number from the host and
//     a shift, exact for lanes below 2^31);
//     shared memory holds that map, the block's g x L scores and the warps'
//     (g, D) partial sums, so these bodies take C*L lanes at C = 8 at most
//     (kernel.py `single_pass_lanes`: 83,456 at g 5, D 128, page 16).
//     Past that, kernel.py `plan` picks paged_flash_decode_long.cu, whose
//     blocks walk their lanes in passes of what shared memory holds here;
//   * the first V rows are loaded before the softmax's cluster barriers.
// Softmax is deferred, as in the reference (row max, exp, sum, normalise),
// with the statistics reduced across the cluster through distributed shared
// memory: each block publishes one partial per g row, and after a cluster
// barrier every block combines the C partials in rank order, so all blocks
// see the same max and sum and exp(s - m) has the plain version's argument.
// PV: each warp keeps its (g, D) partial sums in registers, the block adds
// its warps' sums in shared memory, and each rank adds one slice of the C
// blocks' sums and writes that slice of the output.  No reduction uses
// atomics and every order is fixed: two launches give the same bits.
// The int8 body follows the engine's A2/A3 sequence: q quantised per row
// with rintf (half to even, like jnp.round), an exact int32 QK dot (dp4a),
// the (i32 * q_scale) * k_scale * D^-1/2 rescale in that order, v_scale
// folded into the probabilities, probabilities quantised to [0, 127]
// against the cluster-wide max, an int8 PV sum (exact integers, so its
// order does not matter) times w_scale.
// Left for later: TMA / cp.async page loads, tensor cores (mma with g
// padded to 16 rows).
//
// Pools are addressed through strides (token, head), so the slot layout's
// heads-major stacks feed the same kernel through an identity page table
// without a copy.

#include "paged_flash_decode.cuh"

namespace {

// The deferred softmax of the block's (g, n) logits sc (row stride L) over
// the whole cluster.  Leaves exp(s - m) / sum in sc.
template <int G>
__device__ void cluster_softmax(cg::cluster_group& cluster, float* hdr, float* sc, int g, int L,
                                int n) {
  __syncthreads();  // the logits are in place
  float part[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    part[gi] = -INFINITY;
    if (gi >= g) continue;
    for (int i = threadIdx.x; i < n; i += kThreads) part[gi] = fmaxf(part[gi], sc[gi * L + i]);
  }
  block_reduce<G, true>(part, g, hdr, kPMax);
  cluster.sync();
  cluster_reduce<true>(cluster, hdr, kPMax, kGMax, g);
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    part[gi] = 0.f;
    if (gi >= g) continue;
    const float m = hdr[kGMax + gi];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float e = expf(sc[gi * L + i] - m);
      sc[gi * L + i] = e;
      part[gi] += e;
    }
  }
  block_reduce<G, false>(part, g, hdr, kPSum);
  cluster.sync();
  cluster_reduce<false>(cluster, hdr, kPSum, kGSum, g);
  for (int gi = 0; gi < g; ++gi) {
    const float tot = hdr[kGSum + gi];
    for (int i = threadIdx.x; i < n; i += kThreads) sc[gi * L + i] = sc[gi * L + i] / tot;
  }
  __syncthreads();
}

// Where a block and a thread sit: the cluster's (slot, kv-head) cell, the
// block's lanes [lo, hi) and its page bases in shared memory, and the
// thread's chunk `sub` of a row and row offset `rs` in a warp step.
struct Cell {
  int cell, b, h, p, lo, hi, sub, rs, first, step, page0;
  PageDiv div;
  const int* base;  // first pool row of the block's j-th page, -1: unmapped

  // Reads pos and writes the block's page bases (lanes on unmapped -1 pages
  // read row 0, as kv_cache.phys_table maps them: a live slot masks them by
  // position; an idle slot's garbage row then matches the plain version's).
  // L is a whole number of pages (kernel.py `plan`).
  __device__ Cell(cg::cluster_group& cluster, const int* __restrict__ pos,
                  const int* __restrict__ page_ids, int* smem_base, int Hk, int pp,
                  const PageDiv& div_, int L, int tpr)
      : div(div_) {
    cell = blockIdx.x / cluster.num_blocks();
    b = cell / Hk;
    h = cell % Hk;
    lo = cluster.block_rank() * L;
    const int pages = L / div.P;
    page0 = lo / div.P;
    for (int j = threadIdx.x; j < pages; j += kThreads) {
      const int pid = page0 + j < pp ? __ldg(page_ids + (long long)b * pp + page0 + j) : -1;
      smem_base[j] = pid < 0 ? -1 : pid * div.P;
    }
    base = smem_base;
    p = pos[b];
    hi = max(lo, min(lo + L, span_of(p, pp * div.P)));  // hi == lo: nothing to read
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, rpw = 32 / tpr;
    sub = lane % tpr;
    rs = lane / tpr;
    first = lo + warp * rpw;  // warp-uniform
    step = kWarps * rpw;      // rows a block step
  }
  __device__ long long row(int s) const {
    const int pg = div.page(s);
    const int r = base[pg - page0];
    return r < 0 ? 0 : r + (s - pg * div.P);
  }
  __device__ int lane_of(int s0, int u) const { return s0 + u * step + rs; }
};

template <typename T, int G, int DP>
__global__ void __launch_bounds__(kThreads, min_blocks<G, DP>()) dense_kernel(
    const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ page_ids, const int* __restrict__ pos, float* __restrict__ out,
    int Hk, int g, int Dt, int pp, PageDiv div, int L, long long tok_stride,
    long long head_stride, int wide, float scale) {
  using R = Rows<T, DP>;
  constexpr int VEC = R::VEC, TPR = R::TPR, CH = R::CH, N = kUnroll * G;
  constexpr bool NARROW = G == 8;  // the instances that carry the narrow loads
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* hdr = reinterpret_cast<float*>(smem4);
  float* part = hdr + kHeader;                           // (kWarps, g, DP)
  float* sc = part + kWarps * g * DP;                    // (g, L) logits -> probabilities
  int* pages = reinterpret_cast<int*>(sc + g * L);       // (L / P,)
  const Cell c(cluster, pos, page_ids, pages, Hk, pp, div, L, TPR);
  const Span<CH> sp(Dt, c.sub, R::EPC, wide != 0);
  const int E = g * DP;
  const long long row_bytes = tok_stride * (long long)sizeof(T);
  const char* kat = reinterpret_cast<const char*>(k + c.h * head_stride) + c.sub * CH * 16;
  const char* vat = reinterpret_cast<const char*>(v + c.h * head_stride) + c.sub * CH * 16;

  __syncthreads();  // the page bases are in place

  // QK: the logits of the block's lanes (K rows read only up to pos)
  const int klim = c.p < 0 ? c.lo : c.hi;
  uint4 raw[kUnroll][CH], nxt[kUnroll][CH];
  load_rows<T, NARROW>(raw, c, kat, row_bytes, c.first, klim, sp);
  float qv[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int d = c.sub * VEC + j;
      qv[gi][j] = gi < g && d < Dt ? q[((long long)c.cell * g + gi) * Dt + d] : 0.f;
    }
  for (int s0 = c.first; s0 < c.hi; s0 += c.step * kUnroll) {
    load_rows<T, NARROW>(nxt, c, kat, row_bytes, s0 + c.step * kUnroll, klim, sp);
    float val[N];  // (u, gi) partial dots of this thread's chunk
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
    fold<TPR>(val, c.sub);
    constexpr int CNT = N >= TPR ? N / TPR : 1, GRP = N >= TPR ? 1 : TPR / N;
    if (c.sub % GRP == 0) {
#pragma unroll
      for (int j = 0; j < CNT; ++j) {
        const int idx = c.sub * N / TPR + j, gi = idx % G;
        const int s = c.lane_of(s0, idx / G);
        if (gi < g && s < c.hi) sc[gi * L + (s - c.lo)] = s <= c.p ? val[j] * scale : kNegInf;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < CH; ++i) raw[u][i] = nxt[u][i];
  }
  load_rows<T, NARROW>(raw, c, vat, row_bytes, c.first, c.hi, sp);  // V, ahead of the softmax
  cluster_softmax<G>(cluster, hdr, sc, g, L, c.hi - c.lo);

  // PV: each thread sums its chunk of D over the warp's rows
  float acc[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[gi][j] = 0.f;
  for (int s0 = c.first; s0 < c.hi; s0 += c.step * kUnroll) {
    load_rows<T, NARROW>(nxt, c, vat, row_bytes, s0 + c.step * kUnroll, c.hi, sp);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = c.lane_of(s0, u);
      if (s >= c.hi) continue;
      float vf[VEC];
      unpack<T>(raw[u], vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi >= g) break;
        const float pr = sc[gi * L + (s - c.lo)];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[gi][j] = fmaf(pr, vf[j], acc[gi][j]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < CH; ++i) raw[u][i] = nxt[u][i];
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1)
        acc[gi][j] += __shfl_xor_sync(0xffffffffu, acc[gi][j], o);
  if (c.rs == 0) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (gi < g)
#pragma unroll
        for (int j = 0; j < VEC; ++j) part[warp * E + gi * DP + c.sub * VEC + j] = acc[gi][j];
  }
  cluster_output(cluster, part, E, DP, Dt, out + (long long)c.cell * g * Dt, hdr, false);
}

template <int G, int DP>
__global__ void __launch_bounds__(kThreads, min_blocks<G, DP>()) int8_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ page_ids, const int* __restrict__ pos, float* __restrict__ out,
    int Hk, int g, int Dt, int pp, PageDiv div, int L, long long tok_stride,
    long long head_stride, long long sc_tok_stride, long long sc_head_stride, int wide,
    float scale) {
  using R = Rows<int8_t, DP>;
  constexpr int VEC = R::VEC, TPR = R::TPR, N = kUnroll * G;
  constexpr bool NARROW = G == 8;  // the instances that carry the narrow loads
  static_assert(R::CH == 1, "an int8 row is at most 32 chunks");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* hdr = reinterpret_cast<float*>(smem4);
  int* part = reinterpret_cast<int*>(hdr + kHeader);     // (kWarps, g, DP)
  float* sc = hdr + kHeader + kWarps * g * DP;           // (g, L) logits -> probs -> codes
  int* pages = reinterpret_cast<int*>(sc + g * L);       // (L / P,)
  const Cell c(cluster, pos, page_ids, pages, Hk, pp, div, L, TPR);
  const Span<1> sp(Dt, c.sub, R::EPC, wide != 0);
  const int E = g * DP;
  const char* kat = reinterpret_cast<const char*>(k + c.h * head_stride) + c.sub * 16;
  const char* vat = reinterpret_cast<const char*>(v + c.h * head_stride) + c.sub * 16;
  const float* ksh = k_scale + c.h * sc_head_stride;
  const float* vsh = v_scale + c.h * sc_head_stride;

  __syncthreads();  // the page bases are in place
  // QK's first K rows, in flight while the query is quantised
  const int klim = c.p < 0 ? c.lo : c.hi;
  uint4 raw[kUnroll][1], nxt[kUnroll][1];
  float ks[kUnroll], ks_nxt[kUnroll];
  const auto load_k = [&](uint4(&r)[kUnroll][1], float(&kss)[kUnroll], int s0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = c.lane_of(s0, u);
      const long long row = s < klim ? c.row(s) : 0;
      r[u][0] = s < klim ? load_chunk<int8_t, NARROW>(kat + row * tok_stride, sp.valid[0],
                                                      sp.wide)
                         : make_uint4(0, 0, 0, 0);
      kss[u] = s < klim ? __ldg(ksh + row * sc_tok_stride) : 0.f;
    }
  };
  load_k(raw, ks, c.first);
  // A2: per-row absmax/127 quantisation of the query over its true Dt;
  // the block's threads split the codes, staged as bytes in `part` (free
  // until the PV phase), zero past Dt
  const float* qb = q + (long long)c.cell * g * Dt;
  if (threadIdx.x < 32) {
    for (int gi = 0; gi < g; ++gi) {
      float m = 0.f;
      for (int d = threadIdx.x; d < Dt; d += 32) m = fmaxf(m, fabsf(qb[gi * Dt + d]));
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (threadIdx.x == 0) hdr[kQScale + gi] = fmaxf(m, 1e-8f) / 127.0f;
    }
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
    const int4 w = gi < g ? *reinterpret_cast<const int4*>(codes + gi * DP + c.sub * VEC)
                          : make_int4(0, 0, 0, 0);
    qc[gi][0] = w.x;
    qc[gi][1] = w.y;
    qc[gi][2] = w.z;
    qc[gi][3] = w.w;
  }

  // QK: exact int32 dots, rescaled in the reference's order
  for (int s0 = c.first; s0 < c.hi; s0 += c.step * kUnroll) {
    load_k(nxt, ks_nxt, s0 + c.step * kUnroll);
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
    fold<TPR>(val, c.sub);
    constexpr int CNT = N >= TPR ? N / TPR : 1, GRP = N >= TPR ? 1 : TPR / N;
    if (c.sub % GRP == 0) {
#pragma unroll
      for (int j = 0; j < CNT; ++j) {
        const int idx = c.sub * N / TPR + j, gi = idx % G, u = idx / G;
        float ksu = ks[0];
#pragma unroll
        for (int uu = 1; uu < kUnroll; ++uu) ksu = u == uu ? ks[uu] : ksu;
        const int s = c.lane_of(s0, u);
        if (gi < g && s < c.hi)
          sc[gi * L + (s - c.lo)] =
              s <= c.p ? (float)val[j] * hdr[kQScale + gi] * ksu * scale : kNegInf;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      raw[u][0] = nxt[u][0];
      ks[u] = ks_nxt[u];
    }
  }
  const int n = c.hi - c.lo;
  float vs[kUnroll];  // v_scale of this thread's first A3 lanes, ahead of the softmax
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = threadIdx.x + u * kThreads;
    vs[u] = i < n ? __ldg(vsh + c.row(c.lo + i) * sc_tok_stride) : 0.f;
  }
  load_rows<int8_t, NARROW>(raw, c, vat, tok_stride, c.first, c.hi, sp);  // V, ahead of softmax
  cluster_softmax<G>(cluster, hdr, sc, g, L, n);

  // A3: fold v_scale into the probs, quantise them per row to [0, 127]
  // against the cluster-wide max
  float wm[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) wm[gi] = 0.f;
  const auto fold_vs = [&](int i, float vsi) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= g) break;
      const float w = sc[gi * L + i] * vsi;
      sc[gi * L + i] = w;
      wm[gi] = fmaxf(wm[gi], w);
    }
  };
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < n) fold_vs(i, vs[u]);
  }
  for (int i = threadIdx.x + kUnroll * kThreads; i < n; i += kThreads)
    fold_vs(i, __ldg(vsh + c.row(c.lo + i) * sc_tok_stride));
  block_reduce<G, true>(wm, g, hdr, kPW);
  cluster.sync();
  cluster_reduce<true>(cluster, hdr, kPW, kGW, g);
  for (int gi = 0; gi < g; ++gi) {
    const float ws = fmaxf(hdr[kGW + gi], 1e-20f) / 127.0f;
    for (int i = threadIdx.x; i < n; i += kThreads)
      sc[gi * L + i] = fminf(fmaxf(rintf(sc[gi * L + i] / ws), 0.f), 127.f);
  }
  __syncthreads();

  // PV on the codes: exact int32 sums
  int acc[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[gi][j] = 0;
  for (int s0 = c.first; s0 < c.hi; s0 += c.step * kUnroll) {
    load_rows<int8_t, NARROW>(nxt, c, vat, tok_stride, s0 + c.step * kUnroll, c.hi, sp);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = c.lane_of(s0, u);
      if (s >= c.hi) continue;
      const unsigned w[4] = {raw[u][0].x, raw[u][0].y, raw[u][0].z, raw[u][0].w};
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi >= g) break;
        const int code = (int)sc[gi * L + (s - c.lo)];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[gi][j] += code * sbyte(w[j >> 2], j & 3);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u][0] = nxt[u][0];
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1)
        acc[gi][j] += __shfl_xor_sync(0xffffffffu, acc[gi][j], o);
  if (c.rs == 0) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (gi < g)
#pragma unroll
        for (int j = 0; j < VEC; ++j) part[warp * E + gi * DP + c.sub * VEC + j] = acc[gi][j];
  }
  cluster_output(cluster, part, E, DP, Dt, out + (long long)c.cell * g * Dt, hdr, true);
}

// The launch's template instance: G, the register arrays' size, is the
// smallest of 1, 2, 4, 8 that holds g (8 for a launch that needs the
// narrow loads); DP, the compiled width, is 16, 32, 64, 128 or 256
// (kernel.py `padded_dim`; ops.py checks both).
template <template <int, int> class F, typename... A>
int by_shape(int g, int DP, bool narrow, A... a) {
  const int G = narrow ? 8 : g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
#define PFD_D(G_)                                          \
  switch (DP) {                                            \
    case 16: return F<G_, 16>::run(a...);                  \
    case 32: return F<G_, 32>::run(a...);                  \
    case 64: return F<G_, 64>::run(a...);                  \
    case 128: return F<G_, 128>::run(a...);                \
    case 256: return F<G_, 256>::run(a...);                \
    default: return (int)cudaErrorInvalidValue;            \
  }
  switch (G) {
    case 1: PFD_D(1)
    case 2: PFD_D(2)
    case 4: PFD_D(4)
    default: PFD_D(8)
  }
#undef PFD_D
}

struct DenseArgs {
  const void *q, *k, *v, *page_ids, *pos;
  void* out;
  int B, Hk, g, Dt, pp;
  PageDiv div;
  int C, L, smem;
  long long tok_stride, head_stride;
  int wide;
  float scale;
  cudaStream_t st;
};

template <typename T>
struct Dense {
  template <int G, int DP>
  struct Launch {
    static int run(const DenseArgs& a) {
      return launch_clusters<dense_kernel<T, G, DP>>(
          a.B * a.Hk * a.C, a.C, a.smem, a.st, (const float*)a.q, (const T*)a.k,
          (const T*)a.v, (const int*)a.page_ids, (const int*)a.pos, (float*)a.out, a.Hk, a.g,
          a.Dt, a.pp, a.div, a.L, a.tok_stride, a.head_stride, a.wide, a.scale);
    }
  };
};

struct Int8Args {
  DenseArgs d;
  const void *k_scale, *v_scale;
  long long sc_tok_stride, sc_head_stride;
};

template <int G, int DP>
struct Int8Launch {
  static int run(const Int8Args& a) {
    const DenseArgs& d = a.d;
    return launch_clusters<int8_kernel<G, DP>>(
        d.B * d.Hk * d.C, d.C, d.smem, d.st, (const float*)d.q, (const int8_t*)d.k,
        (const int8_t*)d.v, (const float*)a.k_scale, (const float*)a.v_scale,
        (const int*)d.page_ids, (const int*)d.pos, (float*)d.out, d.Hk, d.g, d.Dt, d.pp, d.div,
        d.L, d.tok_stride, d.head_stride, a.sc_tok_stride, a.sc_head_stride, d.wide, d.scale);
  }
};

}  // namespace

extern "C" {

// kv_dtype: 0 = bf16, 1 = f32.  Dt is the true head width, DP the compiled
// one it runs at; the page size P divides by (magic, shift); C blocks a
// cell, L lanes a block and smem bytes a block come from kernel.py `plan`;
// wide: every pool row starts on a 16-byte boundary.  Returns the launch's
// cudaError_t.
int paged_flash_decode_dense_launch(const void* q, const void* k, const void* v,
                                    const void* page_ids, const void* pos, void* out, int B,
                                    int Hk, int g, int Dt, int DP, int pp, int P,
                                    unsigned magic, unsigned shift, int C, int L, int smem,
                                    long long tok_stride, long long head_stride, int wide,
                                    int kv_dtype, float scale, void* stream) {
  if (P < 1 || Dt < 1 || Dt > DP || L % P) return (int)cudaErrorInvalidValue;
  const DenseArgs a{q, k, v, page_ids, pos, out, B, Hk, g, Dt, pp, PageDiv{P, magic, shift},
                    C, L, smem, tok_stride, head_stride, wide, scale, (cudaStream_t)stream};
  const bool narrow = !wide || Dt != DP;  // runs in the G = 8 instances
  return kv_dtype == 0 ? by_shape<Dense<__nv_bfloat16>::Launch>(g, DP, narrow, a)
                       : by_shape<Dense<float>::Launch>(g, DP, narrow, a);
}

int paged_flash_decode_int8_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_ids, const void* pos, void* out, int B,
                                   int Hk, int g, int Dt, int DP, int pp, int P, unsigned magic,
                                   unsigned shift, int C, int L, int smem, long long tok_stride,
                                   long long head_stride, long long sc_tok_stride,
                                   long long sc_head_stride, int wide, float scale,
                                   void* stream) {
  if (P < 1 || Dt < 1 || Dt > DP || L % P) return (int)cudaErrorInvalidValue;
  const Int8Args a{{q, k, v, page_ids, pos, out, B, Hk, g, Dt, pp, PageDiv{P, magic, shift}, C,
                    L, smem, tok_stride, head_stride, wide, scale, (cudaStream_t)stream},
                   k_scale, v_scale, sc_tok_stride, sc_head_stride};
  return by_shape<Int8Launch>(g, DP, !wide || Dt != DP, a);
}

}  // extern "C"
