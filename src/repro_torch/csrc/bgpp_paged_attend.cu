// Fused two-phase BGPP decode (bit-grained progressive prediction) over a
// paged bit-plane KV pool.
//
// Replaces: src/repro/kernels/bgpp_paged_attend/kernel.py,
//   bgpp_paged_attend_pallas (body _body, selection _topk_iter).
//
// What bounds it on the H100: latency, not bytes.  Per (slot, kv-head) cell
// it must read the packed sign and MSB magnitude plane of every valid lane
// (D/4 bytes a lane), one further plane for each progressive round's
// survivors (D/8 bytes a survivor), and the k_max final survivors' other
// planes, scales and int8 V row: about 0.7 us of the card's memory time at
// the decode geometry (B 4, Hk 8, S 1024).  But every round is a chain of
// dependent steps (fetch a plane row through the lane's pool row, score,
// rank the cell's candidates, pass the survivors on, cluster barriers in
// between), so the design keeps each step short and spreads the cell over
// the card:
//   * one thread-block cluster of C blocks per (slot, kv-head) cell (C <= 8,
//     chosen on the host from static shapes: kernels/bgpp_paged_attend/
//     kernel.py `plan`; decode geometry C 4, 128 blocks, two blocks an SM
//     fitting in registers at g <= 4, so all clusters run at once).  Block
//     c owns the round-0 lanes [c*L, (c+1)*L) and reads them only up to
//     the slot's position; in the list of round r (its candidates in
//     selection order) it owns the ranks [c*caps[r], (c+1)*caps[r]);
//   * a lane's plane row and sign row are one load each (16 bytes at D 128,
//     two at D 256) through its pool row, round 0's first ones in flight
//     while the query is quantised; the score is integer bit arithmetic:
//     the truncated
//     query's magnitudes are the top query_bits planes of an int8, so the
//     signed plane dot is sum_p 2^p (popc(q_p & k & ~(q_s ^ k_s)) -
//     popc(q_p & k & (q_s ^ k_s))) over 32-bit words.  It equals the plain
//     version's f32 sum of integers below 2^24 exactly;
//   * head widths: instances at the compiled widths DP = 16, 32, 64, 128
//     and 256; a D (a multiple of 8) between them runs at the next one
//     with the true D at run time: the query's codes and masks past D are
//     zero, plane bytes and V columns past D are not read, and the output
//     past D is not written, which is exact.  Plane rows that are not whole
//     aligned words of the compiled width (e.g. 3 bytes at D 24), and V
//     rows not on 8-byte boundaries, load byte by byte;
//   * selection ranks only the valid candidates.  A lane past pos scores
//     NEG_INF in every round and so follows every valid lane, in lane order
//     (the plain version's stable sort): those lanes are implied, never
//     stored or read.  Each block orders its own candidates by a 64-bit key
//     (score descending, position in the current list ascending): up to one
//     a thread by counting the keys below each, more by a bitonic network
//     over at most 16 keys a thread in registers.  A candidate's rank in
//     the cell is its rank in its block plus, for each other block, the
//     count of that block's keys below it: binary searches of the other
//     blocks' sorted runs, which each block copies into its own shared
//     memory by 16-byte loads when they fit (decode geometry) and else
//     reads where they lie, through distributed shared memory.  Keys are
//     unique, so the ranks are, and the selection and its order are those
//     of one sort of every key.  A candidate of rank below the next list's
//     width is written, with its g partial scores, to the list of the block
//     that owns that rank, as 16-byte stores (through distributed shared
//     memory, or to the workspace below); no block ever holds or sorts the
//     keys of all S lanes;
//   * each progressive round fetches only its survivors' next plane; the
//     final k_max survivors are rebuilt to int8 K from their 7 planes +
//     sign by 8 x 8 bit transposes (four threads a survivor at D 128, one
//     4-byte word of each plane a thread) and scored by dp4a: exact int32
//     logits;
//   * softmax statistics go across the cluster through distributed shared
//     memory, combined in rank order so all blocks see the same values:
//     each block's max m_c and sum s_c = sum exp(x - m_c) together, the
//     cell's sum being sum_c s_c exp(m_c - max), then the A3 w max.  The PV
//     sum (int8 codes x int8 V, 8-byte V loads, no load where a survivor's
//     codes are all 0) is int32, exact in any order, and each rank adds one
//     slice of the C blocks' sums.
// Shared memory holds the header, the sort keys, a stage for the other
// blocks' runs and two lists of L entries (the lane and g partials in whole
// 16-byte words; the rounds alternate between them), the entry's pool row
// read from the phys map where a round needs it.  Where the two lists do
// not fit in the block's 227 KB with the rest (S 32768 at g >= 4, or at
// g 3 with D 256: 96 B an entry at g 8, 786 KB of lists a block), kernel.py
// `plan` sets them in a global workspace instead, B * Hk * C blocks of two
// lists each, and the candidates of a selection go to their owner's list
// there by global stores: the cluster barrier after the selection
// (barrier.cluster.arrive.release / wait.acquire) orders them before any
// block reads its new list, as it orders the shared-memory stores, and no
// block reads a list entry another block writes before that barrier.  The
// sort keys, the stage, the header and the PV partials stay in shared
// memory, and so does every order: the workspace path selects and sums
// what the shared-memory path does.  Only the G = 8 instances carry it (a
// launch that takes it runs there whatever its g), so the others keep
// their code.  One cluster takes C * L lanes at C = 8 with L at most
// 4096, the sort's 16 keys a thread: S 32768 at every g <= 8 and D <= 256
// (kernel.py `cluster_lanes`); a longer context runs
// bgpp_paged_attend_long.cu, whose selection spans blocks.  The helpers the
// two share are in bgpp_paged_attend.cuh.  This kernel's instances compile
// in four translation units, one a G (this file holds G = 1 and the entry
// point; bgpp_paged_attend_g2, _g4 and _g8.cu the others), which share its
// code through bgpp_paged_attend_cluster.cuh, so the build's parallel nvcc
// runs take them side by side.  No reduction uses atomics and
// every order is fixed: two launches give the same bits.
// The attend follows the engine's A2/A3 sequence: q quantised per row with
// rintf (half to even, like jnp.round), the (i32 * q_scale) * k_scale *
// D^-1/2 rescale in that order, v_scale folded into the probabilities (a
// zero probability weighs 0), probabilities quantised to [0, 127] against
// the cluster-wide max, the int8 PV sum times w_scale.  With no valid lane
// (pos < 0) the plain version's uniform attend over lanes 0..k_max-1 is
// what the all-NEG_INF softmax gives, and that is what runs.

#include "bgpp_paged_attend_cluster.cuh"

int bgpp_cluster::run_g1(int DP, const Args& a) { return by_d<1>(DP, a); }

extern "C" {

// `widths` (rounds + 1 ints: S, survivors[1..rounds-1], k_max) and `caps`
// (ranks a block owns in each of those lists) are host arrays from
// kernel.py `plan`; C blocks a cluster, smem bytes a block.  Dt is the true
// head width (a multiple of 8), DP the compiled one it runs at; `wide` as
// the kernel's.  `out_idx` may be null (else (B, Hk, k_max) int32).  `ws`
// is null when the lists fit in shared memory (smem counts them), else the
// (B * Hk * C, 2, L, ES) int32 workspace that holds them (smem does not).
// Returns the launch's cudaError_t.
int bgpp_paged_attend_launch(const void* q, const void* planes, const void* sign,
                             const void* k_scale, const void* v, const void* v_scale,
                             const void* phys, const void* pos, void* out, void* out_idx,
                             void* ws, int B,
                             int Hk, int g, int Dt, int DP, int S, int nbits, int rounds,
                             const void* widths, const void* caps, int C, int smem,
                             int query_bits, long long pl_plane, long long pl_tok,
                             long long pl_head, long long v_tok, long long v_head,
                             long long sc_tok, long long sc_head, int wide, float scale,
                             void* stream) {
  if (rounds < 1 || rounds >= kMaxLists || g < 1 || g > kMaxG || nbits != kNbits ||
      C < 1 || C > kMaxCluster || Dt < 8 || Dt % 8 || Dt > DP || (wide & 1 && Dt != DP))
    return (int)cudaErrorInvalidValue;
  Args a{q, planes, sign, k_scale, v, v_scale, phys, pos, out, out_idx, ws, B, Hk, g, Dt, S,
         query_bits, C, smem, {}, pl_plane, pl_tok, pl_head, v_tok, v_head, sc_tok, sc_head,
         wide, scale, (cudaStream_t)stream};
  a.plan.rounds = rounds;
  a.plan.k_max = static_cast<const int*>(widths)[rounds];
  for (int r = 0; r < kMaxLists; ++r) {
    a.plan.width[r] = r <= rounds ? static_cast<const int*>(widths)[r] : 0;
    a.plan.cap[r] = r <= rounds ? static_cast<const int*>(caps)[r] : 0;
  }
  if (a.plan.cap[0] > kMaxSlots * kThreads) return (int)cudaErrorInvalidValue;
  // narrow loads (padded D, unaligned rows) and workspace lists run in the
  // G = 8 instances
  const int G = wide != 3 || ws ? 8 : g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
  switch (G) {
    case 1: return bgpp_cluster::run_g1(DP, a);
    case 2: return bgpp_cluster::run_g2(DP, a);
    case 4: return bgpp_cluster::run_g4(DP, a);
    default: return bgpp_cluster::run_g8(DP, a);
  }
}

}  // extern "C"
