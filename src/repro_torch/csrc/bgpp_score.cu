// One BGPP round: the masked bit-plane score of every key for every query
// row, out[r, s] = alive[r, s] ? sum_d q[r, d] * (1 - 2 sign[s, d]) * bit[s, d] : 0.
//
// Replaces: src/repro/kernels/bgpp_score/kernel.py, bgpp_score_pallas
//   (body _kernel): a key tile with no alive key skips both its plane fetch
//   and its adds (the paper's early termination); live tiles score every
//   key and mask by alive.
//
// What bounds it on the H100: bytes.  A live key costs D/8 plane bytes and
// D/8 sign bytes (32 bytes at D = 128) for 2*D integer operations, ~8 a
// byte, far under the ~295 a byte where arithmetic would be the limit.
// Everything else it reads (the alive flags, q) or writes (one int a key)
// is small.  So the work that counts is the alive keys' bytes, and the
// data decides it: after the first rounds only a few keys survive.
//
// What the design does about it:
//   * one 128-thread block per (128-key tile, query row), one key a
//     thread; the block ORs its keys' alive flags (__syncthreads_or) and a
//     tile with none alive writes zeros and reads no plane or sign byte;
//     inside a live tile a dead key reads nothing either;
//   * a query row is head h of batch b and reads kv head h / g's packed
//     plane in place, through the plane's batch / token / head strides, so
//     the g query heads of a group share one copy of the planes and the
//     whole decode batch is one launch a round;
//   * a live key reads its packed row 4 bytes at a time where the row and
//     its width allow (else byte by byte), and adds +-q[d] for each set
//     bit with a branchless conditional negate; q sits in shared memory
//     and every thread reads the same word (a broadcast);
//   * integer arithmetic: the result is exact and equals the plain version
//     bit for bit.
// Simple and right first: one key a thread, no split of D, no async copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // keys a block, one a thread

__device__ __forceinline__ int signed_bits(unsigned bits, unsigned neg, const int* qd, int n) {
  int acc = 0;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const int keep = -(int)((bits >> i) & 1u);  // 0 or all ones
    const int flip = -(int)((neg >> i) & 1u);
    acc += ((qd[i] & keep) ^ flip) - flip;    // +q, -q or 0
  }
  return acc;
}

__global__ void __launch_bounds__(kTile)
    bgpp_score_kernel(const int* __restrict__ q, const uint8_t* __restrict__ plane,
                      const uint8_t* __restrict__ sign, const uint8_t* __restrict__ alive,
                      int* __restrict__ out, int S, int Dp, int hq, int g, long long pb,
                      long long ps, long long ph, long long sb, long long ss, long long sh) {
  extern __shared__ int qs[];  // the row's D = 8 * Dp query values
  const long long row = blockIdx.y;
  const int s = blockIdx.x * kTile + threadIdx.x;
  const bool in = s < S;
  const bool live = in && alive[row * S + s] != 0;
  int* o = out + row * S;
  if (!__syncthreads_or(live)) {  // rejected tile: no fetch, no adds
    if (in) o[s] = 0;
    return;
  }
  const int D = 8 * Dp;
  for (int d = threadIdx.x; d < D; d += kTile) qs[d] = q[row * D + d];
  __syncthreads();
  int acc = 0;
  if (live) {
    const long long b = row / hq, h = (row % hq) / g;
    const uint8_t* pr = plane + b * pb + s * ps + h * ph;
    const uint8_t* sr = sign + b * sb + s * ss + h * sh;
    if (((Dp | (int)((uintptr_t)pr & 3) | (int)((uintptr_t)sr & 3)) & 3) == 0) {
      const uint32_t* pw = reinterpret_cast<const uint32_t*>(pr);
      const uint32_t* sw = reinterpret_cast<const uint32_t*>(sr);
      for (int w = 0; w < Dp / 4; ++w) acc += signed_bits(pw[w], sw[w], qs + 32 * w, 32);
    } else {
      for (int j = 0; j < Dp; ++j) acc += signed_bits(pr[j], sr[j], qs + 8 * j, 8);
    }
  }
  if (in) o[s] = acc;
}

}  // namespace

extern "C" {

// q (Q, 8*Dp) int32 contiguous; plane / sign: uint8 rows of Dp bytes at
// byte strides (batch, token, head) = (pb, ps, ph) / (sb, ss, sh); alive
// (Q, S) bool (one byte each) contiguous; out (Q, S) int32 contiguous.
// Query row r is head r % hq of batch r / hq and reads kv head
// (r % hq) / g.  Returns cudaGetLastError().
int bgpp_score_launch(const void* q, const void* plane, const void* sign, const void* alive,
                      void* out, int Q, int S, int Dp, int hq, int g, long long pb,
                      long long ps, long long ph, long long sb, long long ss, long long sh,
                      void* stream) {
  if (Q <= 0 || S <= 0) return 0;
  if (Q > 65535 || Dp <= 0 || hq <= 0 || g <= 0 || hq % g) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kTile - 1) / kTile, Q);
  bgpp_score_kernel<<<grid, kTile, 8 * Dp * sizeof(int), (cudaStream_t)stream>>>(
      (const int*)q, (const uint8_t*)plane, (const uint8_t*)sign, (const uint8_t*)alive,
      (int*)out, S, Dp, hq, g, pb, ps, ph, sb, ss, sh);
  return (int)cudaGetLastError();
}

}  // extern "C"
