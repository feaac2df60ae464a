// Match-count kernel of the dimer matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernel multiprime_tpu/ops/mismatch_scan.py _scan_kernel
// (:150) / match_counts_pallas (:199), and computes the same values as its
// XLA twin match_counts_conv (:133): for every target n, window o and
// pattern p,
//
//   counts[n, o, p] = sum over k < plen, b < 4 of T[n, o+k, b] * Q[p, k, b]
//
// for 0/1 one-hots T and Q, as float32.  The TPU kernel gets there with an
// im2col and one bf16 MXU matmul over a [4*plen] contraction.  Here targets
// arrive as 4-bit masks (bit b set iff the one-hot at [n, l, b] is non-zero)
// and patterns as 4 bit-planes of uint64 (bit k of plane b set iff the
// pattern admits base b at position k), so the dot product is
//
//   popc(T0 & Q0) + popc(T1 & Q1) + popc(T2 & Q2) + popc(T3 & Q3).
//
// No purity rule: unlike the hit-code kernel, a target position with several
// bases counts once per base it shares with the pattern, as the conv does,
// so the four popcounts cannot be merged into one.  Zero columns (the fused
// dimer path's left padding of patterns and targets) add 0.  plen may be 64:
// every bit of the planes is used.
//
// What bounds it: bytes.  It writes 4 bytes per (target, window, pattern)
// against N*L bytes of input and a few dozen integer instructions per
// output.  A block stages one row's TILE_O + plen - 1 mask bytes in shared
// memory and builds each window's planes once; each thread keeps one
// pattern's 4 planes in registers and writes its counts, neighbouring
// threads writing neighbouring floats of a window's pattern row.  Offsets
// are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_planes.cuh"

namespace {

constexpr int kTileO = 64;     // windows per block
constexpr int kThreads = 256;  // threads per block, strided over patterns
constexpr int kMaxPlen = 64;

__global__ void __launch_bounds__(kThreads)
match_counts_kernel(const uint8_t* __restrict__ masks,     // [N, L] 4-bit
                    const uint64_t* __restrict__ planes,   // [P, 4]
                    float* __restrict__ counts,            // [N, O, P]
                    int64_t L, int64_t O, int64_t P, int64_t n_tiles,
                    int plen) {
  __shared__ uint8_t base[kTileO + kMaxPlen];
  __shared__ uint64_t win[kTileO][4];

  const int64_t n = blockIdx.x / n_tiles;
  const int64_t o0 = (blockIdx.x % n_tiles) * kTileO;
  const int tile = static_cast<int>(O - o0 < kTileO ? O - o0 : kTileO);
  const int span = tile + plen - 1;

  const uint8_t* row = masks + n * L + o0;
  for (int i = threadIdx.x; i < span; i += blockDim.x) base[i] = row[i] & 15;
  __syncthreads();

  for (int w = threadIdx.x; w < tile; w += blockDim.x) window_planes(base + w, plen, win[w]);
  __syncthreads();

  float* out = counts + (n * O + o0) * P;
  for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
    const uint64_t q0 = planes[4 * p], q1 = planes[4 * p + 1];
    const uint64_t q2 = planes[4 * p + 2], q3 = planes[4 * p + 3];
    for (int w = 0; w < tile; ++w) {
      const int c = __popcll(win[w][0] & q0) + __popcll(win[w][1] & q1) +
                    __popcll(win[w][2] & q2) + __popcll(win[w][3] & q3);
      out[w * P + p] = static_cast<float>(c);
    }
  }
}

}  // namespace

extern "C" int match_counts_launch(const void* masks, const void* planes,
                                   void* counts, int64_t n, int64_t L,
                                   int64_t P, int plen, void* stream) {
  if (plen < 1 || plen > kMaxPlen) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t O = L - plen + 1;
  if (n <= 0 || O <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const int64_t n_tiles = (O + kTileO - 1) / kTileO;
  const int64_t blocks = n * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  match_counts_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const uint64_t*>(planes),
      static_cast<float*>(counts), L, O, P, n_tiles, plen);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* match_counts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
