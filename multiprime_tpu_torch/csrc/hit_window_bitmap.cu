// Any-hit window bitmap of the two-phase scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel multiprime_tpu/ops/mismatch_scan.py _bitmap_kernel
// (:315) / hit_window_bitmap_pallas (:358): for every sequence n and window
// o,
//
//   bitmap[n, o] = 1  if some pattern p hits the window under the rule of
//                     the hit-code kernel (mism = plen - counts <= mm and
//                     suffix >= term), else 0                      (int8)
//
// with the inputs of the TPU kernel: target base sets (bit b of a 4-bit mask
// set iff the one-hot has base b at that position; the caller turns IUPAC
// masks into pure bases first), pattern and 3'-suffix bit-planes.  As the
// TPU kernel's matmul does, a test counts every base a window position
// shares with the pattern, counts = sum over b of popc(T_b & Q_b), so a
// position with several bases counts once per shared base.  The TPU kernel
// computes the whole [TN, TO, TP] verdict block with two int8 MXU matmuls,
// max-reduces it over the patterns and ORs the result across the
// pattern-tile grid axis; it cannot stop early.  Here one thread owns one
// window: it builds the window's bit-planes in registers and walks the
// patterns until the first hit.
//
// What bounds it: operations.  It reads N*L bytes and writes N*O, but tests
// up to O*P (window, pattern) pairs per sequence, each some 10-20 integer
// instructions.  The design keeps every operand on chip: a block stages its
// row's TILE_O + plen - 1 mask bytes once, then the pattern planes pass
// through shared memory a tile at a time, read by every thread at the same
// address (a broadcast).  Words are 32-bit when plen <= 32, which halves the
// logic and popcount work of the common primer lengths.  The suffix test
// runs only for a pair whose mismatch count passes.  A block leaves the
// pattern loop once every window in it has a hit (__syncthreads_or), and a
// thread whose window has hit skips the rest of each tile.  Zero (padding)
// pattern rows never hit while mm < plen, as on the TPU.
//
// No window-length mask here: the caller (hit_window_bitmap) applies it.
// Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_planes.cuh"

namespace {

constexpr int kThreads = 256;  // windows per block, one per thread
constexpr int kTileP = 256;    // patterns staged per shared-memory tile
constexpr int kMaxPlen = 63;

__device__ __forceinline__ int popc(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int popc(uint64_t x) { return __popcll(x); }

// Matches of window planes t against pattern planes q: one per shared base.
template <typename Word>
__device__ __forceinline__ int matches(const Word (&t)[4], const Word* q) {
  return popc(t[0] & q[0]) + popc(t[1] & q[1]) + popc(t[2] & q[2]) + popc(t[3] & q[3]);
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
hit_window_bitmap_kernel(const uint8_t* __restrict__ masks,    // [N, L]
                         const uint64_t* __restrict__ planes,  // [P, 4]
                         const uint64_t* __restrict__ suffix,  // [P, 4]
                         int8_t* __restrict__ bitmap,          // [N, O]
                         int64_t L, int64_t O, int64_t P,
                         int64_t n_tiles, int plen, int mm, int term) {
  __shared__ uint8_t base[kThreads + kMaxPlen];
  // 16-byte aligned: a pattern's four words load as vectors
  __shared__ __align__(16) Word q[kTileP][4];
  __shared__ __align__(16) Word s[kTileP][4];

  const int64_t n = blockIdx.x / n_tiles;
  const int64_t o0 = (blockIdx.x % n_tiles) * kThreads;
  const int tile = static_cast<int>(O - o0 < kThreads ? O - o0 : kThreads);
  const int span = tile + plen - 1;

  const uint8_t* row = masks + n * L + o0;
  for (int i = threadIdx.x; i < span; i += blockDim.x) base[i] = row[i] & 15;
  __syncthreads();

  const int w = threadIdx.x;
  Word t[4] = {0, 0, 0, 0};
  if (w < tile) window_planes(base + w, plen, t);
  // threads past the row's last window have nothing to find
  bool found = w >= tile;

  for (int64_t p0 = 0; p0 < P; p0 += kTileP) {
    // also the barrier that lets the previous tile be overwritten
    if (!__syncthreads_or(!found)) break;
    const int cnt = static_cast<int>(P - p0 < kTileP ? P - p0 : kTileP);
    for (int i = threadIdx.x; i < 4 * cnt; i += blockDim.x) {
      q[i >> 2][i & 3] = static_cast<Word>(planes[4 * p0 + i]);
      s[i >> 2][i & 3] = static_cast<Word>(suffix[4 * p0 + i]);
    }
    __syncthreads();
    for (int j = 0; j < cnt && !found; ++j) {
      if (plen - matches(t, q[j]) <= mm) found = matches(t, s[j]) >= term;
    }
  }
  if (w < tile) bitmap[n * O + o0 + w] = found ? int8_t(1) : int8_t(0);
}

}  // namespace

extern "C" int hit_window_bitmap_launch(const void* masks, const void* planes,
                                        const void* suffix, void* bitmap,
                                        int64_t n, int64_t L, int64_t P,
                                        int plen, int mm, int term,
                                        void* stream) {
  if (plen < 1 || plen > kMaxPlen) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t O = L - plen + 1;
  if (n <= 0 || O <= 0) return static_cast<int>(cudaSuccess);
  const int64_t n_tiles = (O + kThreads - 1) / kThreads;
  const int64_t blocks = n * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* m = static_cast<const uint8_t*>(masks);
  const auto* q = static_cast<const uint64_t*>(planes);
  const auto* s = static_cast<const uint64_t*>(suffix);
  auto* out = static_cast<int8_t*>(bitmap);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  if (plen <= 32) {
    hit_window_bitmap_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        m, q, s, out, L, O, P, n_tiles, plen, mm, term);
  } else {
    hit_window_bitmap_kernel<uint64_t><<<grid, kThreads, 0, st>>>(
        m, q, s, out, L, O, P, n_tiles, plen, mm, term);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hit_window_bitmap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
