// Hit-code kernel of the mismatch coverage scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel multiprime_tpu/ops/mismatch_scan.py
// _hit_code_kernel (:173) / hit_codes_pallas (:240), and computes the same
// function as its XLA twin hit_codes_conv (:295): for every sequence n,
// window o and pattern p,
//
//   counts = #positions k < plen where target[n, o+k] is a pure base that
//            the pattern admits at k
//   suffix = the same count over the 3'-terminal positions only
//   code   = mism + 1  if mism = plen - counts <= mm and suffix >= term
//            0         otherwise                               (int8)
//
// The TPU kernel gets there with an im2col and two int8 MXU matmuls over a
// [4*plen] contraction.  Targets carry at most one base bit per position
// (ambiguity codes, gaps and padding match nothing), so the dot product is
// a bit test: with the pattern packed as 4 bit-planes of uint64 (bit k of
// plane b set iff the pattern admits base b at position k) and the window
// packed the same way, one (window, pattern) pair costs 8 ANDs, 6 ORs and
// 2 popcounts.  The exact rule suffix >= term is kept, so term = 0 and
// term > plen behave as in the JAX package.
//
// What bounds it: bytes.  The int8 [N, O, P] code tensor it writes is
// ~N*O*P bytes against N*L bytes of input; the integer work per output byte
// is a few dozen instructions.  The design keeps every read on chip: a
// block stages one row's TILE_O + plen - 1 target bytes in shared memory
// and builds each window's planes once; each thread keeps one pattern's 8
// planes in registers and streams its codes out, neighbouring threads
// writing neighbouring bytes of a window's pattern row.  Making the stores
// wider (or fusing the sparse compaction so the codes never reach device
// memory) is left to a later change.
//
// No window-length mask here: the caller (find_hits) applies it, as on the
// TPU.  Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_planes.cuh"

namespace {

constexpr int kTileO = 128;    // windows per block
constexpr int kThreads = 256;  // threads per block, strided over patterns
constexpr int kMaxPlen = 63;   // planes are 64-bit; bit 63 stays clear

__global__ void __launch_bounds__(kThreads)
hit_codes_kernel(const uint8_t* __restrict__ masks,      // [N, L] 4-bit IUPAC
                 const uint64_t* __restrict__ planes,    // [P, 4]
                 const uint64_t* __restrict__ suffix,    // [P, 4]
                 int8_t* __restrict__ codes,             // [N, O, P]
                 int64_t L, int64_t O, int64_t P, int64_t n_tiles,
                 int plen, int mm, int term) {
  __shared__ uint8_t base[kTileO + kMaxPlen];
  __shared__ uint64_t win[kTileO][4];

  const int64_t n = blockIdx.x / n_tiles;
  const int64_t o0 = (blockIdx.x % n_tiles) * kTileO;
  const int tile = static_cast<int>(O - o0 < kTileO ? O - o0 : kTileO);
  const int span = tile + plen - 1;

  const uint8_t* row = masks + n * L + o0;
  for (int i = threadIdx.x; i < span; i += blockDim.x) base[i] = pure_base(row[i]);
  __syncthreads();

  for (int w = threadIdx.x; w < tile; w += blockDim.x) window_planes(base + w, plen, win[w]);
  __syncthreads();

  int8_t* out = codes + (n * O + o0) * P;
  for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
    const uint64_t q0 = planes[4 * p], q1 = planes[4 * p + 1];
    const uint64_t q2 = planes[4 * p + 2], q3 = planes[4 * p + 3];
    const uint64_t s0 = suffix[4 * p], s1 = suffix[4 * p + 1];
    const uint64_t s2 = suffix[4 * p + 2], s3 = suffix[4 * p + 3];
    for (int w = 0; w < tile; ++w) {
      const uint64_t t0 = win[w][0], t1 = win[w][1];
      const uint64_t t2 = win[w][2], t3 = win[w][3];
      const uint64_t hit = (t0 & q0) | (t1 & q1) | (t2 & q2) | (t3 & q3);
      const uint64_t sfx = (t0 & s0) | (t1 & s1) | (t2 & s2) | (t3 & s3);
      const int mism = plen - __popcll(hit);
      const bool ok = mism <= mm && __popcll(sfx) >= term;
      out[w * P + p] = ok ? static_cast<int8_t>(mism + 1) : int8_t(0);
    }
  }
}

}  // namespace

extern "C" int hit_codes_launch(const void* masks, const void* planes,
                                const void* suffix, void* codes, int64_t n,
                                int64_t L, int64_t P, int plen, int mm,
                                int term, void* stream) {
  if (plen < 1 || plen > kMaxPlen) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t O = L - plen + 1;
  if (n <= 0 || O <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const int64_t n_tiles = (O + kTileO - 1) / kTileO;
  const int64_t blocks = n * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  hit_codes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const uint64_t*>(planes),
      static_cast<const uint64_t*>(suffix), static_cast<int8_t*>(codes), L, O,
      P, n_tiles, plen, mm, term);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hit_codes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
