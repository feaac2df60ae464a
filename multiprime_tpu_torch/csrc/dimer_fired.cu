// Fired dimer ends of the fused dimer pass, for Hopper (sm_90a).
//
// Replaces the jitted program multiprime_tpu/ops/dimer.py _fused_kernel
// (:134, jit :162): for every expanded target t and primer end e (the
// end's reverse complement, left-padded with zero columns to lp),
//
//   count[o]  = sum over k < lp, b < 4 of T[t, o+k, b] * Q[e, k, b]
//               (match_counts.cu's popcount rule: a target position with
//               several bases counts once per base it shares, no purity)
//   ok[o]     = count[o] >= ln[e] && real_o >= 0 && real_o + ln[e] <= lens[t]
//               with real_o = o + shift[e] - z
//   first     = the least o with ok[o] (str.find's first occurrence)
//   d2        = lens[t] - ln[e] - (first + shift[e] - z), clipped to
//               [0, W - 1]
//   fired[t, e] = some ok[o] && trig[e, d2]                  (bool [T, E])
//
// The port ran this as the match-count kernel's float32 [T, O, E] counts
// and a torch epilogue (any, argmax, gather) over them.  Here a block is
// one target and 256 ends: it builds its target's window bit-planes once
// in shared memory (window_planes.cuh, O x 4 words), then each thread
// takes one (t, e), skips the windows with real_o < 0, tests the windows
// in ascending o (four ANDs and popcounts of shared words) and stops at
// the first hit or at the last window inside the target.  No [T, O, E]
// tensor exists.
//
// What bounds it: operations, a dozen integer operations a window tested
// (four ANDs, four 64-bit popcounts, the adds and the compare) for the
// windows this data tests, against T * L + E * (48 + W) bytes in and T * E
// out.  Neighbouring threads read neighbouring ends' planes and write
// neighbouring output bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLp = 64;
constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper

__global__ void __launch_bounds__(kThreads)
dimer_fired_kernel(const uint8_t* __restrict__ masks,    // [T, L] 4-bit
                   const int64_t* __restrict__ lens,     // [T]
                   const uint64_t* __restrict__ planes,  // [E, 4]
                   const int64_t* __restrict__ ln,       // [E]
                   const int64_t* __restrict__ shift,    // [E]
                   const uint8_t* __restrict__ trig,     // [E, W] bool
                   uint8_t* __restrict__ fired,          // [T, E] bool
                   int64_t L, int64_t E, int64_t W, int lp, int64_t z,
                   int64_t e_chunks) {
  extern __shared__ uint64_t win[];  // [O][4]: the row's window planes
  const int64_t t = blockIdx.x / e_chunks;
  const int64_t e = (blockIdx.x % e_chunks) * kThreads + threadIdx.x;
  const uint8_t* row = masks + t * L;
  const int64_t O = L - lp + 1;
  for (int64_t o = threadIdx.x; o < O; o += kThreads) {
    uint64_t w[4];
    window_planes(row + o, lp, w);
#pragma unroll
    for (int b = 0; b < 4; ++b) win[4 * o + b] = w[b];
  }
  __syncthreads();
  if (e >= E) return;
  const int64_t len = lens[t], ln_e = ln[e], sh = shift[e] - z;
  // windows o with real_o = o + sh in [0, len - ln_e], and o < O
  int64_t o = sh < 0 ? -sh : 0;
  int64_t last = len - ln_e - sh;
  if (last > O - 1) last = O - 1;
  int64_t first = -1;
  if (o <= last) {
    const uint64_t q0 = planes[4 * e], q1 = planes[4 * e + 1];
    const uint64_t q2 = planes[4 * e + 2], q3 = planes[4 * e + 3];
    for (; o <= last; ++o) {
      const uint64_t* w = win + 4 * o;
      const int64_t c = __popcll(w[0] & q0) + __popcll(w[1] & q1) +
                        __popcll(w[2] & q2) + __popcll(w[3] & q3);
      if (c >= ln_e) {
        first = o;
        break;
      }
    }
  }
  uint8_t out = 0;
  if (first >= 0) {
    int64_t d2 = len - ln_e - (first + sh);
    d2 = d2 < 0 ? 0 : (d2 > W - 1 ? W - 1 : d2);
    out = trig[e * W + d2] != 0;
  }
  fired[t * E + e] = out;
}

}  // namespace

// masks uint8 [T, L] (4-bit base sets), lens int64 [T], planes int64
// [E, 4], ln and shift int64 [E], trig bool [E, W]; fired bool [T, E].
extern "C" int dimer_fired_launch(const void* masks, const void* lens,
                                  const void* planes, const void* ln,
                                  const void* shift, const void* trig,
                                  void* fired, int64_t T, int64_t L,
                                  int64_t E, int64_t W, int lp, int64_t z,
                                  void* stream) {
  const int64_t smem = (L - lp + 1 > 0 ? L - lp + 1 : 0) * 32;
  if (lp < 1 || lp > kMaxLp || W < 1 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || E <= 0) return static_cast<int>(cudaSuccess);
  const int64_t e_chunks = (E + kThreads - 1) / kThreads;
  const int64_t blocks = T * e_chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dimer_fired_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dimer_fired_kernel<<<static_cast<unsigned>(blocks), kThreads,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const int64_t*>(lens),
      static_cast<const uint64_t*>(planes), static_cast<const int64_t*>(ln),
      static_cast<const int64_t*>(shift), static_cast<const uint8_t*>(trig),
      static_cast<uint8_t*>(fired), L, E, W, lp, z, e_chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dimer_fired_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
