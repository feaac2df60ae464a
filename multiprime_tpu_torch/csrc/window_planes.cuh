// Window bit-planes of match_counts.cu and dimer_fired.cu, and the purity
// rule of the staged rows of window_mma.cuh (hit_codes.cu, find_hits.cu).
//
// A window of plen target positions is packed as four bit-planes, one per
// base: bit k of plane b is set iff bit b of the window's k-th 4-bit mask is
// set.  Patterns arrive packed the same way (pattern_planes in
// ops/mismatch_scan.py), so a (window, pattern) dot product is ANDs and
// popcounts.

#pragma once

#include <cstdint>

// The purity rule of expand_masks: a mask with exactly one base bit keeps
// it; ambiguity codes, gaps and padding match nothing.
__device__ __forceinline__ uint8_t pure_base(uint8_t m) {
  return (m == 1 || m == 2 || m == 4 || m == 8) ? m : 0;
}

// The planes of the window base[0 .. plen), plen <= bits of Word, into t
// (registers or shared memory: built in registers, stored once).
template <typename Word>
__device__ __forceinline__ void window_planes(const uint8_t* base, int plen,
                                              Word (&t)[4]) {
  Word b0 = 0, b1 = 0, b2 = 0, b3 = 0;
  for (int k = 0; k < plen; ++k) {
    const Word c = base[k];
    b0 |= (c & 1) << k;
    b1 |= ((c >> 1) & 1) << k;
    b2 |= ((c >> 2) & 1) << k;
    b3 |= ((c >> 3) & 1) << k;
  }
  t[0] = b0;
  t[1] = b1;
  t[2] = b2;
  t[3] = b3;
}
