// The packed pointer words of the DP warp kernels (gotoh_dp.cu,
// refine_dp.cu): a lane's K pointer bytes of a row, four to a register.

#pragma once

#include <cstdint>

// One lane's packed pointer words (4 bytes each, K / 4 of them) stored at
// dst, as 16-byte stores where K % 16 == 0, else 8-byte ones (dst is
// aligned to 8 * (K / 8) bytes).
template <int K>
__device__ __forceinline__ void store_words(uint8_t* dst,
                                            const uint32_t (&w)[K / 4]) {
  if constexpr (K % 16 == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int q = 0; q < K / 16; ++q)
      d[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else {
    uint2* d = reinterpret_cast<uint2*>(dst);
#pragma unroll
    for (int q = 0; q < K / 8; ++q) d[q] = make_uint2(w[2 * q], w[2 * q + 1]);
  }
}
