// Window x pattern products on the int8 tensor cores, shared by the scan
// kernels hit_codes.cu (mma.sync, everything below) and
// hit_window_bitmap.cu (wgmma, whose per-warp A fragment is the one below;
// it takes the staged row, the suffix test and the row maxima from here)
// (sm_90a).
//
// Both kernels need, for every window w of a target row and every pattern
// p, the count of (position, base) pairs that both hold:
//
//   count[w, p] = sum over k < plen, b < 4 of T[w + k, b] * Q[p, k, b]
//
// an int8 product of the windows' one-hots A [windows, 4 * plen] with the
// patterns' one-hots B [4 * plen, P], in the contraction order of the
// Pallas kernels, k = 4 * position + base.  It runs as
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: one instruction covers
// 16 windows x 8 patterns x 8 positions.
//
// A without an im2col.  A block stages its row segment in shared memory as
// one uint32 per position, the position's four one-hot bytes (byte b = bit b
// of the 4-bit mask).  Row w of A at k-step s is then the words
// w + 8s .. w + 8s + 7, so each A fragment register is one 4-byte-aligned
// shared load (PTX ISA fragment layout of m16n8k32 .s8 A: register 0 holds
// row groupID, columns 4 * tig .. +3; register 1 row groupID + 8; registers
// 2 and 3 the same rows at columns 16 + 4 * tig):
//
//   a0 = word[r + 8s + tig]     a1 = word[r + 8 + 8s + tig]
//   a2 = word[r + 8s + 4 + tig] a3 = word[r + 8 + 8s + 4 + tig]
//
// for r = 16 * m_tile + groupID.  The 32 lanes read the words g + tig + c
// (c fixed): distinct words fall in distinct banks, equal words broadcast,
// so the loads are free of bank conflicts.
//
// B from the bit-planes, in registers.  The B fragment (col layout) gives a
// lane pattern n = groupID and rows 4 * tig .. +3 (register 0) and
// 16 + 4 * tig .. +3 (register 1): the four base bytes of positions
// 8s + tig and 8s + 4 + tig, byte b = (plane[p][b] >> pos) & 1.  Each warp
// builds the fragments of its pattern slice once and keeps them in
// registers while it walks the block's window tiles.
//
// K is padded to KS = ceil(plen / 8) k-steps of 32 bytes (72 -> 96 at
// plen 18, 252 -> 256 at plen 63).  Positions at or past plen get zero pattern
// bytes, so whatever the padded A columns hold adds 0; the staged segment
// is zero past the row's end, so the over-read stays in shared memory.
//
// The suffix test (a candidate's 3'-suffix count) reads the same segment as
// four bit-streams, one per base (bit j of stream b = bit b of the mask at
// position j), built with warp ballots while staging: a window's 64-bit
// plane is a funnel shift of three stream words.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "window_planes.cuh"

namespace window_mma {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPlen = 63;     // suffix planes are 64-bit; bit 63 stays clear

// n-tiles of 8 patterns a warp holds in registers: B takes 2 * KS * NB
// registers and the accumulators 4 * NB, at most 60 in all; with the rest
// this fits the 128 registers of two blocks an SM, but for a few spilled
// bytes at some KS (chip_smoke.py's build phase prints them)
__host__ __device__ constexpr int tiles_per_warp(int ks) {
  return 24 / ks < 6 ? 24 / ks : 6;
}

// segment of a window tile of tw windows: every position an A load or a
// 64-bit suffix window can touch, in whole warps
__host__ __device__ constexpr int segment_len(int tw) {
  return (tw + 64 + 31) / 32 * 32;
}

// bytes of shared memory of the staged segment: words, then four streams
__host__ __device__ constexpr int segment_bytes(int tw) {
  return segment_len(tw) * 4 + segment_len(tw) / 2;
}

// the four one-hot bytes of a 4-bit mask: byte b = bit b of m
__device__ __forceinline__ uint32_t onehot_word(uint32_t m) {
  return (m * 0x00204081u) & 0x01010101u;
}

// Stage row[0 .. span) (zero at and past avail) into words[span] and the
// four bit-streams bits[4][span / 32].  Pure: a mask that is not one base
// becomes 0 (the purity rule of expand_masks); else the low four bits are
// kept, every base a base set holds.  span is a multiple of 32 and every
// warp of the block calls this.
template <bool kPure>
__device__ __forceinline__ void stage_row(const uint8_t* __restrict__ row,
                                          int64_t avail, int span,
                                          uint32_t* words, uint32_t* bits) {
  const int nw = span / 32;
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const uint32_t raw = j < avail ? row[j] : 0u;
    const uint32_t m = kPure ? pure_base(static_cast<uint8_t>(raw)) : raw & 15u;
    words[j] = onehot_word(m);
    const uint32_t b0 = __ballot_sync(0xffffffffu, m & 1u);
    const uint32_t b1 = __ballot_sync(0xffffffffu, m & 2u);
    const uint32_t b2 = __ballot_sync(0xffffffffu, m & 4u);
    const uint32_t b3 = __ballot_sync(0xffffffffu, m & 8u);
    if ((threadIdx.x & 31) == 0) {
      bits[j >> 5] = b0;
      bits[nw + (j >> 5)] = b1;
      bits[2 * nw + (j >> 5)] = b2;
      bits[3 * nw + (j >> 5)] = b3;
    }
  }
}

// 64 bits of a stream starting at bit w
__device__ __forceinline__ uint64_t stream64(const uint32_t* s, int w) {
  const int i = w >> 5, sh = w & 31;
  const uint64_t lo = static_cast<uint64_t>(s[i]) |
                      (static_cast<uint64_t>(s[i + 1]) << 32);
  return sh ? (lo >> sh) | (static_cast<uint64_t>(s[i + 2]) << (64 - sh)) : lo;
}

// Shared (position, base) pairs of window w and suffix planes sfx[4] (only
// bits below plen, so the positions past the window add 0).
__device__ __forceinline__ int suffix_count(const uint32_t* bits, int nw, int w,
                                            const uint64_t* __restrict__ sfx,
                                            uint64_t keep) {
  int c = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    c += __popcll(stream64(bits + b * nw, w) & __ldg(sfx + b) & keep);
  return c;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// How the block's warps share a tile of nt n-tiles and its window m-tiles:
// WN pattern slices (a power of two, as few as hold the tile) times WM
// window strides.  Needs nt <= kWarps * NB.
struct WarpSplit {
  int wm, n_wm;        // this warp's first m-tile and the m-tile stride
  int n_first, n_cnt;  // this warp's n-tiles
};

__device__ __forceinline__ WarpSplit split_warps(int nt, int nb) {
  int wn = 1;
  while (wn < kWarps && wn * nb < nt) wn *= 2;
  const int warp = threadIdx.x >> 5;
  const int per = (nt + wn - 1) / wn;
  WarpSplit s;
  s.n_wm = kWarps / wn;
  s.wm = warp / wn;
  s.n_first = (warp % wn) * per;
  s.n_cnt = max(0, min(per, nt - s.n_first));
  return s;
}

// The B fragments of n-tiles [0, n_cnt) starting at pattern p_first (8 a
// tile); patterns at or past P and positions at or past plen are zero.  A
// lane needs positions tig + 4m (m = 2s + h): shifted down by tig and
// masked to every fourth bit, the four planes interleave into one word
// whose nibble m holds the four bases of position tig + 4m.
template <int KS, int NB>
__device__ __forceinline__ void load_b(uint32_t (&b)[NB][KS][2],
                                       const uint64_t* __restrict__ planes,
                                       int64_t p_first, int64_t P, int n_cnt,
                                       uint64_t keep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  constexpr uint64_t kEvery4 = 0x1111111111111111ull;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int64_t p = p_first + 8 * j + g;
    uint64_t y = 0;
    if (j < n_cnt && p < P) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        y |= (((__ldg(planes + 4 * p + k) & keep) >> tig) & kEvery4) << k;
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      b[j][s][0] = onehot_word(static_cast<uint32_t>(y >> (8 * s)) & 15u);
      b[j][s][1] = onehot_word(static_cast<uint32_t>(y >> (8 * s + 4)) & 15u);
      // opaque to the compiler, so it keeps the fragments in registers
      // rather than rebuilding them from y at every mma
      asm volatile("" : "+r"(b[j][s][0]), "+r"(b[j][s][1]));
    }
  }
}

// The counts of m-tile rows row0 .. row0 + 15 (row0 a multiple of 16)
// against the warp's n-tiles: acc[j] is the C fragment of n-tile j
// (c0, c1: row groupID, columns 2 * tig, +1; c2, c3: row groupID + 8).
template <int KS, int NB>
__device__ __forceinline__ void count_tile(int (&acc)[NB][4],
                                           const uint32_t* words, int row0,
                                           const uint32_t (&b)[NB][KS][2],
                                           int n_cnt) {
  const int lane = threadIdx.x & 31;
  const uint32_t* a = words + row0 + (lane >> 2) + (lane & 3);
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint32_t a0 = a[8 * s], a1 = a[8 * s + 8];
    const uint32_t a2 = a[8 * s + 4], a3 = a[8 * s + 12];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n_cnt) mma_s8(acc[j], a0, a1, a2, a3, b[j][s][0], b[j][s][1]);
  }
}

// The largest count of each of the lane's two rows (groupID, groupID + 8)
// over its first n_cnt n-tiles, whose C fragments lie in c[4 * j .. + 3]
// (the layout of mma.sync m16n8k32 and of a wgmma accumulator alike):
// Hopper's three-input integer max (__vimax3_s32, DPX), one instruction a
// row an n-tile.
template <int NT>
__device__ __forceinline__ void row_tops(const int* c, int n_cnt,
                                         int (&top)[2]) {
  top[0] = top[1] = -1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= n_cnt) break;
    top[0] = __vimax3_s32(c[4 * j], c[4 * j + 1], top[0]);
    top[1] = __vimax3_s32(c[4 * j + 2], c[4 * j + 3], top[1]);
  }
}

// mask of the plane bits below plen
__device__ __forceinline__ uint64_t plen_mask(int plen) {
  return plen >= 64 ? ~0ull : (1ull << plen) - 1;
}

}  // namespace window_mma
