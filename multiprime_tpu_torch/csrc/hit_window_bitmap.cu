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
// TPU kernel's matmul does, a count takes every base a window position
// shares with the pattern, so a position with several bases counts once per
// shared base and counts may exceed plen.
//
// What bounds it: operations.  It reads N*L bytes and writes N*O, but needs
// up to O*P (window, pattern) pairs per sequence.  The earlier form of this
// kernel tested a pair with four popcounts on the CUDA cores and issued at
// the popcount rate; this one computes the counts as the TPU kernel did, as
// one int8 product of the windows' one-hots with the patterns', on the
// tensor cores at their Hopper rate: wgmma.mma_async m64n64k32, A (64
// windows x 32 bytes) from registers, B (32 bytes x 64 patterns) from
// shared memory.  A block is one warpgroup.  It builds B for a pass of up
// to 24 KB of patterns (no swizzle: core matrices of 8 patterns x 16 bytes,
// 128 bytes each, the K neighbour 128 bytes on and the N neighbour 32 * KS
// * 4 bytes on), then scans 4 row tiles of up to 1,024 windows with it, so
// the build is paid once per 4 rows and a pass.  The A registers of a warp
// are its 16 rows of the staged segment, read as in window_mma.cuh (the
// per-warp A fragment of wgmma is that of mma.sync m16n8k32), and stay in
// registers across the pass's 64-pattern chunks.  The epilogue of a chunk
// is two instructions an n-tile: Hopper's three-input integer max
// (__vimax3_s32, DPX) folds a lane's counts of each of its two rows into a
// row maximum, compared once with plen - mm.  Only a row with a candidate
// walks its counts again and runs the suffix test (four popcounts of the
// window's bit-streams against the pattern's suffix planes) on the
// candidates; a hit sets the window's flag in shared memory.  The block
// skips a 64-window tile whose windows all hit (__syncthreads_and).  The
// products of one chunk are waited for before the next is issued: issuing
// one ahead makes the compiler serialise them (the candidate branch sits
// between), so overlap comes from the 6 blocks an SM instead.  K is padded
// to 32 * KS bytes (96 at plen 18).  Zero (padding) pattern rows never hit
// while mm < plen, as on the TPU.
//
// No window-length mask here: the caller (hit_window_bitmap) applies it.
// Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_mma.cuh"

namespace {

using namespace window_mma;

constexpr int kWgThreads = 128;          // one warpgroup a block
constexpr int kMaxTile = 1024;           // windows per row tile
constexpr int kRowsPerBlock = 4;         // row tiles a block scans with one B
constexpr int kChunk = 64;               // patterns a product (N of m64nNk32)
constexpr int kPassBytes = 24 * 1024;    // shared bytes of B a pass

// the shared-memory matrix descriptor of wgmma, no swizzle
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d[64 x 64] (+)= A[64 x 32] (registers) x B[32 x 64] (shared), int8
__device__ __forceinline__ void wgmma_64x64x32(int (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <int KS>
__global__ void __launch_bounds__(kWgThreads)
hit_window_bitmap_kernel(const uint8_t* __restrict__ masks,    // [N, L]
                         const uint64_t* __restrict__ planes,  // [P, 4]
                         const uint64_t* __restrict__ suffix,  // [P, 4]
                         int8_t* __restrict__ bitmap,          // [N, O]
                         int64_t L, int64_t O, int64_t P, int64_t n_tiles,
                         int n_wt, int tw, int npp, int plen, int mm, int term) {
  constexpr int KB = 2 * KS;  // 16-byte core-matrix columns of K = 32 * KS
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* bsm = smem;                                      // [npp / 8][KB][8][16]
  const int span = segment_len(tw), nw = span / 32;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + npp * 32 * KS);
  uint32_t* bits = words + span;
  volatile uint8_t* found = reinterpret_cast<uint8_t*>(bits + 4 * nw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int thr = plen - mm;
  const uint64_t keep = plen_mask(plen);
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int n_rows = static_cast<int>(n_tiles - t0 < kRowsPerBlock ? n_tiles - t0 : kRowsPerBlock);

  // windows past a row's last have nothing to find
  for (int t = 0; t < n_rows; ++t) {
    const int64_t o0 = ((t0 + t) % n_wt) * static_cast<int64_t>(tw);
    const int tile = static_cast<int>(O - o0 < tw ? O - o0 : tw);
    for (int w = threadIdx.x; w < tw; w += blockDim.x) found[t * tw + w] = w >= tile;
  }
  for (int64_t p0 = 0; p0 < P; p0 += npp) {
    const int cnt = static_cast<int>(P - p0 < npp ? P - p0 : npp);
    const int chunks = (cnt + kChunk - 1) / kChunk;
    __syncthreads();  // the previous pass's products are done with B
    // B: pattern pl's bytes 16 kb .. 16 kb + 15 (positions 4 kb .. +3, four
    // bases each) are row pl % 8 of core matrix (pl / 8, kb)
    for (int i = threadIdx.x; i < chunks * kChunk * KB; i += blockDim.x) {
      const int pl = i / KB, kb = i % KB;
      const int64_t p = p0 + pl;
      uint32_t w[4] = {0, 0, 0, 0};
      if (pl < cnt) {
        uint64_t x[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) x[b] = (__ldg(planes + 4 * p + b) & keep) >> (4 * kb);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            w[k] |= static_cast<uint32_t>((x[b] >> k) & 1u) << (8 * b);
      }
      *reinterpret_cast<uint4*>(bsm + ((pl / 8) * KB + kb) * 128 + (pl % 8) * 16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

    for (int t = 0; t < n_rows; ++t) {
      const int64_t n = (t0 + t) / n_wt;
      const int64_t o0 = ((t0 + t) % n_wt) * static_cast<int64_t>(tw);
      const int tile = static_cast<int>(O - o0 < tw ? O - o0 : tw);
      volatile uint8_t* fnd = found + t * tw;
      __syncthreads();  // B is written; the previous row's reads are done
      stage_row<false>(masks + n * L + o0, L - o0, span, words, bits);
      __syncthreads();
      for (int m0 = 0; m0 < tile; m0 += 64) {
        const int r0 = m0 + 16 * warp + g;
        if (__syncthreads_and(fnd[r0] && fnd[r0 + 8])) continue;
        uint32_t a[KS][4];
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          a[s][0] = words[r0 + 8 * s + tig];
          a[s][1] = words[r0 + 8 + 8 * s + tig];
          a[s][2] = words[r0 + 8 * s + 4 + tig];
          a[s][3] = words[r0 + 8 + 8 * s + 4 + tig];
        }
        for (int c = 0; c < chunks; ++c) {
          int d[kChunk / 2];
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int s = 0; s < KS; ++s)
            wgmma_64x64x32(d, a[s],
                           smem_desc(bsm + (kChunk / 8 * c * KB + 2 * s) * 128,
                                     128, KB * 128),
                           s);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          // the counts are read only after the wait
#pragma unroll
          for (int i = 0; i < kChunk / 2; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
          int top[2];
          row_tops<kChunk / 8>(d, kChunk / 8, top);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (top[h] < thr || fnd[r]) continue;
#pragma unroll
            for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int pl = kChunk * c + 8 * j + 2 * tig + e;
                if (d[4 * j + 2 * h + e] >= thr && pl < cnt &&
                    (term <= 0 ||
                     suffix_count(bits, nw, r, suffix + 4 * (p0 + pl), keep) >= term))
                  fnd[r] = 1;
              }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int t = 0; t < n_rows; ++t) {
    const int64_t n = (t0 + t) / n_wt;
    const int64_t o0 = ((t0 + t) % n_wt) * static_cast<int64_t>(tw);
    const int tile = static_cast<int>(O - o0 < tw ? O - o0 : tw);
    for (int w = threadIdx.x; w < tile; w += blockDim.x)
      bitmap[n * O + o0 + w] = static_cast<int8_t>(found[t * tw + w]);
  }
}

template <int KS>
int launch(const uint8_t* m, const uint64_t* q, const uint64_t* s, int8_t* out,
           int64_t n, int64_t L, int64_t O, int64_t P, int plen, int mm,
           int term, cudaStream_t st) {
  const int64_t o64 = (O + 63) / 64 * 64;
  const int tw = static_cast<int>(o64 < kMaxTile ? o64 : kMaxTile);
  const int64_t n_wt = (O + tw - 1) / tw;
  const int64_t n_tiles = n * n_wt;
  const int64_t blocks = (n_tiles + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t p64 = (P + kChunk - 1) / kChunk * kChunk;
  const int64_t cap = kPassBytes / (32 * KS) / kChunk * kChunk;
  const int npp = static_cast<int>(p64 < cap ? (p64 > 0 ? p64 : kChunk) : cap);
  // at most 24 KB of B, 4.9 KB of staged row and 4 KB of flags: below the
  // 48 KB a launch may ask for without an attribute
  const int smem = npp * 32 * KS + segment_bytes(tw) + kRowsPerBlock * tw;
  hit_window_bitmap_kernel<KS><<<static_cast<unsigned>(blocks), kWgThreads, smem, st>>>(
      m, q, s, out, L, O, P, n_tiles, static_cast<int>(n_wt), tw, npp, plen, mm, term);
  return static_cast<int>(cudaGetLastError());
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
  const auto* m = static_cast<const uint8_t*>(masks);
  const auto* q = static_cast<const uint64_t*>(planes);
  const auto* s = static_cast<const uint64_t*>(suffix);
  auto* out = static_cast<int8_t*>(bitmap);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((plen + 7) / 8) {
    case 1: return launch<1>(m, q, s, out, n, L, O, P, plen, mm, term, st);
    case 2: return launch<2>(m, q, s, out, n, L, O, P, plen, mm, term, st);
    case 3: return launch<3>(m, q, s, out, n, L, O, P, plen, mm, term, st);
    case 4: return launch<4>(m, q, s, out, n, L, O, P, plen, mm, term, st);
    case 5: return launch<5>(m, q, s, out, n, L, O, P, plen, mm, term, st);
    case 6: return launch<6>(m, q, s, out, n, L, O, P, plen, mm, term, st);
    case 7: return launch<7>(m, q, s, out, n, L, O, P, plen, mm, term, st);
    default: return launch<8>(m, q, s, out, n, L, O, P, plen, mm, term, st);
  }
}

extern "C" const char* hit_window_bitmap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
