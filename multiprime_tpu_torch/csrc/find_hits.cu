// Sparse hit list of the mismatch coverage scan, for Hopper (sm_90a).
//
// Replaces the jitted program multiprime_tpu/ops/mismatch_scan.py
// find_hits (:462-518): the hit codes of hit_codes_conv / hit_codes_pallas,
// the window-length mask (o + plen <= lengths[n]) and the two-level
// compaction into
//
//   hit_idx [max_hits]  the ascending flat indices n * O * P + o * P + p of
//                       the first max_hits hits, -1 padding (int64)
//   n_hits              the count of all hits (0-d int64)
//   mism    [max_hits]  their mismatches, -1 padding (int64)
//
// with no [N, O, P] codes tensor: the hits come straight from the int8
// tensor-core window product of hit_codes.cu (window_mma.cuh: the staged
// row, mma.sync m16n8k32, the row maxima, the suffix test of candidates).
//
// Three kernels on one grid of blocks, each block tw windows of one row x
// every pattern, as hit_codes.cu cuts it: a block's flat indices are one
// contiguous span, and block order is flat order.
//
//   1. find_hits_count_kernel: each block counts its hits (int32), and a
//      block whose windows all lie past its row's length counts 0 without
//      staging its row (padding rows cost nothing).
//   2. find_hits_scan_kernel: one CTA turns the counts into each block's
//      int64 offset (an exclusive scan in block order) and n_hits.
//   3. find_hits_write_kernel: every block writes its share of the -1
//      padding of [min(n_hits, max_hits), max_hits); each block whose span
//      [offset, offset + count) meets [0, max_hits) computes its tile
//      again, lists the hits in shared memory keyed r * P + p (with the
//      mismatches in the low 7 bits), sorts the list (bitonic) and writes
//      hit i at offset + i.  A block with more than kHitCap hits counts its
//      hits a row first, then lists them in rounds of key ranges that hold
//      at most kHitCap hits each: whole rows while their counts fit, a row
//      alone in slices of kHitCap patterns.
//
// What bounds it: operations.  The window product is 2 * N * O * P * 4 *
// plen int8 operations (1.1e11 at the specificity batch [16, 65,519] x
// 744, 57 us at the tensor cores' 1,979 TOP/s); the bytes are the masks
// (N * L) and the two hit lists.  The codes tensor of hit_codes plus the
// torch compaction moved N * O * P bytes and more several times; here the
// product runs twice for a block with hits that lies below max_hits and
// once for every other block.  Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_mma.cuh"

namespace {

using namespace window_mma;

constexpr int kMaxTile = 1024;  // windows per block
constexpr int kWaves = 8;       // blocks per SM the window tile aims for
constexpr int kHitCap = 1024;   // hits a block sorts in shared memory at once
constexpr int kScanThreads = 1024;
constexpr int kPadPerBlock = 4096;  // padding entries a write block takes

// The tile of one block: row n, first window o0, tile windows of which the
// first `valid` lie inside the row's length.
struct Tile {
  int64_t n, o0;
  int tile, valid;
};

__device__ __forceinline__ Tile tile_of(const void* lengths, int len64,
                                        int64_t O, int n_wt, int tw,
                                        int plen) {
  Tile t;
  t.n = blockIdx.x / n_wt;
  t.o0 = (blockIdx.x % n_wt) * static_cast<int64_t>(tw);
  t.tile = static_cast<int>(O - t.o0 < tw ? O - t.o0 : tw);
  const int64_t len = len64 ? static_cast<const int64_t*>(lengths)[t.n]
                            : static_cast<const int32_t*>(lengths)[t.n];
  // windows o with o + plen <= len, the JAX package's window mask
  const int64_t inside = len - plen + 1 - t.o0;
  t.valid = static_cast<int>(inside < t.tile ? (inside > 0 ? inside : 0)
                                             : t.tile);
  return t;
}

// Call f(r, p, mism) for every hit of the staged tile's first `valid`
// windows: counts >= plen - mm and, for term > 0, suffix >= term (the
// mm/term rule of hit_codes.cu).  Every thread of the block calls this;
// the order of the calls is not the flat order.
template <int KS, typename F>
__device__ __forceinline__ void for_each_hit(
    const uint32_t* words, const uint32_t* bits, int nw, int valid,
    const uint64_t* __restrict__ planes, const uint64_t* __restrict__ suffix,
    int64_t P, int plen, int mm, int term, F&& f) {
  constexpr int NB = tiles_per_warp(KS);
  constexpr int kPass = 8 * kWarps * NB;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int thr = plen - mm;
  const uint64_t keep = plen_mask(plen);
  for (int64_t p0 = 0; p0 < P; p0 += kPass) {
    const int cnt = static_cast<int>(P - p0 < kPass ? P - p0 : kPass);
    const WarpSplit ws = split_warps((cnt + 7) / 8, NB);
    if (ws.n_cnt == 0) continue;
    uint32_t b[NB][KS][2];
    load_b<KS, NB>(b, planes, p0 + 8 * ws.n_first, P, ws.n_cnt, keep);
    const int64_t col0 = p0 + 8 * ws.n_first + 2 * tig;  // lane's first pattern
    for (int mt = ws.wm; 16 * mt < valid; mt += ws.n_wm) {
      int acc[NB][4];
      count_tile<KS, NB>(acc, words, 16 * mt, b, ws.n_cnt);
      int top[2];
      row_tops<NB>(&acc[0][0], ws.n_cnt, top);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        if (top[h] < thr || r >= valid) continue;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (j >= ws.n_cnt) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t p = col0 + 8 * j + e;
            const int c = acc[j][2 * h + e];
            if (c < thr || p >= P ||
                (term > 0 &&
                 suffix_count(bits, nw, r, suffix + 4 * p, keep) < term))
              continue;
            f(r, p, plen - c);
          }
        }
      }
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
find_hits_count_kernel(const uint8_t* __restrict__ masks,    // [N, L] IUPAC
                       const void* __restrict__ lengths,     // [N]
                       const uint64_t* __restrict__ planes,  // [P, 4]
                       const uint64_t* __restrict__ suffix,  // [P, 4]
                       int* __restrict__ counts,             // [blocks]
                       int len64, int64_t L, int64_t O, int64_t P, int n_wt,
                       int tw, int plen, int mm, int term) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int span = segment_len(tw), nw = span / 32;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  uint32_t* bits = words + span;
  __shared__ int total;
  const Tile t = tile_of(lengths, len64, O, n_wt, tw, plen);
  if (t.valid == 0) {
    if (threadIdx.x == 0) counts[blockIdx.x] = 0;
    return;
  }
  if (threadIdx.x == 0) total = 0;
  stage_row<true>(masks + t.n * L + t.o0, L - t.o0, span, words, bits);
  __syncthreads();
  int mine = 0;
  for_each_hit<KS>(words, bits, nw, t.valid, planes, suffix, P, plen, mm,
                   term, [&](int, int64_t, int) { ++mine; });
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&total, mine);
  __syncthreads();
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// One CTA: offsets[b] = counts[0] + .. + counts[b - 1], *n_hits = the sum
// of all, four counts a thread per step of kScanThreads * 4.
__global__ void __launch_bounds__(kScanThreads)
find_hits_scan_kernel(const int* __restrict__ counts, int64_t blocks,
                      int64_t* __restrict__ offsets,
                      int64_t* __restrict__ n_hits) {
  __shared__ int64_t warp_sum[kScanThreads / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < blocks; base += 4 * kScanThreads) {
    const int64_t i0 = base + 4 * static_cast<int64_t>(threadIdx.x);
    int64_t v[4], s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = i0 + k < blocks ? counts[i0 + k] : 0;
      s += v[k];
    }
    int64_t x = s;  // inclusive scan of the warp's sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int64_t w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    int64_t at = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - s;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i0 + k < blocks) offsets[i0 + k] = at;
      at += v[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_hits = carry;
}

// Ascending bitonic sort of list[0 .. m2), m2 a power of two; every thread
// of the block calls this.
__device__ __forceinline__ void sort_list(uint64_t* list, int m2) {
  for (int k = 2; k <= m2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < m2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = list[i], b = list[ixj];
          if ((a > b) == ((i & k) == 0)) {
            list[i] = b;
            list[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
find_hits_write_kernel(const uint8_t* __restrict__ masks,
                       const void* __restrict__ lengths,
                       const uint64_t* __restrict__ planes,
                       const uint64_t* __restrict__ suffix,
                       const int* __restrict__ counts,
                       const int64_t* __restrict__ offsets,
                       const int64_t* __restrict__ n_hits,
                       int64_t* __restrict__ hit_idx,   // [max_hits]
                       int64_t* __restrict__ mism,      // [max_hits]
                       int64_t max_hits, int64_t blocks, int len64,
                       int64_t L, int64_t O, int64_t P, int n_wt, int tw,
                       int plen, int mm, int term) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t list[kHitCap];
  __shared__ int row_cnt[kMaxTile];
  __shared__ int n_list;
  __shared__ int64_t round_lo, round_hi;
  // the padding past the hits, shared by every block of the grid
  const int64_t total = *n_hits;
  const int64_t lim = total < max_hits ? total : max_hits;
  for (int64_t i = lim + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < max_hits; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    hit_idx[i] = -1;
    mism[i] = -1;
  }
  if (blockIdx.x >= blocks) return;
  const int cnt = counts[blockIdx.x];
  const int64_t off = offsets[blockIdx.x];
  if (cnt == 0 || off >= max_hits) return;

  const int span = segment_len(tw), nw = span / 32;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  uint32_t* bits = words + span;
  const Tile t = tile_of(lengths, len64, O, n_wt, tw, plen);
  stage_row<true>(masks + t.n * L + t.o0, L - t.o0, span, words, bits);
  const int64_t base = (t.n * O + t.o0) * P;  // the block's first flat index
  const bool rounds = cnt > kHitCap;
  if (rounds) {
    for (int r = threadIdx.x; r < t.valid; r += blockDim.x) row_cnt[r] = 0;
    __syncthreads();
    for_each_hit<KS>(words, bits, nw, t.valid, planes, suffix, P, plen, mm,
                     term, [&](int r, int64_t, int) {
                       atomicAdd(&row_cnt[r], 1);
                     });
  }
  __syncthreads();
  // thread 0's cursor: the next key range starts at row rc, pattern pc
  int rc = 0;
  int64_t pc = 0;
  int64_t done = 0;
  while (done < cnt && off + done < max_hits) {
    if (threadIdx.x == 0) {
      int64_t lo = 0, hi = INT64_MAX;
      if (rounds) {
        lo = rc * P + pc;
        if (pc == 0) {
          // whole rows while their hits fit the list
          int re = rc, sum = 0;
          while (re < t.valid && sum + row_cnt[re] <= kHitCap)
            sum += row_cnt[re++];
          if (re > rc) {
            hi = re * P;
            rc = re;
          } else {
            pc = P < kHitCap ? P : kHitCap;  // a row alone: kHitCap patterns
            hi = rc * P + pc;
          }
        } else {
          pc = P - pc < kHitCap ? P : pc + kHitCap;
          hi = rc * P + pc;
        }
        if (pc == P) {
          ++rc;
          pc = 0;
        }
        if (lo >= static_cast<int64_t>(t.valid) * P) hi = lo;  // past the tile
      }
      round_lo = lo;
      round_hi = hi;
      n_list = 0;
    }
    __syncthreads();
    const int64_t lo = round_lo, hi = round_hi;
    if (lo >= hi) break;
    for_each_hit<KS>(words, bits, nw, t.valid, planes, suffix, P, plen, mm,
                     term, [&](int r, int64_t p, int m) {
                       const int64_t key = r * P + p;
                       if (key < lo || key >= hi) return;
                       const int i = atomicAdd(&n_list, 1);
                       if (i < kHitCap)
                         list[i] = (static_cast<uint64_t>(key) << 7) |
                                   static_cast<uint64_t>(m);
                     });
    __syncthreads();
    const int m = n_list < kHitCap ? n_list : kHitCap;
    int m2 = 1;
    while (m2 < m) m2 <<= 1;
    for (int i = m + threadIdx.x; i < m2; i += blockDim.x) list[i] = ~0ull;
    __syncthreads();
    sort_list(list, m2);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int64_t at = off + done + i;
      if (at < max_hits) {
        const uint64_t key = list[i];
        hit_idx[at] = base + static_cast<int64_t>(key >> 7);
        mism[at] = static_cast<int64_t>(key & 127);
      }
    }
    done += m;
    __syncthreads();
    if (!rounds) break;
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// the window tile of hit_codes.cu's launch: a whole row (at most kMaxTile)
// unless that leaves fewer than kWaves blocks per SM
int64_t tile_windows(int64_t n, int64_t O) {
  const int64_t sms = sm_count();
  int64_t tw = (O + 15) / 16 * 16;
  if (tw > kMaxTile) tw = kMaxTile;
  while (tw > 64 && n * ((O + tw - 1) / tw) < kWaves * sms)
    tw = (tw / 2 + 15) / 16 * 16;
  return tw;
}

template <int KS>
int launch(const uint8_t* m, const void* lens, int len64, const uint64_t* q,
           const uint64_t* s, int* counts, int64_t* offsets, int64_t* n_hits,
           int64_t* idx, int64_t* mism, int64_t n, int64_t L, int64_t P,
           int plen, int mm, int term, int64_t max_hits, cudaStream_t st) {
  const int64_t O = L - plen + 1;
  const bool any = n > 0 && O > 0 && P > 0;
  const int64_t tw = any ? tile_windows(n, O) : 16;
  const int64_t n_wt = any ? (O + tw - 1) / tw : 0;
  const int64_t blocks = n * n_wt;
  int64_t grid = (max_hits + kPadPerBlock - 1) / kPadPerBlock;
  if (grid < blocks) grid = blocks;
  if (grid < 1) grid = 1;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int t = static_cast<int>(tw), smem = segment_bytes(t);
  if (blocks > 0) {
    find_hits_count_kernel<KS><<<static_cast<unsigned>(blocks), kThreads,
                                 smem, st>>>(
        m, lens, q, s, counts, len64, L, O, P, static_cast<int>(n_wt), t,
        plen, mm, term);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  find_hits_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, blocks, offsets,
                                                    n_hits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  find_hits_write_kernel<KS><<<static_cast<unsigned>(grid), kThreads, smem,
                               st>>>(
      m, lens, q, s, counts, offsets, n_hits, idx, mism, max_hits, blocks,
      len64, L, O, P, static_cast<int>(n_wt), t, plen, mm, term);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// masks uint8 [n, L], lengths [n] (int64 when len64, else int32), planes
// and suffix int64 [P, 4]; counts int32 and offsets int64 scratch of
// `scratch` entries, at least n * ceil(O / 16) (a tile is never below 16
// windows) and 1; n_hits int64 [1]; hit_idx and mism int64 [max_hits].
extern "C" int find_hits_launch(const void* masks, const void* lengths,
                                int len64, const void* planes,
                                const void* suffix, void* counts,
                                void* offsets, int64_t scratch, void* n_hits,
                                void* hit_idx, void* mism, int64_t n,
                                int64_t L, int64_t P, int plen, int mm,
                                int term, int64_t max_hits, void* stream) {
  const int64_t O = L - plen + 1;
  if (plen < 1 || plen > kMaxPlen || max_hits < 0 || scratch < 1 ||
      (O > 0 && scratch < n * ((O + 15) / 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* m = static_cast<const uint8_t*>(masks);
  const auto* q = static_cast<const uint64_t*>(planes);
  const auto* s = static_cast<const uint64_t*>(suffix);
  auto* c = static_cast<int*>(counts);
  auto* o = static_cast<int64_t*>(offsets);
  auto* h = static_cast<int64_t*>(n_hits);
  auto* idx = static_cast<int64_t*>(hit_idx);
  auto* mi = static_cast<int64_t*>(mism);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((plen + 7) / 8) {
#define FIND_HITS_CASE(ks)                                                  \
  case ks:                                                                  \
    return launch<ks>(m, lengths, len64, q, s, c, o, h, idx, mi, n, L, P,   \
                      plen, mm, term, max_hits, st);
    FIND_HITS_CASE(1)
    FIND_HITS_CASE(2)
    FIND_HITS_CASE(3)
    FIND_HITS_CASE(4)
    FIND_HITS_CASE(5)
    FIND_HITS_CASE(6)
    FIND_HITS_CASE(7)
#undef FIND_HITS_CASE
    default:
      return launch<8>(m, lengths, len64, q, s, c, o, h, idx, mi, n, L, P,
                       plen, mm, term, max_hits, st);
  }
}

extern "C" const char* find_hits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
