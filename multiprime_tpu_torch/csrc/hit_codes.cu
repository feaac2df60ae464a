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
// Like the TPU kernel, the counts are one int8 product of the windows'
// one-hots with the patterns' ([.., 4 * plen] x [4 * plen, P]), here on the
// tensor cores with mma.sync m16n8k32 (window_mma.cuh: A read straight from
// the staged row, B built from the bit-planes into registers, K padded to a
// multiple of 32).  Only the counts go through the product.  A lane folds
// its counts of each of its two rows into a row maximum (__vimax3_s32, one
// DPX instruction an n-tile) and compares it once with plen - mm; only a
// row with a candidate (counts >= plen - mm, which is rare) looks at its
// pairs one by one, and only a candidate pays for its suffix test (four
// popcounts of the window's bit-streams against the pattern's suffix
// planes).  The exact rule suffix >= term is kept, so term = 0 and term >
// plen behave as in the JAX package.  The combined weight primers + 64 *
// suffix of hit_codes_conv would drop that test; it is not used, as it was
// not measured against this form.
//
// What bounds it: bytes.  It writes N*O*P int8 codes against N*L bytes of
// input; the product costs 1 to 8 tensor-core instructions per 128 pairs
// and the epilogue above a few more.  The codes are nearly all 0, so no
// code but a hit's is computed one by one: a block takes up to 1,024
// windows of one row and every pattern (in passes of 64 * NB patterns, NB
// n-tiles of 8 a warp), so its codes are one contiguous span of device
// memory.  The span is zeroed by bulk copies from shared zeros
// (cp.async.bulk, carried out by the tensor memory accelerator while the
// warps compute), and the hits' codes go to a list in shared memory and
// are written after the copies are done; a block whose hits overflow the
// list scans again and writes them directly.  Even blocks start their
// copies before they scan, odd blocks after, so that memory-bound and
// tensor-bound phases overlap across the waves rather than alternating.
// The window tile shrinks below a whole row only where the card would hold
// fewer than 8 blocks an SM: each block and pass builds its warps' B
// fragments again.  At the run's P = 24 (3 n-tiles) every warp takes every
// eighth window tile, at P >= 384 the 8 warps take 8 pattern slices.
//
// No window-length mask here: the caller (find_hits) applies it, as on the
// TPU.  Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_mma.cuh"

namespace {

using namespace window_mma;

constexpr int kMaxTile = 1024;  // windows per block
constexpr int kWaves = 8;   // blocks per SM the window tile aims for

constexpr int kZeroBytes = 16384;  // shared zeros, the source of the bulk copies
constexpr int kHitCap = 1024;     // hits a block lists while its span is zeroed

// Zero out[0 .. len) without holding the block: the bytes before the first
// and after the last 16-byte boundary by plain stores (any thread), the
// aligned middle by bulk copies from shared zeros that the tensor memory
// accelerator carries out while the warps compute (thread 0 issues them).
// The caller has zeroed `zeros`, fenced it for the async proxy and synced.
__device__ __forceinline__ void zero_span_async(int8_t* out, int64_t len,
                                                const int8_t* zeros) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(out);
  int64_t head = static_cast<int64_t>((16 - (a & 15)) & 15);
  if (head > len) head = len;
  const int64_t body = (len - head) / 16 * 16;
  const int64_t tail = head + body;
  for (int64_t x = threadIdx.x; x < head; x += blockDim.x) out[x] = 0;
  for (int64_t x = tail + threadIdx.x; x < len; x += blockDim.x) out[x] = 0;
  if (threadIdx.x == 0 && body > 0) {
    const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(zeros));
    for (int64_t off = 0; off < body; off += kZeroBytes) {
      const uint32_t n = static_cast<uint32_t>(
          body - off < kZeroBytes ? body - off : kZeroBytes);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          :: "l"(out + head + off), "r"(src), "r"(n) : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
}

// Thread 0 waits until its bulk copies are written, then orders them before
// the plain stores that follow (cross-proxy fence); the caller syncs.
__device__ __forceinline__ void zero_span_wait() {
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    asm volatile("fence.proxy.async;" ::: "memory");
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
hit_codes_kernel(const uint8_t* __restrict__ masks,      // [N, L] 4-bit IUPAC
                 const uint64_t* __restrict__ planes,    // [P, 4]
                 const uint64_t* __restrict__ suffix,    // [P, 4]
                 int8_t* __restrict__ codes,             // [N, O, P]
                 int64_t L, int64_t O, int64_t P, int n_wt, int tw, int plen,
                 int mm, int term) {
  constexpr int NB = tiles_per_warp(KS);
  extern __shared__ __align__(16) uint8_t smem[];
  const int span = segment_len(tw), nw = span / 32;
  int8_t* zeros = reinterpret_cast<int8_t*>(smem);
  uint64_t* hits = reinterpret_cast<uint64_t*>(smem + kZeroBytes);
  uint32_t* words = reinterpret_cast<uint32_t*>(hits + kHitCap);
  uint32_t* bits = words + span;
  __shared__ int n_hits;

  const int64_t n = blockIdx.x / n_wt;
  const int64_t o0 = (blockIdx.x % n_wt) * static_cast<int64_t>(tw);
  const int tile = static_cast<int>(O - o0 < tw ? O - o0 : tw);
  int8_t* out = codes + (n * O + o0) * P;  // the block's codes: one span
  const int64_t len = tile * P;

  for (int i = threadIdx.x; i < kZeroBytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(zeros)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) n_hits = 0;
  stage_row<true>(masks + n * L + o0, L - o0, span, words, bits);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  // Even blocks zero their span before they scan, odd blocks after: the
  // waves of blocks then mix memory-bound and tensor-bound phases rather
  // than running them in lockstep.
  const bool zero_first = (blockIdx.x & 1) == 0;
  if (zero_first) zero_span_async(out, len, zeros);

  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int thr = plen - mm;
  const uint64_t keep = plen_mask(plen);
  constexpr int kPass = 8 * kWarps * NB;
  // The hits (codes of pairs with counts >= plen - mm that pass the suffix
  // test) go to a list in shared memory while the span is zeroed, and to
  // the span after it; a block whose hits overflow the list scans again.
  for (int round = 0; round < 2; ++round) {
    const bool listing = round == 0;
    if (!listing) {
      if (!zero_first) zero_span_async(out, len, zeros);
      zero_span_wait();
      __syncthreads();
      const int listed = n_hits;
      if (listed <= kHitCap) {
        for (int i = threadIdx.x; i < listed; i += blockDim.x) {
          const uint64_t h = hits[i];
          out[static_cast<int64_t>((h >> 7) & 1023) * P +
              static_cast<int64_t>(h >> 17)] = static_cast<int8_t>(h & 127);
        }
        return;
      }
    }
    for (int64_t p0 = 0; p0 < P; p0 += kPass) {
      const int cnt = static_cast<int>(P - p0 < kPass ? P - p0 : kPass);
      const WarpSplit ws = split_warps((cnt + 7) / 8, NB);
      if (ws.n_cnt == 0) continue;
      uint32_t b[NB][KS][2];
      load_b<KS, NB>(b, planes, p0 + 8 * ws.n_first, P, ws.n_cnt, keep);
      const int64_t col0 = p0 + 8 * ws.n_first + 2 * tig;  // lane's first pattern
      for (int mt = ws.wm; 16 * mt < tile; mt += ws.n_wm) {
        int acc[NB][4];
        count_tile<KS, NB>(acc, words, 16 * mt, b, ws.n_cnt);
        int top[2];
        row_tops<NB>(&acc[0][0], ws.n_cnt, top);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mt + g + 8 * h;
          if (top[h] < thr || r >= tile) continue;
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
              const int code = plen + 1 - c;
              if (!listing) {
                out[r * P + p] = static_cast<int8_t>(code);
              } else {
                const int i = atomicAdd(&n_hits, 1);
                if (i < kHitCap)
                  hits[i] = (static_cast<uint64_t>(p) << 17) |
                            (static_cast<uint64_t>(r) << 7) |
                            static_cast<uint64_t>(code);
              }
            }
          }
        }
      }
    }
  }
}

template <int KS>
int launch(const uint8_t* m, const uint64_t* q, const uint64_t* s, int8_t* out,
           int64_t n, int64_t L, int64_t O, int64_t P, int plen, int mm,
           int term, cudaStream_t st) {
  // a block: tw windows of one row x every pattern.  tw is a whole row (at
  // most kMaxTile) unless that leaves fewer than kWaves blocks per SM; the
  // warps' B fragments are built once per block and pattern pass, so tw
  // stays as large as the card's fill allows.
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t tw = (O + 15) / 16 * 16;
  if (tw > kMaxTile) tw = kMaxTile;
  while (tw > 64 && n * ((O + tw - 1) / tw) < static_cast<int64_t>(kWaves) * sms)
    tw = (tw / 2 + 15) / 16 * 16;
  const int64_t n_wt = (O + tw - 1) / tw;
  const int64_t blocks = n * n_wt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int t = static_cast<int>(tw);
  const int smem = kZeroBytes + kHitCap * 8 + segment_bytes(t);
  hit_codes_kernel<KS><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      m, q, s, out, L, O, P, static_cast<int>(n_wt), t, plen, mm, term);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hit_codes_launch(const void* masks, const void* planes,
                                const void* suffix, void* codes, int64_t n,
                                int64_t L, int64_t P, int plen, int mm,
                                int term, void* stream) {
  if (plen < 1 || plen > kMaxPlen) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t O = L - plen + 1;
  if (n <= 0 || O <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const auto* m = static_cast<const uint8_t*>(masks);
  const auto* q = static_cast<const uint64_t*>(planes);
  const auto* s = static_cast<const uint64_t*>(suffix);
  auto* out = static_cast<int8_t*>(codes);
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

extern "C" const char* hit_codes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
