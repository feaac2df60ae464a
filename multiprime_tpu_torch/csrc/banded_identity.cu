// Banded identities of (query, representative) pairs for the greedy
// clusterer, for Hopper (sm_90a): one warp a pair, a window's pairs in one
// launch.
//
// Replaces no TPU kernel: the JAX package clusters on the host
// (multiprime_tpu/cluster/greedy.py banded_identity, the native
// seqlib.cpp banded_identity).  It was added because at genome length the
// word filter passes unrelated representatives, so the clusterer's serial
// walk spends most of its time in these DPs, one pair at a time on the
// host.  The wrapper is multiprime_tpu_torch/cluster/identity.py
// banded_matches; its plain version banded_matches_reference computes the
// same numbers with the same arithmetic, batched over pairs.
//
// The function (seqlib.cpp:51-105): a banded affine global DP of the
// shorter sequence a (la rows) against the longer b, band cells w = 0 ..
// width - 1 with width = 2 * band + (lb - la) + 1 and column j = i + 1 + w
// - band at row i; match +2, mismatch -2 (a code of 4 or more never
// matches), gap open -6, extend -1; (score, matches) maximised
// lexicographically through one key score * S + m.  For row i and cell w:
//
//   F    = max(F[i-1, w+1] + EXT, V[i-1, w+1] + OPN + EXT)
//   vert = max(F, V[i-1, w] + sub)      (column 0: F)
//   t[w] = vert + OPN - EXT * w        (NEG outside the valid cells)
//   E[w] = max_{w' < w} t[w'] + EXT * w
//   V    = max(vert, E)                (NEG outside the valid cells)
//
// native's E recurrence, max(E[w-1] + EXT, vert[w-1] + OPN + EXT), is the
// same prefix max with drift (the NumPy version's, greedy.py:100-104).
// The output is the match count m of the end cell (la, lb): key & (S - 1)
// (the non-negative remainder native takes), or -1 where the key is NEG or
// below (native's v[end] <= NEG) and where la is 0; the host divides m by
// la in float64 as native does.
//
// The key.  Every valid cell is reachable inside the band, so its V and
// vert are maxima over real paths; values derived from NEG (out-of-band
// neighbours, the empty scan) stay in [NEG - (width + 8) S, NEG + 2 S + 1]
// and lose every max they meet, and a real key lies in [-(la + lb + width
// + 16) S, 2 la S + la].  So any S above la and any NEG below the real
// range with room above the key type's least value order (score, m)
// exactly as native's int64 score * 2**20 + m does.  The wrapper takes
// 32-bit keys with S = 2**bitlen(max la) and NEG = -2**30 while (la + lb +
// width + 19) S <= 2**30 for every pair of the launch (la below 2**14 at
// any width the kernel takes), else 64-bit keys with native's own S =
// 2**20 and NEG = -2**40 (while la + lb + width + 19 < 2**20, sequences
// up to about 524 kb); the clusterer keeps a job with longer sequences on
// the host.
//
// The design.  One warp a pair, four pairs a CTA, no barrier.  Lane l
// owns the K contiguous cells [l K, l K + K) of the band (K one of 4, 8,
// 12, 16, 24, 32, the smallest with 32 K >= the launch's widest band):
// their V, F and b codes live in registers, every index known at compile
// time.  A row: a's code is broadcast from the lane that loaded 32 rows'
// codes; V, F and the code of cell w + 1 at the lane's edge come from the
// right lane by __shfl_down_sync (lane 31's code from a lane that loaded
// the next 32 rows' codes entering the band); pass 1 computes F, the
// diagonal, vert and the lane's max of t; a 5-step __shfl_up_sync max-scan
// gives the exclusive prefix max of t; pass 2 finishes E and V.  The codes
// slide one cell left a row.  What bounds it: the int32 operations of the
// cells, about 20 a cell (the bound chip_smoke.py counts), against a few
// bytes a pair; each pair is a chain of la dependent rows, so a window
// that holds too few pairs to fill the card is bound by one row's latency
// times la instead.
//
// Wider bands (|lb - la| past 895 at band 64: a partial genome beside a
// complete one) take banded_identity_wide_kernel: the same warp and rows,
// the band walked left to right in chunks of 32 * 8 cells a row, each
// chunk's V and F loaded from and stored back to a scratch row of the
// pair in global memory (the cell right of a chunk still holds the row
// above when the chunk reads it), its b codes read from b, and the max of
// t over the chunks to its left carried into its scan.  It moves about 4
// key loads and stores a cell, so it runs below the register kernel; the
// wrapper gives it only the pairs the register kernel cannot take.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;   // pairs (warps) a CTA
constexpr unsigned kFull = 0xffffffffu;
// a's codes of 4 or more and b's past its ends: never equal to a code
constexpr int kNoMatchA = 1000;
constexpr int kNoMatchB = 2000;

template <typename Key>
struct KeyConsts;

template <>
struct KeyConsts<int> {
  static constexpr int kNeg = -(1 << 30);
};

template <>
struct KeyConsts<long long> {
  static constexpr long long kNeg = -(1LL << 40);
};

template <typename Key>
__device__ __forceinline__ Key kmax(Key x, Key y) {
  return x > y ? x : y;
}

template <typename Key, int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    banded_identity_kernel(const int8_t* __restrict__ codes,
                           const int64_t* __restrict__ meta, int64_t pairs,
                           int band, int shift, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= pairs) return;   // the whole warp: no barrier waits for it

  // a: the shorter (the query where the lengths tie), as native swaps
  const int8_t* a = codes + meta[p];
  const int8_t* b = codes + meta[2 * pairs + p];
  int la = static_cast<int>(meta[pairs + p]);
  int lb = static_cast<int>(meta[3 * pairs + p]);
  if (la > lb) {
    const int8_t* t = a;
    a = b;
    b = t;
    const int l = la;
    la = lb;
    lb = l;
  }
  if (la == 0) {
    if (lane == 0) out[p] = -1;
    return;
  }

  constexpr Key kNeg = KeyConsts<Key>::kNeg;
  const Key S = static_cast<Key>(1) << shift;
  const Key ext = -S;
  const Key opn = -6 * S;
  const Key hit = 2 * S + 1;
  const Key miss = -2 * S;
  const int width = 2 * band + (lb - la) + 1;
  const int w0 = lane * K;

  // row 0: V = 0 at j = 0, OPN + EXT j for j in 1..lb, NEG elsewhere;
  // F = NEG; cell w's code is b[i + w - band] at row i
  Key v[K], f[K];
  int bc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = w0 + k;
    const int j = w - band;
    v[k] = w >= width      ? kNeg
           : j == 0        ? static_cast<Key>(0)
           : (j >= 1 && j <= lb) ? opn + ext * j
                           : kNeg;
    f[k] = kNeg;
    bc[k] = (j >= 0 && j < lb) ? static_cast<int>(b[j]) : kNoMatchB;
  }

  for (int i0 = 0; i0 < la; i0 += 32) {
    // 32 rows' a codes, and the b codes entering lane 31's last cell at
    // the next 32 rows, one a lane
    int ac = i0 + lane < la ? static_cast<int>(a[i0 + lane]) : 0;
    ac = ac < 4 ? ac : kNoMatchA;
    const int jb = i0 + lane + 32 * K - band;
    const int bl = (jb >= 0 && jb < lb) ? static_cast<int>(b[jb]) : kNoMatchB;
    const int rows = min(32, la - i0);
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const int ai = __shfl_sync(kFull, ac, r);
      const int bin = __shfl_sync(kFull, bl, r);
      Key vn = __shfl_down_sync(kFull, v[0], 1);
      Key fn1 = __shfl_down_sync(kFull, f[0], 1);
      int bn = __shfl_down_sync(kFull, bc[0], 1);
      if (lane == 31) {
        vn = kNeg;
        fn1 = kNeg;
        bn = bin;
      }
      // cell k's column j = jrow + k
      const int jrow = i0 + r + 1 + w0 - band;
      // pass 1: F, the diagonal and vert; NEG outside the valid cells;
      // the lane's max of t
      unsigned valid = 0;
      Key lm = kNeg;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = jrow + k;
        const Key vs = k + 1 < K ? v[k + 1] : vn;
        const Key fs = k + 1 < K ? f[k + 1] : fn1;
        const Key fc = kmax(fs + ext, vs + (opn + ext));
        const Key d = v[k] + (bc[k] == ai ? hit : miss);
        const Key vert = j >= 1 ? kmax(fc, d) : fc;
        const bool ok =
            static_cast<unsigned>(j) <= static_cast<unsigned>(lb) &&
            w0 + k < width;
        valid |= ok ? 1u << k : 0u;
        v[k] = ok ? vert : kNeg;
        f[k] = ok ? fc : kNeg;
        lm = kmax(lm, ok ? vert + (opn - ext * (w0 + k)) : kNeg);
      }
      // exclusive max-scan of the lanes' maxima: run = max t[0 .. w0 - 1]
      Key inc = lm;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const Key o = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc = kmax(inc, o);
      }
      Key run = __shfl_up_sync(kFull, inc, 1);
      if (lane == 0) run = kNeg;
      // pass 2: E and V; the codes slide one cell left for the next row
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (valid & (1u << k)) {
          const Key vert = v[k];
          v[k] = kmax(vert, run + ext * (w0 + k));
          run = kmax(run, vert + (opn - ext * (w0 + k)));
        }
        bc[k] = k + 1 < K ? bc[k + 1] : bn;
      }
    }
  }

  // the end cell (la, lb) sits at w = lb - la + band
  const int end = lb - la + band;
  if (end >= w0 && end < w0 + K) {
    Key key = kNeg;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (w0 + k == end) key = v[k];
    out[p] = key <= kNeg ? -1 : static_cast<int32_t>(key & (S - 1));
  }
}

constexpr int kWideK = 8;                  // cells a lane in a chunk
constexpr int kChunk = 32 * kWideK;        // cells a chunk

// cell w of a wide pair's scratch row: chunk w / kChunk, within it slot k
// of lane l at k * 32 + l, so a chunk's loads and stores coalesce
template <typename Key>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    banded_identity_wide_kernel(const int8_t* __restrict__ codes,
                                const int64_t* __restrict__ meta,
                                int64_t pairs, int band, int shift,
                                int64_t stride, Key* __restrict__ scratch,
                                int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= pairs) return;   // the whole warp: no barrier waits for it

  const int8_t* a = codes + meta[p];
  const int8_t* b = codes + meta[2 * pairs + p];
  int la = static_cast<int>(meta[pairs + p]);
  int lb = static_cast<int>(meta[3 * pairs + p]);
  if (la > lb) {
    const int8_t* t = a;
    a = b;
    b = t;
    const int l = la;
    la = lb;
    lb = l;
  }
  if (la == 0) {
    if (lane == 0) out[p] = -1;
    return;
  }

  constexpr Key kNeg = KeyConsts<Key>::kNeg;
  const Key S = static_cast<Key>(1) << shift;
  const Key ext = -S;
  const Key opn = -6 * S;
  const Key hit = 2 * S + 1;
  const Key miss = -2 * S;
  const int width = 2 * band + (lb - la) + 1;
  const int chunks = (width + kChunk - 1) / kChunk;
  Key* vs = scratch + 2 * stride * p;
  Key* fs = vs + stride;

  // row 0, as the register kernel's
  for (int c = 0; c < chunks; ++c) {
#pragma unroll
    for (int k = 0; k < kWideK; ++k) {
      const int w = c * kChunk + lane * kWideK + k;
      const int j = w - band;
      vs[c * kChunk + k * 32 + lane] =
          w >= width      ? kNeg
          : j == 0        ? static_cast<Key>(0)
          : (j >= 1 && j <= lb) ? opn + ext * j
                          : kNeg;
      fs[c * kChunk + k * 32 + lane] = kNeg;
    }
  }
  __syncwarp();

  for (int i = 0; i < la; ++i) {
    int ai = static_cast<int>(a[i]);
    ai = ai < 4 ? ai : kNoMatchA;
    Key carry = kNeg;   // max of t over the chunks to the left
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
      Key* vc = vs + c * kChunk;
      Key* fc = fs + c * kChunk;
      const int w0 = c * kChunk + lane * kWideK;
      Key v[kWideK], f[kWideK];
      int bc[kWideK];
#pragma unroll
      for (int k = 0; k < kWideK; ++k) {
        v[k] = vc[k * 32 + lane];
        f[k] = fc[k * 32 + lane];
        const int jb = i + w0 + k - band;
        bc[k] = (jb >= 0 && jb < lb) ? static_cast<int>(b[jb]) : kNoMatchB;
      }
      Key vn = __shfl_down_sync(kFull, v[0], 1);
      Key fn1 = __shfl_down_sync(kFull, f[0], 1);
      if (lane == 31) {   // the next chunk's first cell: still the row above
        vn = c + 1 < chunks ? vc[kChunk] : kNeg;
        fn1 = c + 1 < chunks ? fc[kChunk] : kNeg;
      }
      const int jrow = i + 1 + w0 - band;
      unsigned valid = 0;
      Key lm = kNeg;
#pragma unroll
      for (int k = 0; k < kWideK; ++k) {
        const int j = jrow + k;
        const Key vsrc = k + 1 < kWideK ? v[k + 1] : vn;
        const Key fsrc = k + 1 < kWideK ? f[k + 1] : fn1;
        const Key fcell = kmax(fsrc + ext, vsrc + (opn + ext));
        const Key d = v[k] + (bc[k] == ai ? hit : miss);
        const Key vert = j >= 1 ? kmax(fcell, d) : fcell;
        const bool ok =
            static_cast<unsigned>(j) <= static_cast<unsigned>(lb) &&
            w0 + k < width;
        valid |= ok ? 1u << k : 0u;
        v[k] = ok ? vert : kNeg;
        f[k] = ok ? fcell : kNeg;
        lm = kmax(lm, ok ? vert + (opn - ext * (w0 + k)) : kNeg);
      }
      Key inc = lm;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const Key o = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc = kmax(inc, o);
      }
      Key run = __shfl_up_sync(kFull, inc, 1);
      if (lane == 0) run = kNeg;
      run = kmax(run, carry);
      carry = kmax(carry, __shfl_sync(kFull, inc, 31));
#pragma unroll
      for (int k = 0; k < kWideK; ++k) {
        if (valid & (1u << k)) {
          const Key vert = v[k];
          v[k] = kmax(vert, run + ext * (w0 + k));
          run = kmax(run, vert + (opn - ext * (w0 + k)));
        }
        vc[k * 32 + lane] = v[k];
        fc[k * 32 + lane] = f[k];
      }
      __syncwarp();   // the stores before the next chunk's and row's loads
    }
  }

  if (lane == 0) {
    const int end = lb - la + band;
    const int r = end % kChunk;
    const Key key =
        vs[end - r + (r % kWideK) * 32 + r / kWideK];
    out[p] = key <= kNeg ? -1 : static_cast<int32_t>(key & (S - 1));
  }
}

template <typename Key, int K>
cudaError_t launch(int64_t pairs, cudaStream_t stream, const int8_t* codes,
                   const int64_t* meta, int band, int shift, int32_t* out) {
  const unsigned grid =
      static_cast<unsigned>((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  banded_identity_kernel<Key, K><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(
      codes, meta, pairs, band, shift, out);
  return cudaGetLastError();
}

template <typename Key>
cudaError_t launch_k(int k, int64_t pairs, cudaStream_t stream,
                     const int8_t* codes, const int64_t* meta, int band,
                     int shift, int32_t* out) {
  switch (k) {
    case 4: return launch<Key, 4>(pairs, stream, codes, meta, band, shift, out);
    case 8: return launch<Key, 8>(pairs, stream, codes, meta, band, shift, out);
    case 12: return launch<Key, 12>(pairs, stream, codes, meta, band, shift, out);
    case 16: return launch<Key, 16>(pairs, stream, codes, meta, band, shift, out);
    case 24: return launch<Key, 24>(pairs, stream, codes, meta, band, shift, out);
    case 32: return launch<Key, 32>(pairs, stream, codes, meta, band, shift, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// codes int8 [total] (queries and representatives, one buffer); meta
// int64 [4, pairs]: each pair's query offset into codes, query length,
// representative offset and representative length (each below 2**31);
// band >= 0; k (4, 8, 12, 16, 24, 32) cells a lane, 32 k >= 2 band + |lb
// - la| + 1 for every pair; key_bits 32 (S = 2**shift) or 64 (shift 20),
// within the limits the wrapper checks (see above); out int32 [pairs]:
// each pair's matches, or -1.
extern "C" int banded_identity_launch(const void* codes, const void* meta,
                                      int64_t pairs, int64_t band, int shift,
                                      int key_bits, int k, void* out,
                                      void* stream) {
  if (pairs < 0 || band < 0 || band > (1 << 20) || shift < 0 || shift > 20 ||
      (key_bits != 32 && key_bits != 64) ||
      (key_bits == 64 && shift != 20) ||
      (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pairs == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cc = static_cast<const int8_t*>(codes);
  const auto* mt = static_cast<const int64_t*>(meta);
  auto* o = static_cast<int32_t*>(out);
  const int bd = static_cast<int>(band);
  const cudaError_t err =
      key_bits == 32
          ? launch_k<int>(k, pairs, s, cc, mt, bd, shift, o)
          : launch_k<long long>(k, pairs, s, cc, mt, bd, shift, o);
  return static_cast<int>(err);
}

// The wide kernel: as banded_identity_launch, without k; scratch holds
// pairs * 2 * stride keys (int32 for key_bits 32, int64 for 64), stride a
// multiple of 256 at least the widest band of the launch.
extern "C" int banded_identity_wide_launch(const void* codes,
                                           const void* meta, int64_t pairs,
                                           int64_t band, int shift,
                                           int key_bits, int64_t stride,
                                           void* scratch, void* out,
                                           void* stream) {
  if (pairs < 0 || band < 0 || band > (1 << 20) || shift < 0 || shift > 20 ||
      (key_bits != 32 && key_bits != 64) ||
      (key_bits == 64 && shift != 20) || stride <= 0 ||
      stride % kChunk != 0 ||
      (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pairs == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cc = static_cast<const int8_t*>(codes);
  const auto* mt = static_cast<const int64_t*>(meta);
  auto* o = static_cast<int32_t*>(out);
  const int bd = static_cast<int>(band);
  const unsigned grid =
      static_cast<unsigned>((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (key_bits == 32)
    banded_identity_wide_kernel<int><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
        cc, mt, pairs, bd, shift, stride, static_cast<int*>(scratch), o);
  else
    banded_identity_wide_kernel<long long>
        <<<grid, 32 * kWarpsPerBlock, 0, s>>>(
            cc, mt, pairs, bd, shift, stride,
            static_cast<long long*>(scratch), o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* banded_identity_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* banded_identity_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
