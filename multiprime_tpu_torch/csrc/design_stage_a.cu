// Design Stage A, for Hopper (sm_90a): three kernels.
//
// Replaces the JAX device program multiprime_tpu/ops/design_scan.py
// design_stats_full (:160): patch_windows (:36), window_stats (:89) and
// viterbi_batch (:123, two lax.scans), jitted into one XLA program a block
// of windows.  Its plain PyTorch version is
// multiprime_tpu_torch/ops/design_scan.py design_stats_full_reference; the
// kernels' results equal it integer for integer.
//
// stage_a_rows_kernel, once for an MSA's masks (int32 [N, L], 0 = gap):
// one CTA a row, a block-wide prefix count of its non-gaps (a ballot and a
// popcount a warp, the warps' counts through shared memory) writes
// before[n, i], the non-gaps left of column i, for i = 0..L (before[n, L]
// is the row's total), and packed[n, k], the row's k-th residue, its
// residues left-packed (zeros past the total).
//
// stage_a_windows_kernel, once a block of windows: one CTA a window, its
// threads striding over the members.  A member's window is patched as
// core.py:666-687 does (and JAX through prefix sums and gathers): its
// leading run of lead gaps (lead < plen) takes the lead residues left of
// the window when the row has that many, its trailing run of trail gaps
// the trail residues right of it.  JAX's run_from[pos] capped at plen is
// the window's leading gap count (plen when the window is all gaps), and
// run_to[last] capped at plen its trailing one; c_start = before[pos] and
// c_end = before[pos + plen]: one pass over the window gives them, and no
// run rows are needed.  The patched residues are never gaps, so the
// patched window has gaps - lead - trail gaps (only the runs it took), and
// it is alive while that is at most variation.  Its expansion count
// total = prod mc_j (mc: the members of a 4-bit mask, 1 for a gap) is an
// int64 product that wraps as torch's does; each member base b at j adds
// total // mc_j to freq[j][b], each pair (a, b) at (j, j + 1) adds
// total // (mc_j * mc_{j+1}) to nn[j][a][b], for alive windows, with
// torch's floor division (a wrapped total may be negative: C's division
// truncates, so the quotient steps down where a remainder is left).  The
// sums are unsigned 64-bit atomics in dynamic shared memory (160 * plen -
// 128 bytes), or, for a plen too long for it, in the window's own rows of
// the outputs; unsigned sums wrap modulo 2**64 in any order, as torch's
// int64 sums do, so the values equal the plain version's even past 2**63.
//
// stage_a_viterbi_kernel: one thread a window, the max-sum consensus of
// core.py:579-593 on its freq and nn (JAX's lax.scan and its reverse walk)
// in int64 that wraps as torch's does: back[t][to] is the first `from`
// (ascending, strict >) that maximises scores[from] + nn[t][from][to] +
// freq[t + 1][to], the path ends at the first maximum of the final scores.
// The back pointers (2 bits a state, 8 a step) wait in the path's own
// output slots until the walk back overwrites them.  A launch of its own,
// so that a mesh sums its shards' counts first.
//
// What bounds them: the bytes (the masks read once, the patched windows
// [N, W, plen] written once) and the integer work of each window cell (its
// mask, mc, two floor divisions and one shared atomic for each base and
// pair of bases), well under a millisecond a 512-window block at the
// design path's sizes.  This first form is simple, not fast: each member's
// window is read with its thread's own loads (neighbouring threads on
// neighbouring rows), a conserved column puts every member's atomic on one
// shared word, and the divisions are 64-bit; a window's freq and nn stay
// in shared memory, so only the outputs reach device memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kWinThreads = 256;
constexpr int kViterbiThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a window's sums may take (of the 227 KB a block
// may use)
constexpr int64_t kSmemLimit = 200 * 1024;

__global__ void __launch_bounds__(kRowThreads)
stage_a_rows_kernel(const int32_t* __restrict__ masks,   // [N, L]
                    int32_t* __restrict__ before,        // [N, L + 1]
                    uint8_t* __restrict__ packed,        // [N, L]
                    int64_t L) {
  __shared__ int warp_counts[kRowThreads / 32];
  const int64_t n = blockIdx.x;
  const int32_t* row = masks + n * L;
  int32_t* brow = before + n * (L + 1);
  uint8_t* prow = packed + n * L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;   // non-gaps left of this chunk (the same in every thread)
  for (int64_t c0 = 0; c0 < L; c0 += kRowThreads) {
    const int64_t i = c0 + threadIdx.x;
    const int32_t m = i < L ? row[i] : 0;
    const unsigned ballot = __ballot_sync(kFull, m != 0);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int left = carry, chunk = 0;
    for (int k = 0; k < kRowThreads / 32; ++k) {
      const int c = warp_counts[k];
      left += k < warp ? c : 0;
      chunk += c;
    }
    const int b = left + __popc(ballot & ((1u << lane) - 1u));
    if (i < L) {
      brow[i] = b;
      if (m != 0) prow[b] = static_cast<uint8_t>(m);
    }
    carry += chunk;
    __syncthreads();   // warp_counts is rewritten by the next chunk
  }
  if (threadIdx.x == 0) brow[L] = carry;
  for (int64_t k = carry + threadIdx.x; k < L; k += kRowThreads) prow[k] = 0;
}

// members of a 4-bit mask, 1 for a gap (mask 0)
__device__ __forceinline__ int members(int v) {
  return v == 0 ? 1 : __popc(v);
}

// a // D with torch's floor, for a positive compile-time D (a multiply,
// not a division)
template <int D>
__device__ __forceinline__ long long floor_div(long long a) {
  const long long q = a / D;
  return q - (q * D > a ? 1 : 0);
}

// a // d for the divisors a window's weights use: mc_j in 1..4, and the
// products of two of them
__device__ __forceinline__ long long floor_div(long long a, int d) {
  switch (d) {
    case 1: return a;
    case 2: return floor_div<2>(a);
    case 3: return floor_div<3>(a);
    case 4: return floor_div<4>(a);
    case 6: return floor_div<6>(a);
    case 8: return floor_div<8>(a);
    case 9: return floor_div<9>(a);
    case 12: return floor_div<12>(a);
    default: return floor_div<16>(a);
  }
}

__global__ void __launch_bounds__(kWinThreads)
stage_a_windows_kernel(const int32_t* __restrict__ masks,        // [N, L]
                       const int32_t* __restrict__ before,       // [N, L + 1]
                       const uint8_t* __restrict__ packed,       // [N, L]
                       const int64_t* __restrict__ positions,    // [W]
                       int8_t* __restrict__ win,                 // [N, W, plen]
                       unsigned long long* __restrict__ freq,    // [W, plen, 4]
                       unsigned long long* __restrict__ nn,      // [W, plen-1, 4, 4]
                       long long* __restrict__ cover,            // [W]
                       long long* __restrict__ gap_rows,         // [W]
                       int64_t n_rows, int64_t L, int64_t W, int plen,
                       int64_t variation, int in_shared) {
  extern __shared__ unsigned long long sums[];
  __shared__ int counts[2];   // alive rows, gap rows
  const int64_t w = blockIdx.x;
  const int n_freq = 4 * plen;
  const int n_nn = 16 * (plen - 1);
  unsigned long long* acc_f = in_shared ? sums : freq + w * n_freq;
  unsigned long long* acc_n = in_shared ? sums + n_freq : nn + w * n_nn;
  for (int k = threadIdx.x; k < n_freq; k += blockDim.x) acc_f[k] = 0;
  for (int k = threadIdx.x; k < n_nn; k += blockDim.x) acc_n[k] = 0;
  if (threadIdx.x < 2) counts[threadIdx.x] = 0;
  __syncthreads();

  const int64_t pos = positions[w];
  int alive_rows = 0, dead_rows = 0;
  for (int64_t n = threadIdx.x; n < n_rows; n += blockDim.x) {
    const int32_t* mrow = masks + n * L + pos;
    int gaps = 0, first = plen, last = -1;
    for (int j = 0; j < plen; ++j) {
      if (mrow[j] == 0) {
        ++gaps;
      } else {
        first = first == plen ? j : first;
        last = j;
      }
    }
    // lead = first and trail = plen - 1 - last are the gap runs at the
    // window's ends: both plen for a window of gaps only
    const int lead = first, trail = plen - 1 - last;
    const int32_t* brow = before + n * (L + 1);
    const int64_t c_start = brow[pos], c_end = brow[pos + plen];
    const int64_t total = brow[L];
    const bool some = last >= 0;
    // j < lead_end takes packed[lead_src + j], j >= trail_start
    // packed[trail_src + j]: rows of the packed residues before c_start
    // and from c_end on, never out of the row's residues
    const int lead_end = some && lead > 0 && c_start >= lead ? lead : 0;
    const int trail_start =
        some && trail > 0 && total - c_end >= trail ? plen - trail : plen;
    const uint8_t* prow = packed + n * L;
    const int64_t lead_src = c_start - lead;
    const int64_t trail_src = c_end - trail_start;
    auto value = [&](int j) -> int {
      if (j < lead_end) return prow[lead_src + j];
      if (j >= trail_start) return prow[trail_src + j];
      return mrow[j];
    };
    const bool alive = gaps - lead_end - (plen - trail_start) <= variation;
    unsigned long long total_exp = 1;
    int8_t* wrow = win == nullptr ? nullptr : win + (n * W + w) * plen;
    for (int j = 0; j < plen; ++j) {
      const int v = value(j);
      if (wrow != nullptr) wrow[j] = static_cast<int8_t>(v);
      total_exp *= static_cast<unsigned long long>(members(v));
    }
    if (!alive) {
      ++dead_rows;
      continue;
    }
    ++alive_rows;
    const long long t = static_cast<long long>(total_exp);
    int prev = 0, mc_prev = 1;
    for (int j = 0; j < plen; ++j) {
      const int v = value(j);
      const int mc = members(v);
      const unsigned long long w_pos =
          static_cast<unsigned long long>(floor_div(t, mc));
      for (int b = 0; b < 4; ++b)
        if ((v >> b) & 1) atomicAdd(acc_f + 4 * j + b, w_pos);
      if (j > 0 && prev != 0 && v != 0) {
        const unsigned long long w_pair =
            static_cast<unsigned long long>(floor_div(t, mc_prev * mc));
        unsigned long long* cell = acc_n + 16 * (j - 1);
        for (int a = 0; a < 4; ++a)
          if ((prev >> a) & 1)
            for (int b = 0; b < 4; ++b)
              if ((v >> b) & 1) atomicAdd(cell + 4 * a + b, w_pair);
      }
      prev = v;
      mc_prev = mc;
    }
  }
  atomicAdd(&counts[0], alive_rows);
  atomicAdd(&counts[1], dead_rows);
  __syncthreads();
  if (in_shared) {
    for (int k = threadIdx.x; k < n_freq; k += blockDim.x)
      freq[w * n_freq + k] = acc_f[k];
    for (int k = threadIdx.x; k < n_nn; k += blockDim.x)
      nn[w * n_nn + k] = acc_n[k];
  }
  if (threadIdx.x == 0) {
    cover[w] = counts[0];
    gap_rows[w] = counts[1];
  }
}

__global__ void __launch_bounds__(kViterbiThreads)
stage_a_viterbi_kernel(const long long* __restrict__ freq,   // [W, plen, 4]
                       const long long* __restrict__ nn,     // [W, plen-1, 4, 4]
                       int32_t* __restrict__ path,           // [W, plen]
                       int64_t W, int plen) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const long long* f = freq + w * 4 * plen;
  const long long* tr = nn + w * 16 * (plen - 1);
  int32_t* out = path + w * plen;
  // scores in unsigned words: adds wrap as torch's int64 adds do, and
  // compare as signed
  unsigned long long s[4];
  for (int k = 0; k < 4; ++k) s[k] = static_cast<unsigned long long>(f[k]);
  for (int t = 0; t + 1 < plen; ++t) {
    unsigned long long next[4];
    int back = 0;
    for (int to = 0; to < 4; ++to) {
      const unsigned long long obs = static_cast<unsigned long long>(f[4 * (t + 1) + to]);
      long long best = 0;
      int arg = 0;
      for (int from = 0; from < 4; ++from) {
        const long long m = static_cast<long long>(
            s[from] + static_cast<unsigned long long>(tr[16 * t + 4 * from + to]) + obs);
        if (from == 0 || m > best) {
          best = m;
          arg = from;
        }
      }
      next[to] = static_cast<unsigned long long>(best);
      back |= arg << (2 * to);
    }
    for (int k = 0; k < 4; ++k) s[k] = next[k];
    out[t] = back;
  }
  int state = 0;
  for (int k = 1; k < 4; ++k)
    if (static_cast<long long>(s[k]) > static_cast<long long>(s[state])) state = k;
  out[plen - 1] = state;
  for (int t = plen - 2; t >= 0; --t) {
    state = (out[t] >> (2 * state)) & 3;
    out[t] = state;
  }
}

}  // namespace

// masks int32 [n, L] (0..15), before int32 [n, L + 1], packed uint8 [n, L]
extern "C" int stage_a_rows_launch(const void* masks, void* before,
                                   void* packed, int64_t n, int64_t L,
                                   void* stream) {
  if (n < 0 || L < 0 || n > INT_MAX || L >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  stage_a_rows_kernel<<<static_cast<unsigned>(n), kRowThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(masks), static_cast<int32_t*>(before),
      static_cast<uint8_t*>(packed), L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stage_a_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// masks, before, packed as stage_a_rows writes them; positions int64 [w],
// each in 0..L - plen; win int8 [n, w, plen] or null; freq int64
// [w, plen, 4], nn int64 [w, plen - 1, 4, 4], cover and gap_rows int64 [w]
extern "C" int stage_a_windows_launch(const void* masks, const void* before,
                                      const void* packed,
                                      const void* positions, void* win,
                                      void* freq, void* nn, void* cover,
                                      void* gap_rows, int64_t n, int64_t L,
                                      int64_t w, int plen, int64_t variation,
                                      void* stream) {
  if (n < 0 || L < 0 || w < 0 || w > INT_MAX || plen < 1 || plen > (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w == 0) return static_cast<int>(cudaSuccess);
  if (plen > L) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = 8 * (20 * static_cast<int64_t>(plen) - 16);
  const int in_shared = smem <= kSmemLimit;
  const size_t dyn = in_shared ? static_cast<size_t>(smem) : 0;
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage_a_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stage_a_windows_kernel<<<static_cast<unsigned>(w), kWinThreads, dyn,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(masks), static_cast<const int32_t*>(before),
      static_cast<const uint8_t*>(packed),
      static_cast<const int64_t*>(positions), static_cast<int8_t*>(win),
      static_cast<unsigned long long*>(freq),
      static_cast<unsigned long long*>(nn), static_cast<long long*>(cover),
      static_cast<long long*>(gap_rows), n, L, w, plen, variation, in_shared);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stage_a_windows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// freq int64 [w, plen, 4], nn int64 [w, plen - 1, 4, 4] -> path int32
// [w, plen]
extern "C" int stage_a_viterbi_launch(const void* freq, const void* nn,
                                      void* path, int64_t w, int plen,
                                      void* stream) {
  if (w < 0 || plen < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (w == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (w + kViterbiThreads - 1) / kViterbiThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  stage_a_viterbi_kernel<<<static_cast<unsigned>(blocks), kViterbiThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(freq), static_cast<const long long*>(nn),
      static_cast<int32_t*>(path), w, plen);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stage_a_viterbi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
