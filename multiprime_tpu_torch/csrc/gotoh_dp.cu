// Center-star Gotoh row DP and its back-trace, for Hopper (sm_90a): two
// kernels, chosen by the block's shape.
//
// Replaces the JAX device program multiprime_tpu/align/device.py _build
// (:38): one lax.scan over the center's rows (`row`, :50-82) and one over
// the trace steps (`trace_step`, :89-116), jitted into one XLA program a
// block of members.  Its plain PyTorch version is
// multiprime_tpu_torch/align/device.py gotoh_block_reference; the results
// of both kernels are equal to it element for element (same scores, same
// tie-breaks).
//
// Scoring: MATCH 2, MISMATCH -1 (a center code of 4 or more never
// matches), affine gaps GAP_OPEN -4 + GAP_EXT -1 a base.  For member m of
// length lb_m and center row i (code ci), column j in 0..lb_m:
//
//   F[i,j]  = max(F[i-1,j] + GE, V[i-1,j] + GO + GE)      fcont: the first
//   diag    = V[i-1,j-1] + sub(b[j-1], ci)                 term wins ties
//   vert    = max(diag, F[i,j])  (column 0: F[i,0])        p = diag < F
//   t[j]    = vert + GO - GE*j
//   E[i,j]  = max_{k<j} t[k] + GE*j  (column 0: _NEG)      econt: t[j-1] is
//   V[i,j]  = max(vert, E)                                 below that max
//   p       = 2 where E > vert, strictly
//
// and the packed pointer byte p | fcont << 2 | econt << 3 of each cell,
// written to a global pointer scratch [M, la, pitch] that only the trace
// reads.  Columns past a member's own length are never read by its trace
// and depend on nothing left of them, so they may hold anything.  Scores
// stay far from int32's ends: _NEG = -2**28 is never accumulated (F's max
// takes the real open term at once, E's sentinel is only compared), and
// real scores are above -5 (la + lb).
//
// gotoh_dp_warp_kernel<K>, every block with lb + 1 <= 32 * 40 = 1280 (the
// wrapper's choice, by shape only): one warp a member and a CTA, no block
// barrier.  Lane l owns the K contiguous columns [l*K, l*K + K) (K
// one of 8, 16, 24, 32, 40, the smallest with 32K >= lb + 1; at 48 and
// more the row needs over 255 registers and spills); V and F of its
// columns live in K registers each and its member codes one-hot, 4 to a
// register, every index known at compile time.  A row is two unrolled
// passes over the K columns and nine full-mask shuffles: the center code
// is broadcast from a lane that loaded 32 rows' codes; the diagonal's
// V[i-1, j0-1] is the left lane's last V of the row before; pass 1
// computes F, the diagonal, vert and the lane's max of t; a 5-step shuffle
// max-scan gives the exclusive prefix max of t (lax.cummax), and the left
// lane's last t gives econt at the lane's first column; pass 2 finishes E,
// V, econt and the pointer bytes, packed in registers and stored as whole
// 16-byte (K a multiple of 16) or 8-byte words, so the pitch is 32K and a
// warp's row 32K contiguous bytes.  What bounds it: latency, not the
// card's rate.  A block of 512 members puts about one warp on each
// scheduler, which issues the row's instructions at well under one a
// cycle: the scan's dependent shuffles, pass 2's running max and the next
// row's wait for this one's last V leave it stalled much of the time.
// One member a CTA: ptxas schedules the row differently under each launch
// bound, and on an H100 (80GB HBM3, 700 W) examples/torch_gotoh_kernels.py
// --warps 1,2,4 gave medians of 1.19, 1.23 and 1.44 ms for one 923 x 512
// block.
//
// gotoh_dp_kernel, longer blocks: one CTA of T threads (the wrapper sets
// 256) a member; tid owns the contiguous columns [tid*K, tid*K + K), K =
// ceil((lb_m+1) / T); their V, F, a pointer byte and the member's code
// live in slots k*T + tid (bank-conflict free), in dynamic shared memory
// or, for members too long for it, in a global scratch the wrapper
// allocates.  A row is two passes and two barriers: pass 1 computes F, the
// diagonal and vert (the diagonal's V[i-1, j0-1] is the left neighbour's
// last value of the row before, published in shared memory), and each
// thread's max of t; a warp-shuffle max-scan and one shared step across
// warps give each thread the exclusive prefix max of t, and pass 2
// finishes E, V and the pointer byte.  The pitch is lb + 1.  What bounds
// it: the rows are a chain of la dependent steps of two barriers each and
// 28 integer operations a cell (t and the running max in both passes, the
// byte packed in two steps), so a CTA's latency sets the time.
//
// Both end alike: the member's output row is filled with _PAD_OP, then one
// thread walks the member's trace over the pointer scratch, la + lb_m
// dependent one-byte loads, and writes the reverse-order ops.  The
// function needs about 20 integer operations a cell (the smoke check's
// bound counts those of _build's row) against one pointer byte written.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_words.cuh"

namespace {

constexpr int kMatch = 2;
constexpr int kMismatch = -1;
constexpr int kGapOpen = -4;
constexpr int kGapExt = -1;
constexpr int kNeg = -(1 << 28);
constexpr uint8_t kPadOp = 3;
constexpr int kSlotBytes = 10;   // V, F (int32), pointer bits, code
constexpr int kWarpsPerBlock = 1;   // members (warps) a CTA
constexpr unsigned kFull = 0xffffffffu;

// The back-trace of one member (JAX trace_step) over its pointer rows
// (row i - 1 at pmem + (i - 1) * pitch): state st 0 = V, 1 = F
// (vertical), 2 = E; writes the moves to out in reverse order.
__device__ void trace_member(const uint8_t* pmem, int64_t pitch, int la,
                             int lb_m, uint8_t* out, int64_t steps) {
  int i = la, j = lb_m, st = 0;
  for (int64_t s = 0; s < steps && (i != 0 || j != 0); ++s) {
    const int pf = i > 0 ? pmem[static_cast<int64_t>(i - 1) * pitch + j] : 0;
    const int mv = i == 0    ? 2
                   : j == 0  ? 1
                   : st == 1 ? 1
                   : st == 2 ? 2
                             : (pf & 3);
    const int fc = (pf >> 2) & 1;
    const int ec = (pf >> 3) & 1;
    const int nst = mv == 0 ? 0 : mv == 1 ? fc : ((i > 0 && j > 0) ? 2 * ec : 0);
    out[s] = static_cast<uint8_t>(mv);
    i -= mv != 2;
    j -= mv != 1;
    st = nst;
  }
}

__global__ void gotoh_dp_kernel(const int32_t* __restrict__ c, int la,
                                const int32_t* __restrict__ bmat,
                                const int32_t* __restrict__ lbs, int lb,
                                uint8_t* __restrict__ ptr,
                                uint8_t* __restrict__ ops, int64_t steps,
                                uint8_t* row_scratch, int64_t region_bytes,
                                int slots, long long* clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t m = blockIdx.x;
  if (clocks != nullptr && tid == 0) clocks[m * 3] = clock64();

  const int lb_m = lbs[m];
  const int n = lb_m + 1;
  const int K = (n + T - 1) / T;
  const int j0 = tid * K;
  const int cnt = max(0, min(K, n - j0));
  const int64_t ld = static_cast<int64_t>(lb) + 1;

  int* last_t = reinterpret_cast<int*>(smem);   // [T] each thread's last t
  int* vlast = last_t + T;                      // [T] its last V of a row
  int* wtot = vlast + T;                        // [32] warp maxima of t
  unsigned char* state = row_scratch != nullptr
                             ? row_scratch + m * region_bytes
                             : reinterpret_cast<unsigned char*>(wtot + 32);
  int* v = reinterpret_cast<int*>(state);
  int* f = v + slots;
  uint8_t* pb = reinterpret_cast<uint8_t*>(f + slots);
  int8_t* bc = reinterpret_cast<int8_t*>(pb + slots);

  // row 0: V = GO + GE*j (0 at j = 0), F = _NEG; codes outside 0..3 are
  // stored as 4, which no center code matches
  int vl = 0;
  for (int k = 0; k < cnt; ++k) {
    const int j = j0 + k;
    const int s = k * T + tid;
    vl = j == 0 ? 0 : kGapOpen + kGapExt * j;
    v[s] = vl;
    f[s] = kNeg;
    int b = j >= 1 ? bmat[m * lb + (j - 1)] : 4;
    bc[s] = static_cast<int8_t>(b >= 0 && b < 4 ? b : 4);
  }
  if (cnt > 0) vlast[tid] = vl;
  __syncthreads();

  uint8_t* pmem = ptr + m * static_cast<int64_t>(la) * ld;
  for (int i = 1; i <= la; ++i) {
    const int ci = c[i - 1];
    const bool cvalid = static_cast<unsigned>(ci) < 4u;
    // pass 1: F, the diagonal and vert; each thread's max and last t
    int dv = (cnt > 0 && j0 > 0) ? vlast[tid - 1] : 0;
    int lm = INT_MIN, lt = INT_MIN;
    for (int k = 0; k < cnt; ++k) {
      const int j = j0 + k;
      const int s = k * T + tid;
      const int vp = v[s];
      const int fe = f[s] + kGapExt;
      const int fo = vp + (kGapOpen + kGapExt);
      const int fc = max(fe, fo);
      int vert;
      uint8_t p;
      if (j == 0) {
        vert = fc;
        p = 1;
      } else {
        const int d = dv + ((cvalid && bc[s] == ci) ? kMatch : kMismatch);
        vert = max(d, fc);
        p = d < fc;
      }
      dv = vp;
      v[s] = vert;
      f[s] = fc;
      pb[s] = static_cast<uint8_t>(p | ((fe >= fo) << 2));
      const int t = vert + kGapOpen - kGapExt * j;
      lm = max(lm, t);
      lt = t;
    }
    // inclusive max-scan of the threads' maxima inside the warp, then the
    // warps' totals through shared memory
    int inc = lm;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc = max(inc, o);
    }
    if (lane == 31) wtot[warp] = inc;
    last_t[tid] = lt;
    __syncthreads();
    int run = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) run = INT_MIN;
    for (int w = 0; w < warp; ++w) run = max(run, wtot[w]);
    // run = max t[0..j-1] and prevt = t[j-1] before column j
    int prevt = tid > 0 ? last_t[tid - 1] : INT_MIN;
    uint8_t* prow = pmem + static_cast<int64_t>(i - 1) * ld + j0;
    int vc = 0;
    for (int k = 0; k < cnt; ++k) {
      const int j = j0 + k;
      const int s = k * T + tid;
      const int vert = v[s];
      int e;
      uint8_t ec;
      if (j == 0) {
        e = kNeg;
        ec = 0;
      } else {
        e = run + kGapExt * j;
        ec = prevt < run;
      }
      vc = max(vert, e);
      const uint8_t q = pb[s];
      const uint8_t pp = e > vert ? 2 : (q & 3);
      prow[k] = static_cast<uint8_t>(pp | (q & 4) | (ec << 3));
      v[s] = vc;
      const int t = vert + kGapOpen - kGapExt * j;
      run = max(run, t);
      prevt = t;
    }
    if (cnt > 0) vlast[tid] = vc;
    __syncthreads();
  }

  uint8_t* out = ops + m * steps;
  for (int64_t s = tid; s < steps; s += T) out[s] = kPadOp;
  __syncthreads();
  if (tid != 0) return;
  if (clocks != nullptr) clocks[m * 3 + 1] = clock64();
  trace_member(pmem, ld, la, lb_m, out, steps);
  if (clocks != nullptr) clocks[m * 3 + 2] = clock64();
}

template <int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    gotoh_dp_warp_kernel(const int32_t* __restrict__ c, int la,
                         const int32_t* __restrict__ bmat,
                         const int32_t* __restrict__ lbs, int lb,
                         int64_t members, uint8_t* __restrict__ ptr,
                         uint8_t* __restrict__ ops, int64_t steps,
                         long long* clocks) {
  static_assert(K % 8 == 0 && K >= 8 && K <= 40, "K: 8, 16, ..., 40");
  constexpr int64_t kPitch = 32 * K;
  const int lane = threadIdx.x & 31;
  const int64_t m =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= members) return;   // the whole warp: no barrier waits for it
  if (clocks != nullptr && lane == 0) clocks[m * 3] = clock64();

  const int lb_m = lbs[m];
  const int j0 = lane * K;
  // row 0: V = GO + GE*j (0 at j = 0), F = _NEG; column j's code b[j-1]
  // one-hot in its byte (1 << b), 0 where it is outside 0..3, at column 0
  // and past lb_m: no center code matches it
  int v[K], f[K];
  uint32_t code[K / 4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    uint32_t b = 0;
    if (j >= 1 && j <= lb_m) {
      const unsigned x = static_cast<unsigned>(bmat[m * lb + (j - 1)]);
      b = x < 4u ? 1u << x : 0u;
    }
    if (k % 4 == 0) code[k / 4] = 0;
    code[k / 4] |= b << (8 * (k % 4));
    v[k] = j == 0 ? 0 : kGapOpen + kGapExt * j;
    f[k] = kNeg;
  }

  // t = vert + tb - GE*k and E = run + eb + GE*k at the lane's column j0+k
  static_assert(kGapExt == -1, "t and E below take GE = -1");
  const int tb = kGapOpen - kGapExt * j0;
  const int eb = kGapExt * j0;
  uint8_t* prow = ptr + m * static_cast<int64_t>(la) * kPitch + j0;
  const bool stores = j0 <= lb_m;
  for (int i0 = 0; i0 < la; i0 += 32) {
    // 32 rows' center codes, one a lane, broadcast one a row
    const int cl = i0 + lane < la ? c[i0 + lane] : 4;
    const int rows = min(32, la - i0);
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const int ci = __shfl_sync(kFull, cl, r);
      const bool cvalid = static_cast<unsigned>(ci) < 4u;
      const uint32_t cmask = cvalid ? 0x01010101u << ci : 0u;
      const int cshift = cvalid ? ci : 0;
      // pass 1: F, the diagonal, vert (lane 0's column 0 gets a diagonal
      // of _NEG, so vert = F and p = 1 there) and the lane's max of t
      int dv = __shfl_up_sync(kFull, v[K - 1], 1);
      if (lane == 0) dv = kNeg;
      uint32_t pw[K / 4];
      uint32_t mw = 0;
      int lm = INT_MIN;   // max of vert + k, t less tb
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int sh = 8 * (k % 4);
        if (k % 4 == 0) {
          // bytes of 3 where the code matches ci, else 0
          mw = ((code[k / 4] & cmask) >> cshift) * 3u;
          pw[k / 4] = 0;
        }
        const int d = dv + static_cast<int>((mw >> sh) & 0xffu) + kMismatch;
        const int vp = v[k];
        const int fo = vp + (kGapOpen + kGapExt);
        const bool fcont = f[k] + kGapExt >= fo;
        const int fc = max(f[k] + kGapExt, fo);
        const bool pd = d < fc;
        const int vert = max(d, fc);
        dv = vp;
        f[k] = fc;
        v[k] = vert;
        pw[k / 4] += (pd ? 1u << sh : 0u) + (fcont ? 4u << sh : 0u);
        lm = max(lm, vert + k);
      }
      // exclusive max-scan of the lanes' maxima: run = max t[0..j0-1];
      // tprev = t[j0-1], the left lane's last t
      int run = __shfl_up_sync(kFull, lm + tb, 1);
      int tprev = __shfl_up_sync(kFull, v[K - 1] + tb + (K - 1), 1);
      if (lane == 0) run = tprev = INT_MIN;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, run, off);
        if (lane >= off) run = max(run, o);
      }
      // pass 2: E, econt, V and p = 2 where E > vert; before column j,
      // run = max t[0..j-1] and tprev = t[j-1]
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int sh = 8 * (k % 4);
        // econt: t[j-1] below max t[..j-1], that is below max t[..j-2]
        // (at the lane's first column run holds t[j-1] already)
        const bool ec = tprev < run;
        run = max(run, tprev);
        const int vert = v[k];
        const int e = run + eb - k;
        const bool p2 = e > vert;
        v[k] = max(vert, e);
        tprev = vert + tb + k;
        pw[k / 4] += (p2 ? 2u << sh : 0u) + (ec ? 8u << sh : 0u);
      }
      // p = 2 replaces pass 1's diagonal bit
#pragma unroll
      for (int q = 0; q < K / 4; ++q)
        pw[q] &= ~((pw[q] >> 1) & 0x01010101u);
      if (stores) store_words<K>(prow + (i0 + r) * kPitch, pw);
    }
  }

  uint8_t* out = ops + m * steps;
  for (int64_t s = lane; s < steps; s += 32) out[s] = kPadOp;
  __syncwarp();
  if (lane != 0) return;
  if (clocks != nullptr) clocks[m * 3 + 1] = clock64();
  trace_member(ptr + m * static_cast<int64_t>(la) * kPitch, kPitch, la, lb_m,
               out, steps);
  if (clocks != nullptr) clocks[m * 3 + 2] = clock64();
}

template <int K>
cudaError_t launch_warp(unsigned grid, cudaStream_t stream, const int32_t* c,
                        int la, const int32_t* bmat, const int32_t* lbs,
                        int lb, int64_t m, uint8_t* ptr, uint8_t* ops,
                        int64_t steps, long long* clocks) {
  gotoh_dp_warp_kernel<K><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(
      c, la, bmat, lbs, lb, m, ptr, ops, steps, clocks);
  return cudaGetLastError();
}

}  // namespace

// c int32 [la], bmat int32 [M, lb], lbs int32 [M] (0 <= lbs <= lb), ptr
// uint8 [M * la * (lb + 1)] scratch, ops uint8 [M, steps] (steps = la +
// max(lbs)); row_scratch: NULL keeps each member's row state in shared
// memory, else M regions of region_bytes (>= 10 * slots); clocks: NULL or
// int64 [M, 3] (clock64 at the start, before and after the trace).
extern "C" int gotoh_dp_launch(const void* c, int64_t la, const void* bmat,
                               const void* lbs, int64_t m, int64_t lb,
                               void* ptr, void* ops, int64_t steps,
                               void* row_scratch, int64_t region_bytes,
                               int threads, void* clocks, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || la < 0 || lb < 0 ||
      la > INT_MAX || lb >= INT_MAX || m > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || steps <= 0) return static_cast<int>(cudaSuccess);
  const int64_t slots = (lb + 1 + threads - 1) / threads * threads;
  if (slots > INT_MAX / kSlotBytes) return static_cast<int>(cudaErrorInvalidValue);
  int64_t smem = (2 * static_cast<int64_t>(threads) + 32) * 4;
  if (row_scratch == nullptr) {
    smem += kSlotBytes * slots;
  } else if (region_bytes < kSlotBytes * slots || region_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(gotoh_dp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gotoh_dp_kernel<<<static_cast<unsigned>(m), threads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c), static_cast<int>(la),
      static_cast<const int32_t*>(bmat), static_cast<const int32_t*>(lbs),
      static_cast<int>(lb), static_cast<uint8_t*>(ptr),
      static_cast<uint8_t*>(ops), steps, static_cast<uint8_t*>(row_scratch),
      region_bytes, static_cast<int>(slots), static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gotoh_dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The warp kernel: c, la, bmat, lbs, M, lb, ops, steps and clocks as
// above; k (8, 16, ..., 40) columns a lane, 32 * k >= lb + 1; ptr uint8
// [M * la * 32 * k] scratch (pitch 32 * k), 16-byte aligned.
extern "C" int gotoh_dp_warp_launch(const void* c, int64_t la, const void* bmat,
                                    const void* lbs, int64_t m, int64_t lb,
                                    void* ptr, void* ops, int64_t steps, int k,
                                    void* clocks, void* stream) {
  if (la < 0 || lb < 0 || la > INT_MAX || lb >= INT_MAX || m > INT_MAX ||
      32 * static_cast<int64_t>(k) < lb + 1 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || steps <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid =
      static_cast<unsigned>((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cc = static_cast<const int32_t*>(c);
  const auto* bb = static_cast<const int32_t*>(bmat);
  const auto* ll = static_cast<const int32_t*>(lbs);
  auto* pp = static_cast<uint8_t*>(ptr);
  auto* oo = static_cast<uint8_t*>(ops);
  auto* ck = static_cast<long long*>(clocks);
  const int la_i = static_cast<int>(la), lb_i = static_cast<int>(lb);
  cudaError_t err;
  switch (k) {
    case 8: err = launch_warp<8>(grid, s, cc, la_i, bb, ll, lb_i, m, pp, oo, steps, ck); break;
    case 16: err = launch_warp<16>(grid, s, cc, la_i, bb, ll, lb_i, m, pp, oo, steps, ck); break;
    case 24: err = launch_warp<24>(grid, s, cc, la_i, bb, ll, lb_i, m, pp, oo, steps, ck); break;
    case 32: err = launch_warp<32>(grid, s, cc, la_i, bb, ll, lb_i, m, pp, oo, steps, ck); break;
    case 40: err = launch_warp<40>(grid, s, cc, la_i, bb, ll, lb_i, m, pp, oo, steps, ck); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* gotoh_dp_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
