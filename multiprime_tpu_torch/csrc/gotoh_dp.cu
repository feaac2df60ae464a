// Center-star Gotoh row DP and its back-trace, for Hopper (sm_90a).
//
// Replaces the JAX device program multiprime_tpu/align/device.py _build
// (:38): one lax.scan over the center's rows (`row`, :50-82) and one over
// the trace steps (`trace_step`, :89-116), jitted into one XLA program a
// block of members.  Its plain PyTorch version is
// multiprime_tpu_torch/align/device.py gotoh_block_reference; the results
// are equal element for element (same scores, same tie-breaks).
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
// and the packed pointer byte p | fcont << 2 | econt << 3 of each cell.
// Columns past a member's own length are never read by its trace and
// depend on nothing left of them, so each member runs its own lb_m + 1
// columns only.  Scores stay far from int32's ends: _NEG = -2**28 is
// never accumulated (F's max takes the real open term at once, E's
// sentinel is only compared), and real scores are above -5 (la + lb).
//
// Design: one CTA of T threads (the wrapper sets 256) a member; tid owns the
// contiguous columns [tid*K, tid*K + K), K = ceil((lb_m+1) / T);
// their V, F, a pointer byte and the member's code live in slots k*T + tid
// (bank-conflict free), in dynamic shared memory or, for members too long
// for it, in a global scratch the wrapper allocates.  A row is two passes
// and two barriers: pass 1 computes F, the diagonal and vert (the
// diagonal's V[i-1, j0-1] is the left neighbour's last value of the row
// before, published in shared memory), and each thread's max of t; a
// warp-shuffle max-scan and one shared step across warps give each thread
// the exclusive prefix max of t (lax.cummax), and pass 2 finishes E, V and
// the pointer byte, written to a global pointer scratch [M, la, lb+1].
// After the last row one thread walks the member's trace over it, la + lb_m
// dependent one-byte loads, and writes the reverse-order ops; the CTA has
// filled the member's output row with _PAD_OP first.
//
// What bounds it: operations.  The DP needs about 20 integer operations a
// cell against one pointer byte written (the smoke check's bound counts
// those of _build's row); this code does 28, computing t and the running
// max in both passes and packing the byte in two steps.  The rows are a chain of la dependent steps of two barriers
// each, and the trace a chain of dependent loads, so a CTA's latency and
// not the card's rate sets the time of a small block.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMatch = 2;
constexpr int kMismatch = -1;
constexpr int kGapOpen = -4;
constexpr int kGapExt = -1;
constexpr int kNeg = -(1 << 28);
constexpr uint8_t kPadOp = 3;
constexpr int kSlotBytes = 10;   // V, F (int32), pointer bits, code

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
      const int o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc = max(inc, o);
    }
    if (lane == 31) wtot[warp] = inc;
    last_t[tid] = lt;
    __syncthreads();
    int run = __shfl_up_sync(0xffffffffu, inc, 1);
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
  // the trace (JAX trace_step): state st 0 = V, 1 = F (vertical), 2 = E
  int i = la, j = lb_m, st = 0;
  for (int64_t s = 0; s < steps && (i != 0 || j != 0); ++s) {
    const int pf = i > 0 ? pmem[static_cast<int64_t>(i - 1) * ld + j] : 0;
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
  if (clocks != nullptr) clocks[m * 3 + 2] = clock64();
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
