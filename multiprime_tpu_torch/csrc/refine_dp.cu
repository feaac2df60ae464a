// Profile-refine column DP and its back-trace, for Hopper (sm_90a).
//
// Replaces the JAX device program multiprime_tpu/align/device.py
// _build_refine (:122): one lax.scan over the MSA's columns (`col`,
// :147-178) and one over the trace steps (`trace_step`, :180-193), jitted
// into one XLA program a block of members.  Its plain PyTorch version is
// multiprime_tpu_torch/align/device.py refine_block_reference; the placed
// columns are equal element for element.
//
// A member's residues r[0..len-1] (codes 0..5) are realigned against the
// profile of the other rows.  For column jc (inputs s4 = 4*f6, go = GO*occ,
// ge = GE*occ, occ2 = 2*occ of that member and column, all rounded to
// float32 on the host) and residue position i in 0..len:
//
//   oc      = V[jc-1, i] + go;  gcont = G[jc-1, i] >= oc
//   G[jc,i] = max(G[jc-1, i], oc) + ge
//   diag    = V[jc-1, i-1] + (s4[r[i-1]] - occ2)   (i = 0: -1e30)
//   skip    = G > diag, strictly;  V = skip ? G : diag;  V[jc, 0] = 0
//
// with the pointer byte skip | gcont << 1.  Every step is one IEEE float32
// add, max or compare, as on the host and in XLA; nothing is multiplied on
// the card, so there is nothing to contract into an FMA (and the build
// never uses --use_fast_math).  -1e30 stays finite.  The best end column
// is the first jc + 1 at which V[jc, len] exceeds every earlier one
// (strictly), and the trace walks back from (len, best_j).  Positions past
// a member's len never feed the ones below it, so each member runs its own
// len + 1 positions.
//
// Design: one CTA a member, thread tid owning positions [tid*K, tid*K + K),
// their V, G and residue code in slots k*T + tid of shared memory (or of a
// global scratch for members too long for it); a loop over the columns.
// A column has no scan: only V[jc-1, i0-1] crosses threads, the left
// neighbour's last value, published in a shared array double-buffered by
// column parity, so a column costs one barrier.  The pointer bytes go to a
// global scratch [M, C, lmax + 1]; after the last column one thread walks
// the trace (C steps at most, one dependent one-byte load each) and writes
// the placed columns over the -1 the CTA filled the output row with.
//
// What bounds it: bytes.  One pointer byte written a cell against about
// eight float32 operations; the columns are a chain of C dependent steps
// and the trace a chain of dependent loads, so a CTA's latency sets the
// time of a block.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegF = -1e30f;
constexpr int kSlotBytes = 9;    // V, G (float32), residue code

__global__ void refine_dp_kernel(const int64_t* __restrict__ res_codes,
                                 const int64_t* __restrict__ lens, int lmax,
                                 const float* __restrict__ s4,
                                 const float* __restrict__ go_c,
                                 const float* __restrict__ ge_c,
                                 const float* __restrict__ occ2,
                                 int64_t C, int64_t M,
                                 uint8_t* __restrict__ ptr,
                                 int64_t* __restrict__ cols,
                                 uint8_t* row_scratch, int64_t region_bytes,
                                 int slots, long long* clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t m = blockIdx.x;
  if (clocks != nullptr && tid == 0) clocks[m * 3] = clock64();

  const int len = static_cast<int>(lens[m]);
  const int n = len + 1;
  const int K = (n + T - 1) / T;
  const int i0 = tid * K;
  const int cnt = max(0, min(K, n - i0));
  const int64_t ld = static_cast<int64_t>(lmax) + 1;
  const bool owns_end = cnt > 0 && i0 + cnt - 1 == len;

  float* vlast = reinterpret_cast<float*>(smem);     // [2][T] by parity
  int* best_sh = reinterpret_cast<int*>(vlast + 2 * T);  // [4]
  unsigned char* state = row_scratch != nullptr
                             ? row_scratch + m * region_bytes
                             : reinterpret_cast<unsigned char*>(best_sh + 4);
  float* v = reinterpret_cast<float*>(state);
  float* g = v + slots;
  uint8_t* code = reinterpret_cast<uint8_t*>(g + slots);

  float vl = 0.f;
  for (int k = 0; k < cnt; ++k) {
    const int i = i0 + k;
    const int s = k * T + tid;
    vl = i == 0 ? 0.f : kNegF;
    v[s] = vl;
    g[s] = kNegF;
    code[s] = i >= 1 ? static_cast<uint8_t>(res_codes[m * lmax + (i - 1)]) : 0;
  }
  if (cnt > 0) vlast[tid] = vl;
  __syncthreads();

  uint8_t* pmem = ptr + m * C * ld;
  float best_v = kNegF;
  int best_j = 0;
  for (int64_t jc = 0; jc < C; ++jc) {
    const int64_t at = jc * M + m;
    const float* s4j = s4 + at * 6;
    const float go = go_c[at];
    const float ge = ge_c[at];
    const float oc2 = occ2[at];
    const int buf = static_cast<int>(jc & 1);
    float dv = (cnt > 0 && i0 > 0) ? vlast[buf * T + tid - 1] : 0.f;
    uint8_t* prow = pmem + jc * ld + i0;
    float vc = 0.f;
    for (int k = 0; k < cnt; ++k) {
      const int i = i0 + k;
      const int s = k * T + tid;
      const float vp = v[s];
      const float gp = g[s];
      const float oc = __fadd_rn(vp, go);
      const bool gcont = gp >= oc;
      const float gc = __fadd_rn(fmaxf(gp, oc), ge);
      float diag = kNegF;
      if (i > 0) diag = __fadd_rn(dv, __fsub_rn(s4j[code[s]], oc2));
      const bool skip = gc > diag;
      vc = i == 0 ? 0.f : (skip ? gc : diag);
      dv = vp;
      v[s] = vc;
      g[s] = gc;
      prow[k] = static_cast<uint8_t>(skip | (gcont << 1));
    }
    if (cnt > 0) vlast[(buf ^ 1) * T + tid] = vc;
    if (owns_end && vc > best_v) {
      best_v = vc;
      best_j = static_cast<int>(jc + 1);
    }
    __syncthreads();
  }
  if (owns_end) best_sh[0] = best_j;

  int64_t* out = cols + m * C;
  for (int64_t s = tid; s < C; s += T) out[s] = -1;
  __syncthreads();
  if (tid != 0) return;
  if (clocks != nullptr) clocks[m * 3 + 1] = clock64();
  // the trace (JAX trace_step): done once i == 0, and then every later
  // step places nothing
  int64_t i = len, j = best_sh[0];
  bool skip = false;
  for (int64_t s = 0; s < C && i != 0; ++s) {
    const int64_t jj = (j > 1 ? j : 1) - 1;
    const int p = pmem[jj * ld + i];
    const bool take = j > i && (skip || (p & 1));
    if (!take) {
      out[s] = j - 1;
      --i;
    }
    skip = take && (p & 2);
    --j;
  }
  if (clocks != nullptr) clocks[m * 3 + 2] = clock64();
}

}  // namespace

// res_codes int64 [M, lmax] (codes 0..5), lens int64 [M] (0..lmax), s4
// float32 [C, M, 6], go_c/ge_c/occ2 float32 [C, M], ptr uint8 [M * C *
// (lmax + 1)] scratch, cols int64 [M, C]; row_scratch: NULL keeps each
// member's state in shared memory, else M regions of region_bytes (>= 9 *
// slots); clocks: NULL or int64 [M, 3] (clock64 at the start, before and
// after the trace).
extern "C" int refine_dp_launch(const void* res_codes, const void* lens,
                                int64_t m, int64_t lmax, const void* s4,
                                const void* go_c, const void* ge_c,
                                const void* occ2, int64_t c, void* ptr,
                                void* cols, void* row_scratch,
                                int64_t region_bytes, int threads,
                                void* clocks, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || lmax < 0 ||
      lmax >= INT_MAX || m > INT_MAX || c < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const int64_t slots = (lmax + 1 + threads - 1) / threads * threads;
  if (slots > INT_MAX / kSlotBytes) return static_cast<int>(cudaErrorInvalidValue);
  int64_t smem = 2 * static_cast<int64_t>(threads) * 4 + 16;
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
    err = cudaFuncSetAttribute(refine_dp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  refine_dp_kernel<<<static_cast<unsigned>(m), threads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(res_codes), static_cast<const int64_t*>(lens),
      static_cast<int>(lmax), static_cast<const float*>(s4),
      static_cast<const float*>(go_c), static_cast<const float*>(ge_c),
      static_cast<const float*>(occ2), c, m, static_cast<uint8_t*>(ptr),
      static_cast<int64_t*>(cols), static_cast<uint8_t*>(row_scratch),
      region_bytes, static_cast<int>(slots), static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* refine_dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
