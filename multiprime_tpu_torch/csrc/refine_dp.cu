// Profile-refine column DP and its back-trace, for Hopper (sm_90a): two
// kernels, chosen by the block's shape.
//
// Replaces the JAX device program multiprime_tpu/align/device.py
// _build_refine (:122): one lax.scan over the MSA's columns (`col`,
// :147-178) and one over the trace steps (`trace_step`, :180-193), jitted
// into one XLA program a block of members.  Its plain PyTorch version is
// multiprime_tpu_torch/align/device.py refine_block_reference; the placed
// columns of both kernels are equal to it element for element.
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
// a member's len never feed the ones below it, so their values (and
// pointer bytes) may be anything.
//
// refine_dp_warp_kernel<K>, every block with lmax + 1 <= 32 * 40 = 1280
// positions (the wrapper's choice, by shape only): one warp a member and a
// CTA, no block barrier. Lane l owns K consecutive slots (K one of 8, 16, 24,
// 32, 40, the smallest with 32K >= lmax + 1; K = 40 already takes most of the
// 255 registers a thread may have), slot f holding position f - off with off
// = K - 1 - len % K, so that position len is the last slot of its lane and
// its V a fixed register (no per-cell select of the end); the off slots left
// of position 0 hold V = 0 and add a zero, so position 0's diagonal is 0 and
// its V = 0 needs no select either (exact while go, ge <= 0, as GO * occ and
// GE * occ are: G <= 0 there, so skip = G > 0 never holds; the wrapper
// gives blocks with a positive gap term to the CTA kernel). V and G of a lane's slots live in K registers each and its residue
// codes, as byte offsets into a profile row, 4 to a register, every index
// known at compile time. A column has no scan: only the left lane's last V of
// the column before crosses lanes, one shuffle a column. The profile is
// staged 32 columns ahead: for a chunk of 32 columns lane l loads column c0 +
// l's nine floats, computes the six terms s4[k] - occ2 (the same rounding the
// plain version's gather-then-subtract does once a cell) and writes them with
// go, ge and the zero to a per-warp shared ring [2][32][12]; the next chunk's
// loads are issued before the current chunk's columns run, so one global
// latency is paid a chunk, behind 32 columns of work. Each cell reads its
// term from the ring (at most 7 addresses a column, one word each: no bank
// conflict). The pointer bytes are packed in registers and stored as whole
// 16-byte (K a multiple of 16) or 8-byte words, so the scratch is [M, C,
// 32K], indexed by slot. The trace is walked in tiles of 32 steps: from slot
// f and column j, step q reads column max(j - q, 1) - 1 at a slot in [f - q,
// f], so lane q's row of a per-warp shared tile holds that column's words
// around the tile's slots, and lane 0 walks the 32 steps from the tile; each
// lane loads its row of the next tile (whose columns are known, and whose
// slots lie within 63 below this tile's first) while lane 0 walks this one,
// so the DRAM round trip of a tile hides behind the walk of the one
// before. What bounds it: latency. One warp a member puts about one warp on
// each scheduler, which issues a column's dozen instructions a cell with the
// cells' independence as the only cover.
//
// refine_dp_kernel, longer members: one CTA of T threads (the wrapper
// sets 256) a member, thread tid owning positions [tid*K, tid*K + K),
// their V, G and residue code in slots k*T + tid of shared memory (or of
// a global scratch for members too long for it); a loop over the columns.
// Only V[jc-1, i0-1] crosses threads, the left neighbour's last value,
// published in a shared array double-buffered by column parity, so a
// column costs one barrier.  The pointer bytes go to a global scratch [M,
// C, lmax + 1]; after the last column one thread walks the trace (C steps
// at most, one dependent one-byte load each) and writes the placed
// columns over the -1 the CTA filled the output row with.  What bounds
// it: the columns are a chain of C dependent steps of one barrier each,
// and the trace a chain of dependent loads, so a CTA's latency sets the
// time of a block.
//
// The function needs seven float32 operations a cell and eight a column
// and member (the six profile terms, the end column's compare and select;
// the smoke check's bound counts those of _build_refine's col); the
// pointer scratch is the kernels' own, read back only by their trace.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_words.cuh"

namespace {

constexpr float kNegF = -1e30f;
constexpr int kSlotBytes = 9;    // V, G (float32), residue code
constexpr unsigned kFull = 0xffffffffu;

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

// Column c's profile inputs of member m (zeros past the last column):
// x[0..5] = s4, x[6] = go, x[7] = ge, x[8] = occ2.
__device__ __forceinline__ void load_column(const float* __restrict__ s4,
                                            const float* __restrict__ go_c,
                                            const float* __restrict__ ge_c,
                                            const float* __restrict__ occ2,
                                            int64_t c, int64_t C, int64_t M,
                                            int64_t m, float (&x)[9]) {
  if (c >= C) {
#pragma unroll
    for (int q = 0; q < 9; ++q) x[q] = 0.f;
    return;
  }
  const int64_t at = c * M + m;
  // 24 bytes a (column, member): 8-byte aligned
  const float2* p = reinterpret_cast<const float2*>(s4 + at * 6);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float2 w = p[q];
    x[2 * q] = w.x;
    x[2 * q + 1] = w.y;
  }
  x[6] = go_c[at];
  x[7] = ge_c[at];
  x[8] = occ2[at];
}

// A lane's column of the ring: the six profile terms s4[k] - occ2 (one
// rounding, as the plain version's gather-then-subtract), go, ge, and the
// zero that the slots left of position 0 add.
__device__ __forceinline__ void stage_column(float* row, const float (&x)[9]) {
  float4* r = reinterpret_cast<float4*>(row);
  r[0] = make_float4(__fsub_rn(x[0], x[8]), __fsub_rn(x[1], x[8]),
                     __fsub_rn(x[2], x[8]), __fsub_rn(x[3], x[8]));
  r[1] = make_float4(__fsub_rn(x[4], x[8]), __fsub_rn(x[5], x[8]), x[6], x[7]);
  r[2] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The first slot of the trace window that ends at slot f: the 16-byte
// word that holds slot f - 63 (or slot 0).
__device__ __forceinline__ int window_base(int f) {
  return (f > 63 ? f - 63 : 0) & ~15;
}

template <int K>
__global__ void __launch_bounds__(32)
    refine_dp_warp_kernel(const int64_t* __restrict__ res_codes,
                          const int64_t* __restrict__ lens, int lmax,
                          const float* __restrict__ s4,
                          const float* __restrict__ go_c,
                          const float* __restrict__ ge_c,
                          const float* __restrict__ occ2, int64_t C,
                          int64_t M, uint8_t* __restrict__ ptr,
                          int64_t* __restrict__ cols, long long* clocks) {
  static_assert(K % 8 == 0 && K >= 8 && K <= 40, "K: 8, 16, ..., 40");
  constexpr int64_t kPitch = 32 * K;
  constexpr uint32_t kZero = 32;   // byte offset of the ring row's zero
  // the profile ring ([buffer][column of the chunk][6 terms, go, ge, 0])
  // and the trace's tile ([step][80 bytes of its column])
  __shared__ __align__(16) float ring[2][32][12];
  __shared__ __align__(16) uint8_t tile[32][80];
  const int lane = threadIdx.x;
  const int64_t m = blockIdx.x;
  if (clocks != nullptr && lane == 0) clocks[m * 3] = clock64();

  const int len = static_cast<int>(lens[m]);
  // slot f (lane f / K, register f % K) holds position f - off, so that
  // position len is the last slot of lane `owner` and its V a fixed
  // register; the off slots left of position 0 hold V = 0 and add the
  // ring's zero, so position 0's diagonal is 0 + 0 and, with go, ge <= 0
  // (G <= 0 there), V = 0 with no select
  const int off = K - 1 - len % K;
  const int owner = (len + off) / K;
  const int f0 = lane * K;
  // column 0: V = 0 at and left of position 0, else -1e30; G = -1e30;
  // position i's code r[i-1] as the byte offset 4 * r[i-1] of its term in
  // a ring row
  float v[K], g[K];
  uint32_t code4[K / 4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = f0 + k - off;
    uint32_t b = kZero;
    if (i >= 1 && i <= lmax)
      b = 4u * static_cast<uint32_t>(res_codes[m * lmax + (i - 1)]);
    if (k % 4 == 0) code4[k / 4] = 0;
    code4[k / 4] |= b << (8 * (k % 4));
    v[k] = i <= 0 ? 0.f : kNegF;
    g[k] = kNegF;
  }

  float x[9];
  load_column(s4, go_c, ge_c, occ2, lane, C, M, m, x);
  stage_column(ring[0][lane], x);
  __syncwarp();
  uint8_t* prow = ptr + m * C * kPitch + f0;
  const bool stores = f0 <= len + off;
  float best_v = kNegF;
  int64_t best_j = 0;
  for (int64_t c0 = 0; c0 < C; c0 += 32) {
    const int buf = static_cast<int>((c0 >> 5) & 1);
    const bool more = c0 + 32 < C;
    // the next chunk's loads, in flight while this chunk's columns run
    if (more) load_column(s4, go_c, ge_c, occ2, c0 + 32 + lane, C, M, m, x);
    const int n = static_cast<int>(C - c0 < 32 ? C - c0 : 32);
#pragma unroll 1
    for (int t = 0; t < n; ++t) {
      const float* row = ring[buf][t];
      const char* terms = reinterpret_cast<const char*>(row);
      const float go = row[6];
      const float ge = row[7];
      float dv = __shfl_up_sync(kFull, v[K - 1], 1);
      if (lane == 0) dv = 0.f;
      uint32_t pw[K / 4];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int sh = 8 * (k % 4);
        if (k % 4 == 0) pw[k / 4] = 0;
        const float sub = *reinterpret_cast<const float*>(
            terms + ((code4[k / 4] >> sh) & 0xffu));
        const float vp = v[k];
        const float gp = g[k];
        const float oc = __fadd_rn(vp, go);
        const bool gcont = gp >= oc;
        const float gc = __fadd_rn(fmaxf(gp, oc), ge);
        const float diag = __fadd_rn(dv, sub);
        const bool skip = gc > diag;
        dv = vp;
        v[k] = skip ? gc : diag;
        g[k] = gc;
        pw[k / 4] |= (skip ? 1u << sh : 0u) | (gcont ? 2u << sh : 0u);
      }
      if (lane == owner && v[K - 1] > best_v) {
        best_v = v[K - 1];
        best_j = c0 + t + 1;
      }
      if (stores) store_words<K>(prow + (c0 + t) * kPitch, pw);
    }
    // this chunk's reads of the other buffer ended at the last chunk's
    // __syncwarp
    if (more) stage_column(ring[buf ^ 1][lane], x);
    __syncwarp();
  }
  best_j = __shfl_sync(kFull, best_j, owner);

  int64_t* out = cols + m * C;
  for (int64_t s = lane; s < C; s += 32) out[s] = -1;
  __syncwarp();
  if (clocks != nullptr && lane == 0) clocks[m * 3 + 1] = clock64();
  // the trace (JAX trace_step) in tiles of 32 steps, done once i == 0
  // (then every later step places nothing), on slots f = i + off.  From
  // (f, j) step q of a tile reads column max(j - q, 1) - 1 at a slot in
  // [f - q, f]: lane q's row of the tile holds that column's words from
  // window_base(f') through slot f', f' the slot the tile before started
  // from (f itself for the first tile), at most 5 words.  Each lane loads
  // its row of the next tile while lane 0 walks this one, so a tile's
  // DRAM round trip hides behind the walk before it.
  const uint8_t* pm = ptr + m * C * kPitch;
  const int cn = static_cast<int>(C);
  int f = len + off, j = static_cast<int>(best_j), s = 0, skip = 0;
  uint4 r[5];
  auto load = [&](int jt, int ft) {
    const int col = (jt - lane > 1 ? jt - lane : 1) - 1;
    const int b = window_base(ft);
    const uint4* src = reinterpret_cast<const uint4*>(
        pm + static_cast<int64_t>(col) * kPitch + b);
#pragma unroll
    for (int w = 0; w < 5; ++w)
      if (b + 16 * w <= ft) r[w] = src[w];
  };
  auto put = [&](int ft) {
    uint4* dst = reinterpret_cast<uint4*>(tile[lane]);
#pragma unroll
    for (int w = 0; w < 5; ++w)
      if (window_base(ft) + 16 * w <= ft) dst[w] = r[w];
  };
  load(j, f);
  put(f);
  int b = window_base(f);
  __syncwarp();
  while (s < cn && f != off) {
    const int f_start = f;
    const bool more = s + 32 < cn;
    if (more) load(j - 32, f);
    if (lane == 0) {
      const int n = cn - s < 32 ? cn - s : 32;
      int o = f - b, done = 0;
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        if (q < n && o + b != off) {
          const int p = tile[q][o];
          const bool take = j - q > o + b - off && (skip || (p & 1));
          if (!take) {
            out[s + q] = j - q - 1;
            --o;
          }
          skip = take && (p & 2);
          done = q + 1;
        }
      }
      f = o + b;
      s += done;
      j -= done;
    }
    __syncwarp();
    f = __shfl_sync(kFull, f, 0);
    j = __shfl_sync(kFull, j, 0);
    s = __shfl_sync(kFull, s, 0);
    skip = __shfl_sync(kFull, skip, 0);
    if (more && s < cn && f != off) put(f_start);
    b = window_base(f_start);
    __syncwarp();
  }
  if (clocks != nullptr && lane == 0) clocks[m * 3 + 2] = clock64();
}

template <int K>
cudaError_t launch_warp(cudaStream_t stream, const int64_t* res_codes,
                        const int64_t* lens, int lmax, const float* s4,
                        const float* go_c, const float* ge_c,
                        const float* occ2, int64_t c, int64_t m,
                        uint8_t* ptr, int64_t* cols, long long* clocks) {
  refine_dp_warp_kernel<K><<<static_cast<unsigned>(m), 32, 0, stream>>>(
      res_codes, lens, lmax, s4, go_c, ge_c, occ2, c, m, ptr, cols, clocks);
  return cudaGetLastError();
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

// The warp kernel: res_codes, lens, M, lmax, s4, go_c, ge_c, occ2, C, cols
// and clocks as above, go_c and ge_c <= 0 (position 0's V is 0 only then);
// k (8, 16, ..., 40) slots a lane, 32 * k >= lmax + 1; ptr uint8 [M * C *
// 32 * k] scratch (pitch 32 * k), 16-byte aligned; s4 8-byte aligned.
extern "C" int refine_dp_warp_launch(const void* res_codes, const void* lens,
                                     int64_t m, int64_t lmax, const void* s4,
                                     const void* go_c, const void* ge_c,
                                     const void* occ2, int64_t c, void* ptr,
                                     void* cols, int k, void* clocks,
                                     void* stream) {
  if (lmax < 0 || m > INT_MAX || c < 0 || c > INT_MAX ||
      32 * static_cast<int64_t>(k) < lmax + 1 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(s4) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rc = static_cast<const int64_t*>(res_codes);
  const auto* ln = static_cast<const int64_t*>(lens);
  const auto* s4f = static_cast<const float*>(s4);
  const auto* gof = static_cast<const float*>(go_c);
  const auto* gef = static_cast<const float*>(ge_c);
  const auto* o2f = static_cast<const float*>(occ2);
  auto* pp = static_cast<uint8_t*>(ptr);
  auto* cc = static_cast<int64_t*>(cols);
  auto* ck = static_cast<long long*>(clocks);
  const int lm = static_cast<int>(lmax);
  cudaError_t err;
  switch (k) {
    case 8: err = launch_warp<8>(st, rc, ln, lm, s4f, gof, gef, o2f, c, m, pp, cc, ck); break;
    case 16: err = launch_warp<16>(st, rc, ln, lm, s4f, gof, gef, o2f, c, m, pp, cc, ck); break;
    case 24: err = launch_warp<24>(st, rc, ln, lm, s4f, gof, gef, o2f, c, m, pp, cc, ck); break;
    case 32: err = launch_warp<32>(st, rc, ln, lm, s4f, gof, gef, o2f, c, m, pp, cc, ck); break;
    case 40: err = launch_warp<40>(st, rc, ln, lm, s4f, gof, gef, o2f, c, m, pp, cc, ck); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* refine_dp_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
