// Copied from multiprime_tpu/native/seqlib.cpp.
// seqlib — native sequence runtime for multiprime_tpu.
//
// The reference pipeline leans on C/C++ tools (cd-hit, MAFFT, bowtie,
// fastANI) for its host-side heavy lifting.  The TPU build moves the
// data-parallel compute onto the chip; this library covers the remaining
// host-serial hot paths with native code:
//
//   * banded match-maximising global alignment (greedy clustering inner
//     loop — the cd-hit replacement's identity measure)
//   * batched identity of one query vs many references
//   * k-mer set extraction + sorted-set intersection (word filter / ANI)
//   * FASTA scanning into contiguous 2-bit-padded buffers
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Build: g++ -O3 -march=native -shared -fPIC seqlib.cpp -o libseqlib.so

#include <atomic>
#include <string>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

// Inverted k-mer -> cluster-id index for the greedy clusterer's word filter
// (cd-hit's short-word screen).  The per-query shared-count accumulation is
// epoch-stamped so no per-query clearing is needed.
struct Posting {
    std::unordered_map<int64_t, std::vector<int32_t>> map;
    std::vector<int32_t> counts;
    std::vector<int32_t> stamp;
    int32_t epoch = 0;
};

extern "C" {

// Identity = matches on the best-scoring banded global alignment divided by
// the shorter length; affine gaps (+2 match, -2 mismatch, -6 open,
// -1 extend); (score, matches) maximised lexicographically via a packed
// 64-bit key.  codes: 0..3 = ACGT, >=4 = ambiguous (never matches).
double banded_identity(const int8_t* a, int64_t la,
                       const int8_t* b, int64_t lb, int64_t band) {
    if (la > lb) { std::swap(a, b); std::swap(la, lb); }
    if (la == 0) return 0.0;
    const int64_t width = 2 * band + (lb - la) + 1;
    const int64_t SCALE = 1LL << 20;
    const int64_t NEG = -(1LL << 40);
    const int64_t EXT = -1 * SCALE, OPN = -6 * SCALE;
    std::vector<int64_t> v(width, NEG), f(width, NEG);
    std::vector<int64_t> v_new(width, NEG), f_new(width, NEG);
    for (int64_t w = 0; w < width; w++) {
        const int64_t j = w - band;
        if (j == 0) v[w] = 0;
        else if (j >= 1 && j <= lb) v[w] = OPN + EXT * j;
    }
    for (int64_t i = 0; i < la; i++) {
        const int8_t ai = a[i];
        int64_t e_state = NEG;     // Gotoh E at the current cell
        int64_t prev_vert = NEG;   // vert (diag/F max) of the previous cell
        for (int64_t w = 0; w < width; w++) {
            const int64_t j = i + 1 + w - band;
            if (j < 0 || j > lb) {
                v_new[w] = NEG; f_new[w] = NEG;
                e_state = NEG; prev_vert = NEG;
                continue;
            }
            const int64_t f_src = (w + 1 < width) ? f[w + 1] : NEG;
            const int64_t v_src = (w + 1 < width) ? v[w + 1] : NEG;
            const int64_t fn = std::max(f_src + EXT, v_src + OPN + EXT);
            int64_t vert = fn;
            if (j >= 1) {
                const bool m = (ai < 4 && b[j - 1] == ai);
                const int64_t diag =
                    v[w] + (m ? 2 * SCALE + 1 : -2 * SCALE);
                if (diag > vert) vert = diag;
            }
            // E opens from the previous cell's vert (opening from a previous
            // E is dominated by extending it), or extends.
            e_state = std::max(e_state + EXT, prev_vert + OPN + EXT);
            const int64_t best = std::max(vert, e_state);
            prev_vert = vert;
            f_new[w] = fn;
            v_new[w] = best;
        }
        v.swap(v_new);
        f.swap(f_new);
    }
    const int64_t end = lb - la + band;
    if (v[end] <= NEG) return 0.0;
    int64_t m = ((v[end] % SCALE) + SCALE) % SCALE;
    return (double)m / (double)la;
}

// Identity of one query against n references (concatenated codes + offsets).
// out[i] = identity(query, ref_i).  Skips references where the k-mer filter
// says identity can't reach `threshold` (shared[i] precomputed by caller;
// pass shared = NULL to skip filtering).
void banded_identity_batch(const int8_t* q, int64_t lq,
                           const int8_t* refs, const int64_t* offsets,
                           int64_t n, int64_t band, double* out) {
    for (int64_t i = 0; i < n; i++) {
        const int8_t* r = refs + offsets[i];
        const int64_t lr = offsets[i + 1] - offsets[i];
        out[i] = banded_identity(q, lq, r, lr, band);
    }
}

// Sorted unique k-mer codes of a sequence; returns count (codes buffer must
// hold len entries).  Positions containing ambiguous bases are skipped.
int64_t kmer_codes(const int8_t* seq, int64_t len, int64_t k,
                   int64_t* codes) {
    if (len < k) return 0;
    int64_t n = 0;
    uint64_t code = 0;
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    int64_t valid_run = 0;
    for (int64_t i = 0; i < len; i++) {
        if (seq[i] >= 4) { valid_run = 0; code = 0; continue; }
        code = ((code << 2) | (uint64_t)seq[i]) & mask;
        valid_run++;
        if (valid_run >= k) codes[n++] = (int64_t)code;
    }
    std::sort(codes, codes + n);
    return std::unique(codes, codes + n) - codes;
}

void* posting_new() { return new Posting(); }

void posting_free(void* h) { delete static_cast<Posting*>(h); }

// Index the (sorted unique) k-mers of a new cluster representative.
void posting_add(void* h, const int64_t* kmers, int64_t n, int32_t cluster) {
    Posting* p = static_cast<Posting*>(h);
    for (int64_t i = 0; i < n; i++) p->map[kmers[i]].push_back(cluster);
    if ((int64_t)p->counts.size() <= cluster) {
        p->counts.resize(cluster + 1, 0);
        p->stamp.resize(cluster + 1, -1);
    }
}

// Candidate clusters sharing >= min_count k-mers with the query, ascending
// cluster id; returns the candidate count (capped at max_out).
int64_t posting_query(void* h, const int64_t* kmers, int64_t n,
                      double min_count, int32_t* out, int64_t max_out) {
    Posting* p = static_cast<Posting*>(h);
    const int32_t epoch = ++p->epoch;
    int64_t n_cand = 0;
    for (int64_t i = 0; i < n; i++) {
        auto it = p->map.find(kmers[i]);
        if (it == p->map.end()) continue;
        for (int32_t ci : it->second) {
            if (p->stamp[ci] != epoch) {
                p->stamp[ci] = epoch;
                p->counts[ci] = 1;
            } else {
                ++p->counts[ci];
            }
        }
    }
    // collect ids meeting the threshold (touched ids carry this epoch)
    for (int64_t i = 0; i < n && n_cand < max_out; i++) {
        auto it = p->map.find(kmers[i]);
        if (it == p->map.end()) continue;
        for (int32_t ci : it->second) {
            if (p->stamp[ci] == epoch && (double)p->counts[ci] >= min_count) {
                p->stamp[ci] = epoch - 1;   // emit once
                out[n_cand++] = ci;
                if (n_cand >= max_out) break;
            }
        }
    }
    std::sort(out, out + n_cand);
    return n_cand;
}

// |A ∩ B| for sorted unique arrays.
int64_t sorted_intersect_count(const int64_t* a, int64_t na,
                               const int64_t* b, int64_t nb) {
    int64_t i = 0, j = 0, c = 0;
    while (i < na && j < nb) {
        if (a[i] < b[j]) i++;
        else if (a[i] > b[j]) j++;
        else { c++; i++; j++; }
    }
    return c;
}

// Scan a FASTA buffer: writes 0..3/4 codes into out (same size as buf),
// sequence boundaries into starts/ends (record i spans [starts[i], ends[i])
// in out), header offsets into hdr_starts/hdr_ends (into buf).  Returns the
// number of records, or -1 if max_records would be exceeded.
int64_t fasta_scan(const char* buf, int64_t len, int8_t* out,
                   int64_t* starts, int64_t* ends,
                   int64_t* hdr_starts, int64_t* hdr_ends,
                   int64_t max_records) {
    static int8_t lut[256];
    static bool init = false;
    if (!init) {
        memset(lut, 4, 256);
        lut['A'] = lut['a'] = 0; lut['C'] = lut['c'] = 1;
        lut['G'] = lut['g'] = 2; lut['T'] = lut['t'] = 3;
        lut['\n'] = lut['\r'] = -1;
        init = true;
    }
    int64_t n = -1, w = 0;
    for (int64_t i = 0; i < len; i++) {
        const char c = buf[i];
        if (c == '>') {
            if (n >= 0) ends[n] = w;
            n++;
            if (n >= max_records) return -1;
            hdr_starts[n] = i + 1;
            int64_t j = i + 1;
            while (j < len && buf[j] != '\n') j++;
            hdr_ends[n] = (j > i + 1 && buf[j - 1] == '\r') ? j - 1 : j;
            starts[n] = w;
            i = j;
        } else {
            const int8_t v = lut[(uint8_t)c];
            if (v >= 0) out[w++] = v;
        }
    }
    if (n >= 0) ends[n] = w;
    return n + 1;
}

// Profile realignment of MSA rows (mirror of align/refine.py's
// _realign_chunk): place each row's residues back into the C fixed columns
// against the exclude-self column profile.  Two-state (place/skip) DP with
// occupancy-weighted affine skip costs and free end skips.  rows/out are
// [m, c] ASCII; codes [m, c] with 0..3 = ACGT, 4 = gap, 5 = other;
// counts [c, 6] = global per-column code counts.  float32 arithmetic in the
// same operation order as the NumPy path so both backends agree exactly.
static void refine_one(const char* rows, const int8_t* codes,
                       int64_t m, int64_t c, const int32_t* counts,
                       float gap_open, float gap_ext, int64_t mi,
                       char* out) {
    const float NEGF = -1e30f;
    const char* row = rows + mi * c;
    const int8_t* code = codes + mi * c;
    std::vector<char> res_chars;
    std::vector<int8_t> res_codes;
    res_chars.reserve(c);
    res_codes.reserve(c);
    for (int64_t j = 0; j < c; j++) {
        if (code[j] != 4) {
            res_chars.push_back(row[j]);
            res_codes.push_back(code[j]);
        }
    }
    const int64_t L = (int64_t)res_chars.size();
    char* orow = out + mi * c;
    memset(orow, '-', c);
    if (L == 0) return;
    const float denom = (float)(m > 1 ? m - 1 : 1);
    // +8 slack: the AVX2 path computes full 8-lane chunks past L (results
    // beyond L are garbage but never read — v_cur[L]/backtrace stay exact)
    std::vector<float> v_prev(L + 9, NEGF), g_prev(L + 9, NEGF);
    std::vector<float> v_cur(L + 9, NEGF), g_cur(L + 9, NEGF);
    std::vector<uint8_t> ptr((size_t)(c + 1) * (L + 1) + 8, 0);
#if defined(__AVX2__)
    std::vector<int32_t> rc32(L > 0 ? (size_t)(L + 7) : 8, 0);
    for (int64_t i = 0; i < L; i++) rc32[i] = (int32_t)res_codes[i];
#endif
    float best_v = NEGF;
    int64_t best_j = 0;
    v_prev[0] = 0.0f;
    for (int64_t j = 1; j <= c; j++) {
        const int64_t col = j - 1;
        const int32_t* cnt = counts + col * 6;
        const int8_t self = code[col];
        float f[6];
        for (int b = 0; b < 4; b++)
            f[b] = (float)(cnt[b] - (self == b)) / denom;
        f[4] = 0.0f;
        f[5] = 0.0f;
        const float occ =
            1.0f - (float)(cnt[4] - (self == 4)) / denom;
        uint8_t* pj = ptr.data() + (size_t)j * (L + 1);
        int64_t i = 0;
        {   // i = 0: no diagonal predecessor
            const float open_cand = v_prev[0] + gap_open * occ;
            const bool gcont = g_prev[0] >= open_cand;
            g_cur[0] = (gcont ? g_prev[0] : open_cand) + gap_ext * occ;
            const bool take = g_cur[0] > NEGF;
            v_cur[0] = take ? g_cur[0] : NEGF;
            pj[0] = (uint8_t)take | ((uint8_t)gcont << 1);
            i = 1;
        }
#if defined(__AVX2__)
        {
            // lanes i..i+7 have no cross-lane dependency: g from the
            // previous column's g/v, diag from v_prev[i-1] — identical
            // float ops in identical per-element order to the scalar loop
            const __m256 vgo = _mm256_set1_ps(gap_open * occ);
            const __m256 vge = _mm256_set1_ps(gap_ext * occ);
            const __m256 vocc = _mm256_set1_ps(occ);
            const __m256 vtwo = _mm256_set1_ps(2.0f);
            const __m256 ftab = _mm256_setr_ps(f[0], f[1], f[2], f[3],
                                               0.0f, 0.0f, 0.0f, 0.0f);
            for (; i <= L; i += 8) {
                const __m256 vp = _mm256_loadu_ps(&v_prev[i]);
                const __m256 gp = _mm256_loadu_ps(&g_prev[i]);
                const __m256 open_cand = _mm256_add_ps(vp, vgo);
                const __m256 gcont = _mm256_cmp_ps(gp, open_cand,
                                                   _CMP_GE_OQ);
                const __m256 g = _mm256_add_ps(
                    _mm256_blendv_ps(open_cand, gp, gcont), vge);
                _mm256_storeu_ps(&g_cur[i], g);
                const __m256i cv = _mm256_loadu_si256(
                    (const __m256i*)&rc32[i - 1]);
                const __m256 fv = _mm256_permutevar8x32_ps(ftab, cv);
                const __m256 s = _mm256_mul_ps(
                    vtwo, _mm256_sub_ps(_mm256_mul_ps(vtwo, fv), vocc));
                const __m256 diag = _mm256_add_ps(
                    _mm256_loadu_ps(&v_prev[i - 1]), s);
                const __m256 take = _mm256_cmp_ps(g, diag, _CMP_GT_OQ);
                _mm256_storeu_ps(&v_cur[i],
                                 _mm256_blendv_ps(diag, g, take));
                // two mask bits -> one byte per lane
                const __m256i tb = _mm256_and_si256(
                    _mm256_castps_si256(take), _mm256_set1_epi32(1));
                const __m256i gb = _mm256_and_si256(
                    _mm256_castps_si256(gcont), _mm256_set1_epi32(2));
                const __m256i v32 = _mm256_or_si256(tb, gb);
                const __m256i v16 = _mm256_packs_epi32(v32, v32);
                const __m256i v8 = _mm256_packs_epi16(v16, v16);
                const uint32_t lo = (uint32_t)_mm256_extract_epi32(v8, 0);
                const uint32_t hi = (uint32_t)_mm256_extract_epi32(v8, 4);
                memcpy(pj + i, &lo, 4);
                memcpy(pj + i + 4, &hi, 4);
            }
            i = L + 1;          // chunks cover 1..L fully (slack-padded)
        }
#endif
        for (; i <= L; i++) {
            const float open_cand = v_prev[i] + gap_open * occ;
            const bool gcont = g_prev[i] >= open_cand;
            g_cur[i] = (gcont ? g_prev[i] : open_cand) + gap_ext * occ;
            const float s =
                2.0f * (2.0f * f[(int)res_codes[i - 1]] - occ);
            const float diag = v_prev[i - 1] + s;
            const bool take = g_cur[i] > diag;
            v_cur[i] = take ? g_cur[i] : diag;
            pj[i] = (uint8_t)take | ((uint8_t)gcont << 1);
        }
        v_cur[0] = 0.0f;
        if (v_cur[L] > best_v) {
            best_v = v_cur[L];
            best_j = j;
        }
        v_prev.swap(v_cur);
        g_prev.swap(g_cur);
    }
    int64_t i = L, j = best_j;
    bool state_skip = false;
    while (i > 0) {
        const uint8_t p = ptr[(size_t)j * (L + 1) + i];
        bool take;
        if (j <= i) {
            state_skip = false;
            take = false;
        } else if (state_skip) {
            take = true;
        } else {
            take = (p & 1) != 0;
        }
        if (take) {
            state_skip = (p & 2) != 0;
            j--;
        } else {
            orow[j - 1] = res_chars[i - 1];
            i--;
            j--;
            state_skip = false;
        }
    }
}

void refine_realign(const char* rows, const int8_t* codes,
                    int64_t m, int64_t c, const int32_t* counts,
                    float gap_open, float gap_ext, int64_t nthreads,
                    char* out) {
    if (nthreads <= 1 || m <= 1) {
        for (int64_t mi = 0; mi < m; mi++)
            refine_one(rows, codes, m, c, counts, gap_open, gap_ext, mi, out);
        return;
    }
    std::vector<std::thread> pool;
    std::atomic<int64_t> next(0);
    const int64_t nt = nthreads < m ? nthreads : m;
    for (int64_t t = 0; t < nt; t++) {
        pool.emplace_back([&]() {
            for (;;) {
                const int64_t mi = next.fetch_add(1);
                if (mi >= m) return;
                refine_one(rows, codes, m, c, counts, gap_open, gap_ext,
                           mi, out);
            }
        });
    }
    for (auto& th : pool) th.join();
}

// Profile-profile Gotoh alignment for the progressive aligner
// (align/progressive.py profile_align): the caller precomputes the
// [la, lb] substitution matrix (one GEMM), this routine runs the DP +
// traceback.  float32 arithmetic replicates the NumPy path operation by
// operation (including tie rules and the prefix-max E recurrence) so both
// backends produce identical op strings.  ops: 0 = M, 1 = D (column from A
// only), 2 = I (column from B only).  Returns the op count (<= la + lb).
int64_t profile_align_ops(const float* score, int64_t la, int64_t lb,
                          float gap_open, float gap_ext, uint8_t* ops) {
    const float NEGF = -1e30f;
    if (la == 0) { for (int64_t j = 0; j < lb; j++) ops[j] = 2; return lb; }
    if (lb == 0) { for (int64_t i = 0; i < la; i++) ops[i] = 1; return la; }
    // packed per-cell: bits 0-1 ptr (0 diag, 1 up, 2 left),
    // bit 2 fcont, bit 3 econt
    std::vector<uint8_t> cell((size_t)(la + 1) * (lb + 1), 0);
    {
        uint8_t* c0 = cell.data();
        for (int64_t j = 1; j <= lb; j++) c0[j] = 2;
        for (int64_t j = 2; j <= lb; j++) c0[j] |= 8;
    }
    std::vector<float> v_prev(lb + 1), f_prev(lb + 1, NEGF);
    std::vector<float> f_cur(lb + 1), vert(lb + 1), t(lb + 1);
    v_prev[0] = 0.0f;
    for (int64_t j = 1; j <= lb; j++)
        v_prev[j] = gap_open + gap_ext * (float)j;
    for (int64_t i = 1; i <= la; i++) {
        const float* sub = score + (size_t)(i - 1) * lb;
        uint8_t* ci = cell.data() + (size_t)i * (lb + 1);
        for (int64_t j = 0; j <= lb; j++) {
            const float ext = f_prev[j] + gap_ext;
            const float opn = (v_prev[j] + gap_open) + gap_ext;
            const bool fcont = ext >= opn;
            f_cur[j] = fcont ? ext : opn;
            ci[j] = fcont ? 4 : 0;
        }
        vert[0] = f_cur[0];
        ci[0] |= 1;
        for (int64_t j = 1; j <= lb; j++) {
            const float diag = v_prev[j - 1] + sub[j - 1];
            if (diag >= f_cur[j]) { vert[j] = diag; }
            else { vert[j] = f_cur[j]; ci[j] |= 1; }
        }
        // E state: e[j] = max over j' < j of (t[j'] ) + ge*j, with
        // t[j] = (vert[j] + go) - ge*j; econt marks an extension whose
        // opening happened before j-1.
        for (int64_t j = 0; j <= lb; j++)
            t[j] = (vert[j] + gap_open) - gap_ext * (float)j;
        float run = t[0];
        for (int64_t j = 1; j <= lb; j++) {
            if (j >= 2) run = std::max(run, t[j - 1]);
            const float e = run + gap_ext * (float)j;
            if (t[j - 1] < run) ci[j] |= 8;
            if (e > vert[j]) {
                vert[j] = e;               // vert becomes v_cur in place
                ci[j] = (ci[j] & 12) | 2;
            }
        }
        std::swap(v_prev, vert);
        std::swap(f_prev, f_cur);
    }
    // traceback (identical state machine to the NumPy path)
    int64_t i = la, j = lb, state = 0, n = 0;
    std::vector<uint8_t> rev;
    rev.reserve(la + lb);
    while (i > 0 || j > 0) {
        int m;
        if (i == 0) m = 2;
        else if (j == 0) m = 1;
        else if (state == 1) m = 1;
        else if (state == 2) m = 2;
        else m = cell[(size_t)i * (lb + 1) + j] & 3;
        if (m == 0) {
            rev.push_back(0); i--; j--; state = 0;
        } else if (m == 1) {
            rev.push_back(1);
            state = (cell[(size_t)i * (lb + 1) + j] & 4) ? 1 : 0;
            i--;
        } else {
            rev.push_back(2);
            state = (i > 0 && j > 0 &&
                     (cell[(size_t)i * (lb + 1) + j] & 8)) ? 2 : 0;
            j--;
        }
    }
    n = (int64_t)rev.size();
    for (int64_t x = 0; x < n; x++) ops[x] = rev[n - 1 - x];
    return n;
}

// Sequence-vs-center Gotoh for the center-star MSA
// (align/centerstar.align_ops_batch): int32 scores MATCH=2/MISMATCH=-1,
// GAP_OPEN=-4/GAP_EXT=-1, identical tie rules and prefix-max E recurrence
// to the NumPy row loop, so op strings are bit-identical.  Writes forward
// op codes (0=M, 1=D, 2=I, 3=pad at the end) into out[mi*out_stride..].
static void gotoh_seq_one(const int8_t* a, int64_t la, const int8_t* b,
                          int64_t lb, uint8_t* cell, int32_t* v_prev,
                          int32_t* f_prev, int32_t* t_arr, int32_t* pre_e,
                          int32_t* p01a, int32_t* fca, int32_t* ipm,
                          uint8_t* out, int64_t out_stride) {
    const int32_t MATCH = 2, MISMATCH = -1, GO = -4, GE = -1;
    const int32_t NEG = -(1 << 28);
    if (la == 0) {
        int64_t j = 0;
        for (; j < lb; j++) out[j] = 2;
        for (; j < out_stride; j++) out[j] = 3;
        return;
    }
    if (lb == 0) {
        int64_t i = 0;
        for (; i < la; i++) out[i] = 1;
        for (; i < out_stride; i++) out[i] = 3;
        return;
    }
    // row 0: all-left with extensions from j >= 2
    cell[0] = 0;
    for (int64_t j = 1; j <= lb; j++) cell[j] = (uint8_t)(2 | (j >= 2 ? 8 : 0));
    v_prev[0] = 0;
    for (int64_t j = 1; j <= lb; j++) v_prev[j] = GO + GE * (int32_t)j;
    for (int64_t j = 0; j <= lb; j++) f_prev[j] = NEG;
    for (int64_t i = 1; i <= la; i++) {
        const int8_t ai = a[i - 1];
        const bool acgt = ai >= 0 && ai < 4;
        uint8_t* ci = cell + (size_t)i * (lb + 1);
        // j = 0
        const int32_t v0_old = v_prev[0];      // old v[i-1][0] for j=1's diag
        {
            const int32_t ext = f_prev[0] + GE;
            const int32_t opn = v0_old + GO + GE;
            const bool fc = ext >= opn;
            const int32_t f0 = fc ? ext : opn;
            f_prev[0] = f0;
            // v_prev[0] = f0 is deferred until after pass A (the j=1 lane's
            // diagonal still reads the OLD v_prev[0])
            ci[0] = (uint8_t)(1 | (fc ? 4 : 0));
            t_arr[0] = f0 + GO;                // run init (vert[0] = f0)
        }
#if defined(__AVX2__)
        // The row splits into three passes so the only loop-carried
        // dependency (E's running max over t) is isolated into a cheap
        // scalar scan; passes A and B are 8-lane int32 vectors with the
        // scalar code's exact compare/tie semantics.
        {
            const __m256i vge = _mm256_set1_epi32(GE);
            const __m256i vgoge = _mm256_set1_epi32(GO + GE);
            const __m256i vgo = _mm256_set1_epi32(GO);
            const __m256i vmatch = _mm256_set1_epi32(MATCH);
            const __m256i vmis = _mm256_set1_epi32(MISMATCH);
            // a non-ACGT row code never matches (codes are >= 0)
            const __m256i vai = _mm256_set1_epi32(acgt ? (int32_t)ai : -1);
            const __m256i v8i = _mm256_set1_epi32(8);
            __m256i vj = _mm256_setr_epi32(1, 2, 3, 4, 5, 6, 7, 8);
            for (int64_t j = 1; j <= lb; j += 8) {   // pass A
                const __m256i old_v =
                    _mm256_loadu_si256((const __m256i*)&v_prev[j]);
                const __m256i fp =
                    _mm256_loadu_si256((const __m256i*)&f_prev[j]);
                const __m256i ext = _mm256_add_epi32(fp, vge);
                const __m256i opn = _mm256_add_epi32(old_v, vgoge);
                const __m256i opn_gt = _mm256_cmpgt_epi32(opn, ext);
                const __m256i f_cur = _mm256_max_epi32(ext, opn);
                _mm256_storeu_si256((__m256i*)&f_prev[j], f_cur);
                // fc = ext >= opn = !(opn > ext); stored as the bit-2 value
                _mm256_storeu_si256(
                    (__m256i*)&fca[j],
                    _mm256_andnot_si256(opn_gt, _mm256_set1_epi32(4)));
                const __m256i bj = _mm256_cvtepi8_epi32(
                    _mm_loadl_epi64((const __m128i*)&b[j - 1]));
                const __m256i eq = _mm256_cmpeq_epi32(bj, vai);
                const __m256i sub = _mm256_blendv_epi8(vmis, vmatch, eq);
                const __m256i diag = _mm256_add_epi32(
                    _mm256_loadu_si256((const __m256i*)&v_prev[j - 1]), sub);
                // p01 = diag >= f_cur ? 0 : 1
                const __m256i p01 = _mm256_and_si256(
                    _mm256_cmpgt_epi32(f_cur, diag), _mm256_set1_epi32(1));
                _mm256_storeu_si256((__m256i*)&p01a[j], p01);
                const __m256i pe = _mm256_max_epi32(diag, f_cur);
                _mm256_storeu_si256((__m256i*)&pre_e[j], pe);
                const __m256i t = _mm256_sub_epi32(
                    _mm256_add_epi32(pe, vgo), _mm256_mullo_epi32(vge, vj));
                _mm256_storeu_si256((__m256i*)&t_arr[j], t);
                vj = _mm256_add_epi32(vj, v8i);
            }
            int32_t rmax = t_arr[0];            // inclusive prefix max of t
            ipm[0] = rmax;
            for (int64_t k = 1; k <= lb; k++) {
                if (t_arr[k] > rmax) rmax = t_arr[k];
                ipm[k] = rmax;
            }
            vj = _mm256_setr_epi32(1, 2, 3, 4, 5, 6, 7, 8);
            for (int64_t j = 1; j <= lb; j += 8) {   // pass B
                const __m256i run =
                    _mm256_loadu_si256((const __m256i*)&ipm[j - 1]);
                const __m256i tp =
                    _mm256_loadu_si256((const __m256i*)&t_arr[j - 1]);
                const __m256i e = _mm256_add_epi32(
                    run, _mm256_mullo_epi32(vge, vj));
                const __m256i pe =
                    _mm256_loadu_si256((const __m256i*)&pre_e[j]);
                const __m256i sel2 = _mm256_cmpgt_epi32(e, pe);
                _mm256_storeu_si256((__m256i*)&v_prev[j],
                                    _mm256_max_epi32(pe, e));
                const __m256i p = _mm256_blendv_epi8(
                    _mm256_loadu_si256((const __m256i*)&p01a[j]),
                    _mm256_set1_epi32(2), sel2);
                // bit8 = t_prev < run
                const __m256i bit8 = _mm256_and_si256(
                    _mm256_cmpgt_epi32(run, tp), _mm256_set1_epi32(8));
                const __m256i byte32 = _mm256_or_si256(
                    p, _mm256_or_si256(
                        _mm256_loadu_si256((const __m256i*)&fca[j]), bit8));
                const __m256i v16 = _mm256_packs_epi32(byte32, byte32);
                const __m256i v8 = _mm256_packs_epi16(v16, v16);
                const uint32_t lo = (uint32_t)_mm256_extract_epi32(v8, 0);
                const uint32_t hi = (uint32_t)_mm256_extract_epi32(v8, 4);
                memcpy(ci + j, &lo, 4);
                memcpy(ci + j + 4, &hi, 4);
                vj = _mm256_add_epi32(vj, v8i);
            }
            v_prev[0] = f_prev[0];             // vert[0] = f_cur[0]; E = NEG
        }
#else
        {
            // original single-pass scalar row (scratch arrays unused)
            (void)t_arr; (void)pre_e; (void)p01a; (void)fca; (void)ipm;
            v_prev[0] = f_prev[0];             // vert[0] = f_cur[0]; E = NEG
            int32_t vp_diag = v0_old;
            int32_t run = v_prev[0] + GO;      // t[0]
            int32_t t_prev = run;
            for (int64_t j = 1; j <= lb; j++) {
                const int32_t old_vj = v_prev[j];
                const int32_t ext = f_prev[j] + GE;
                const int32_t opn = old_vj + GO + GE;
                const bool fc = ext >= opn;
                const int32_t f_cur = fc ? ext : opn;
                const int32_t sub =
                    (b[j - 1] == ai && acgt) ? MATCH : MISMATCH;
                const int32_t diag = vp_diag + sub;
                int32_t vert;
                uint8_t p;
                if (diag >= f_cur) { vert = diag; p = 0; }
                else { vert = f_cur; p = 1; }
                const int32_t t_j = vert + GO - GE * (int32_t)j;
                const int32_t e = run + GE * (int32_t)j;
                uint8_t flags =
                    (uint8_t)((fc ? 4 : 0) | (t_prev < run ? 8 : 0));
                if (e > vert) { vert = e; p = 2; }
                ci[j] = (uint8_t)(p | flags);
                v_prev[j] = vert;
                f_prev[j] = f_cur;
                vp_diag = old_vj;
                if (t_j > run) run = t_j;
                t_prev = t_j;
            }
        }
#endif
    }
    // traceback — the exact NumPy state machine
    int64_t i = la, j = lb, state = 0, n = 0;
    uint8_t* rev = out;                        // reuse out as scratch: write
    while (i > 0 || j > 0) {                   // reversed ops first ...
        int m;
        if (i == 0) m = 2;
        else if (j == 0) m = 1;
        else if (state == 1) m = 1;
        else if (state == 2) m = 2;
        else m = cell[(size_t)i * (lb + 1) + j] & 3;
        if (m == 0) {
            rev[n++] = 0; i--; j--; state = 0;
        } else if (m == 1) {
            rev[n++] = 1;
            state = (cell[(size_t)i * (lb + 1) + j] & 4) ? 1 : 0;
            i--;
        } else {
            rev[n++] = 2;
            state = (i > 0 && j > 0 &&
                     (cell[(size_t)i * (lb + 1) + j] & 8)) ? 2 : 0;
            j--;
        }
    }
    for (int64_t x = 0; x < n / 2; x++)        // ... then reverse in place
        std::swap(rev[x], rev[n - 1 - x]);
    for (int64_t x = n; x < out_stride; x++) out[x] = 3;
}

void gotoh_ops_batch(const int8_t* c, int64_t la, const int8_t* members,
                     const int64_t* offs, int64_t m, uint8_t* out,
                     int64_t out_stride, int64_t nthreads) {
    int64_t lb_max = 1;
    for (int64_t mi = 0; mi < m; mi++)
        lb_max = std::max(lb_max, offs[mi + 1] - offs[mi]);
    const int64_t nt = std::max<int64_t>(
        1, std::min(nthreads, m));
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        // +8 slack everywhere: the AVX2 row passes run full 8-lane chunks
        // past lb (the overrun lands in slack or is overwritten by the
        // next row before any read)
        std::vector<uint8_t> cell((size_t)(la + 1) * (lb_max + 1) + 8);
        std::vector<int32_t> v(lb_max + 9), f(lb_max + 9);
        std::vector<int32_t> t(lb_max + 9), pe(lb_max + 9), p01(lb_max + 9),
            fc(lb_max + 9), ipm(lb_max + 9);
        for (;;) {
            const int64_t mi = next.fetch_add(1);
            if (mi >= m) return;
            gotoh_seq_one(c, la, members + offs[mi],
                          offs[mi + 1] - offs[mi], cell.data(), v.data(),
                          f.data(), t.data(), pe.data(), p01.data(),
                          fc.data(), ipm.data(),
                          out + (size_t)mi * out_stride, out_stride);
        }
    };
    if (nt <= 1) { work(); return; }
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < nt; t++) pool.emplace_back(work);
    for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Degenerate 3'-end dimer screen (multiPrime-core.py:487-503 string phase).
//
// Enumerates the reference's candidate (end, d2) pairs for the self-dimer
// check of one degenerate primer, in the exact nested order the Python
// engine evaluates them: suffix lengths 18 down to 5 (each suffix expanded
// in multiPrime's member order, appended in product order), and for each
// end the first occurrence of RC(end) inside every expansion of the full
// primer.  The float Loss/dG verdicts stay in (memoised) Python — this
// returns only the few surviving string candidates, so bit-parity of the
// decision is untouched.

static const char* kMembers(char c) {
    // multiPrime-core.py:105-107 member order
    switch (c) {
        case 'A': return "A"; case 'G': return "G"; case 'C': return "C";
        case 'T': return "T";
        case 'R': return "AG"; case 'Y': return "CT"; case 'M': return "AC";
        case 'K': return "GT"; case 'S': return "GC"; case 'W': return "AT";
        case 'H': return "ATC"; case 'B': return "GTC"; case 'V': return "GAC";
        case 'D': return "GAT"; case 'N': return "ATGC";
        default: return nullptr;  // gap / unknown: caller falls back
    }
}

static int kMask(char c) {
    const char* m = kMembers(c);
    if (!m) return 0;
    int out = 0;
    for (; *m; m++)
        out |= (*m == 'A') ? 1 : (*m == 'C') ? 2 : (*m == 'G') ? 4 : 8;
    return out;
}

// product expansion in itertools.product order (rightmost varies fastest);
// returns false if any char is unknown or the count exceeds cap
static bool expandAll(const char* s, int64_t len,
                      std::vector<std::string>* out, int64_t cap) {
    std::vector<const char*> lists(len);
    int64_t total = 1;
    for (int64_t i = 0; i < len; i++) {
        lists[i] = kMembers(s[i]);
        if (!lists[i]) return false;
        total *= (int64_t)strlen(lists[i]);
        if (total > cap) return false;
    }
    std::string cur(len, 'A');
    std::vector<int> idx(len, 0);
    for (int64_t i = 0; i < len; i++) cur[i] = lists[i][0];
    for (;;) {
        out->push_back(cur);
        int64_t i = len - 1;
        for (; i >= 0; i--) {
            idx[i]++;
            if (lists[i][idx[i]] != '\0') { cur[i] = lists[i][idx[i]]; break; }
            idx[i] = 0;
            cur[i] = lists[i][0];
        }
        if (i < 0) return true;
    }
}

extern "C" {

// Candidates for dimer_check(primer): out triples (end_offset_in_buf,
// end_len, d2) in evaluation order; end strings concatenated into ends_buf.
// Returns the candidate count, or -1 when the caller must fall back to the
// Python path (unknown code, expansion blowup, or buffer overflow).
int64_t dimer_screen(const char* primer, int64_t plen, int64_t num_min,
                     int64_t num_max, char* ends_buf, int64_t ends_cap,
                     int64_t* out, int64_t max_out) {
    if (plen <= 0 || plen > 63) return -1;
    std::vector<std::string> expansions;
    if (!expandAll(primer, plen, &expansions, 4096)) return -1;
    uint64_t occ[4] = {0, 0, 0, 0};
    for (int64_t i = 0; i < plen; i++) {
        const int m = kMask(primer[i]);
        if (!m) return -1;
        if (m & 1) occ[0] |= 1ull << i;
        if (m & 2) occ[1] |= 1ull << i;
        if (m & 4) occ[2] |= 1ull << i;
        if (m & 8) occ[3] |= 1ull << i;
    }
    std::vector<std::string> ends;
    int64_t n_out = 0, buf_used = 0;
    // sorted(key=len, reverse=True) over the i=num_min..num_max suffixes is
    // a stable longest-first walk; ext[-i:] clamps to the whole primer
    for (int64_t i = num_max; i >= num_min; i--) {
        const int64_t elen = std::min(i, plen);
        const char* suffix = primer + (plen - elen);
        ends.clear();
        if (!expandAll(suffix, elen, &ends, 4096)) return -1;
        for (const std::string& end : ends) {
            std::string rce(elen, 'A');
            for (int64_t k = 0; k < elen; k++) {
                const char c = end[elen - 1 - k];
                rce[k] = (c == 'A') ? 'T' : (c == 'T') ? 'A'
                         : (c == 'G') ? 'C' : 'G';
            }
            if (elen > plen) continue;
            uint64_t ok = (plen - elen + 1 >= 64)
                ? ~0ull : ((1ull << (plen - elen + 1)) - 1);
            for (int64_t j = 0; j < elen && ok; j++) {
                const char c = rce[j];
                const int b = (c == 'A') ? 0 : (c == 'C') ? 1
                              : (c == 'G') ? 2 : 3;
                ok &= occ[b] >> j;
            }
            if (!ok) continue;
            for (const std::string& p : expansions) {
                const size_t idx = p.find(rce);
                if (idx == std::string::npos) continue;
                if (n_out >= max_out || buf_used + elen > ends_cap)
                    return -1;
                memcpy(ends_buf + buf_used, end.data(), (size_t)elen);
                out[3 * n_out] = buf_used;
                out[3 * n_out + 1] = elen;
                out[3 * n_out + 2] = plen - elen - (int64_t)idx;
                buf_used += elen;
                n_out++;
            }
        }
    }
    return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Bit-parallel string filters (multiPrime-core.py:196-207, 387-398 and
// get_multiPrime.py:360-386): di/tri-nucleotide run detection and the
// hairpin scans over degenerate primers.  Exact ports of the Python
// occurrence-plane walks in models/mcdpd.py / models/pairing.py — the
// IUPAC expansion is a full cartesian product, so "some expansion contains
// some expansion of the probe" is "every overlap position's masks
// intersect", evaluated as shift/AND over per-base occurrence bitsets.

extern "C" {

// 1 if the primer contains an XXXX / XYXYXYXY / XYZXYZXYZ run in some
// expansion, else 0; -1 when the caller must use the Python fallback
// (non-IUPAC character or length > 63).
int64_t di_nucleotide_flag(const char* primer, int64_t plen) {
    if (plen <= 0 || plen > 63) return -1;
    uint64_t occ[4] = {0, 0, 0, 0};
    for (int64_t i = 0; i < plen; i++) {
        const int m = kMask(primer[i]);
        if (!m) return -1;
        if (m & 1) occ[0] |= 1ull << i;
        if (m & 2) occ[1] |= 1ull << i;
        if (m & 4) occ[2] |= 1ull << i;
        if (m & 8) occ[3] |= 1ull << i;
    }
    const char bases[4] = {'A', 'C', 'G', 'T'};
    auto scan = [&](const char* pat, int lp) -> bool {
        if (lp > plen) return false;
        uint64_t ok = (plen - lp + 1 >= 64)
            ? ~0ull : ((1ull << (plen - lp + 1)) - 1);
        for (int j = 0; j < lp && ok; j++) {
            const char c = pat[j];
            const int b = (c == 'A') ? 0 : (c == 'C') ? 1
                          : (c == 'G') ? 2 : 3;
            ok &= occ[b] >> j;
        }
        return ok != 0;
    };
    char pat[10];
    // XXXX runs
    for (int i = 0; i < 4; i++) {
        pat[0] = pat[1] = pat[2] = pat[3] = bases[i];
        if (scan(pat, 4)) return 1;
    }
    // XYXYXYXY (i != j)
    for (int i = 0; i < 4; i++) {
        for (int j = 0; j < 4; j++) {
            if (i == j) continue;
            for (int k = 0; k < 4; k++) {
                pat[2 * k] = bases[i];
                pat[2 * k + 1] = bases[j];
            }
            if (scan(pat, 8)) return 1;
        }
    }
    // XYZXYZXYZ (i != j, j != k; i == k allowed, matching the reference)
    for (int i = 0; i < 4; i++) {
        for (int j = 0; j < 4; j++) {
            if (i == j) continue;
            for (int k = 0; k < 4; k++) {
                if (j == k) continue;
                for (int r = 0; r < 3; r++) {
                    pat[3 * r] = bases[i];
                    pat[3 * r + 1] = bases[j];
                    pat[3 * r + 2] = bases[k];
                }
                if (scan(pat, 9)) return 1;
            }
        }
    }
    return 0;
}

// Hairpin scan.  strong mode (first_members == NULL): every 5-mer mask vs
// the downstream tail (core.py:387-398).  weak mode: only the FIRST
// expansion of each 5' 5-mer is probed (get_multiPrime.py:360-386);
// first_members carries the caller-computed first member base of each
// position's code, so the member-order contract stays in Python.
// Returns 1/0, or -1 for fallback.
int64_t hairpin_flag(const char* primer, int64_t plen, int64_t d,
                     const char* first_members) {
    if (plen <= 0 || plen > 63) return -1;
    if (plen < 10 + d) return 0;
    uint64_t occ[4] = {0, 0, 0, 0};
    int masks[64];
    for (int64_t i = 0; i < plen; i++) {
        const int m = kMask(primer[i]);
        if (!m) return -1;
        masks[i] = m;
        if (m & 1) occ[0] |= 1ull << i;
        if (m & 2) occ[1] |= 1ull << i;
        if (m & 4) occ[2] |= 1ull << i;
        if (m & 8) occ[3] |= 1ull << i;
    }
    // union plane for a 4-bit mask
    auto occOf = [&](int m) -> uint64_t {
        uint64_t v = 0;
        if (m & 1) v |= occ[0];
        if (m & 2) v |= occ[1];
        if (m & 4) v |= occ[2];
        if (m & 8) v |= occ[3];
        return v;
    };
    // 4-bit complement: A<->T (1<->8), C<->G (2<->4) == nibble bit-reverse
    auto comp4 = [](int m) -> int {
        return ((m & 1) ? 8 : 0) | ((m & 2) ? 4 : 0)
             | ((m & 4) ? 2 : 0) | ((m & 8) ? 1 : 0);
    };
    for (int64_t n = 0; n + 10 + d <= plen; n++) {
        const int64_t lo = n + 5 + d;
        const int64_t span = plen - 5 - lo + 1;
        if (span <= 0) continue;
        uint64_t ok = ((span >= 64) ? ~0ull : ((1ull << span) - 1)) << lo;
        for (int j = 0; j < 5 && ok; j++) {
            int m;
            if (first_members) {
                const char c = first_members[n + 4 - j];
                const char rc = (c == 'A') ? 'T' : (c == 'T') ? 'A'
                                : (c == 'G') ? 'C' : 'G';
                m = kMask(rc);
            } else {
                m = comp4(masks[n + 4 - j]);
            }
            ok &= occOf(m) >> j;
        }
        if (ok) return 1;
    }
    return 0;
}

int64_t tm_batch(const char* seqs, int64_t k, int64_t len, double* out);

// Batched pairing gates for PURE-ACGT rows of an [n, plen] byte matrix
// (PairingEngine's prefilter + f_ok/r_ok loops): per row flags bit0 =
// di/tri-nucleotide run, bit1 = hairpin (strong == weak for pure rows:
// the single expansion IS the mask), bit2 = gc_clamp.  The gc_clamp
// verdict compares integer tail GC counts against gc_min_counts[k]
// (k = clamped suffix length), precomputed in Python so the
// round(g/k, 3) > 0.6 semantics stay on the Python side.  gc_out gets
// the full-row GC count (the prefilter's GC-mean bound).  Returns 0 or
// -1 for fallback (non-pure char, plen > 63).
int64_t pure_gate_batch(const char* rows, int64_t n, int64_t plen,
                        int64_t distance, int64_t num_min, int64_t num_max,
                        const int64_t* gc_min_counts, int64_t want,
                        int8_t* flags, int64_t* gc_out) {
    if (plen <= 0 || plen > 63) return -1;
    for (int64_t r = 0; r < n; r++) {
        const char* s = rows + r * plen;
        int64_t gc = 0;
        for (int64_t i = 0; i < plen; i++) {
            const char c = s[i];
            if (c == 'G' || c == 'C') gc++;
            else if (c != 'A' && c != 'T') return -1;
        }
        gc_out[r] = gc;
        int8_t f = 0;
        if ((want & 1) && di_nucleotide_flag(s, plen) > 0) f |= 1;
        if ((want & 2) && hairpin_flag(s, plen, distance, nullptr) > 0)
            f |= 2;
        // gc_clamp: tail GC counts vs the per-k minimal passing count
        if ((want & 4) && gc_min_counts) {
            int64_t acc = 0;
            int64_t tail[64];
            const int64_t top = std::min(plen, num_max);
            for (int64_t j = 1; j <= top; j++) {
                const char c = s[plen - j];
                if (c == 'G' || c == 'C') acc++;
                tail[j] = acc;
            }
            for (int64_t i = num_min; i <= num_max; i++) {
                const int64_t k = std::min(i, plen);
                if (tail[k] >= gc_min_counts[k]) { f |= 4; break; }
            }
        }
        flags[r] = f;
    }
    return 0;
}

// Batched per-window filters for PURE-ACGT rows of an [n, plen] byte
// matrix — the design engine's uniform-pure fast path pays four ctypes
// round trips per window (di_nucleotide_flag, hairpin_flag, dimer_screen,
// tm_batch); this folds a whole window block into one call.  Per row:
// flags bit0 = di/tri-nucleotide run, bit1 = strong hairpin; exact
// Calc_Tm_v2; GC count; and dimer_screen's candidate (end, d2) stream with
// per-row counts (offsets into the shared ends_buf) so the float Loss/dG
// verdicts stay in Python exactly as in the per-primer path.  Returns the
// total candidate count, or -1 for fallback (non-pure char, plen > 63,
// buffer overflow, Tm tables uninitialised).
int64_t pure_window_filters(const char* rows, int64_t n, int64_t plen,
                            int64_t distance, int64_t num_min,
                            int64_t num_max,
                            int8_t* flags, double* tm_out, int64_t* gc_out,
                            int64_t* cand_counts,
                            char* ends_buf, int64_t ends_cap,
                            int64_t* cand_out, int64_t max_out) {
    if (plen <= 1 || plen > 63) return -1;
    int64_t total = 0, buf_used = 0;
    for (int64_t r = 0; r < n; r++) {
        const char* s = rows + r * plen;
        int64_t gc = 0;
        for (int64_t i = 0; i < plen; i++) {
            const char c = s[i];
            if (c == 'G' || c == 'C') gc++;
            else if (c != 'A' && c != 'T') return -1;
        }
        gc_out[r] = gc;
        int8_t f = 0;
        if (di_nucleotide_flag(s, plen) > 0) f |= 1;
        if (hairpin_flag(s, plen, distance, nullptr) > 0) f |= 2;
        flags[r] = f;
        const int64_t cnt = dimer_screen(
            s, plen, num_min, num_max, ends_buf + buf_used,
            ends_cap - buf_used, cand_out + 3 * total, max_out - total);
        if (cnt < 0) return -1;
        int64_t used = 0;
        if (cnt > 0)
            used = cand_out[3 * (total + cnt - 1)]
                 + cand_out[3 * (total + cnt - 1) + 1];
        for (int64_t k2 = 0; k2 < cnt; k2++)
            cand_out[3 * (total + k2)] += buf_used;   // global offsets
        buf_used += used;
        cand_counts[r] = cnt;
        total += cnt;
        if (tm_batch(s, 1, plen, tm_out + r) < 0) return -1;
    }
    return total;
}

// defined with the pairing dimer kernels below; default both_ends = 0
static bool dg_end_accept(const char* e, int64_t ln, const double* step,
                          const double* init_tab, double terminal_ta,
                          double symmetry, const double* salt_tab,
                          int both_ends);

// pure_window_filters with the self-dimer verdict resolved natively: the
// Loss >= 3 gate comes as a Python-precomputed uint8 (len, gc, d2) table
// (exact: the floats never leave Python) and the dG < -5, d2 == 0 branch
// uses the shared dg_end_accept with both_ends semantics
// (thermo.delta_g(end, both_ends=True), models/mcdpd.dimer_check).
// flags bit 3 = window rejected by the dimer gate.  No candidate streams
// cross the boundary at all.
int64_t pure_window_filters2(const char* rows, int64_t n, int64_t plen,
                             int64_t distance, int64_t num_min,
                             int64_t num_max,
                             const uint8_t* loss_trig, int64_t l1,
                             const double* step_tab, const double* init_tab,
                             double terminal_ta, double symmetry,
                             const double* salt_tab,
                             int8_t* flags, double* tm_out,
                             int64_t* gc_out) {
    if (plen <= 1 || plen > 63 || plen >= l1) return -1;
    char ends_buf[8192];
    int64_t cand_out[3 * 256];
    for (int64_t r = 0; r < n; r++) {
        const char* s = rows + r * plen;
        int64_t gc = 0;
        for (int64_t i = 0; i < plen; i++) {
            const char c = s[i];
            if (c == 'G' || c == 'C') gc++;
            else if (c != 'A' && c != 'T') return -1;
        }
        gc_out[r] = gc;
        int8_t f = 0;
        if (di_nucleotide_flag(s, plen) > 0) f |= 1;
        if (hairpin_flag(s, plen, distance, nullptr) > 0) f |= 2;
        const int64_t cnt = dimer_screen(s, plen, num_min, num_max,
                                         ends_buf, sizeof ends_buf,
                                         cand_out, 256);
        if (cnt < 0) return -1;
        for (int64_t k = 0; k < cnt; k++) {
            const char* e = ends_buf + cand_out[3 * k];
            const int64_t ln = cand_out[3 * k + 1];
            const int64_t d2 = cand_out[3 * k + 2];
            if (ln >= l1 || d2 >= l1) return -1;
            int64_t gce = 0;
            for (int64_t i = 0; i < ln; i++)
                if (e[i] == 'G' || e[i] == 'C') gce++;
            if (loss_trig[(ln * l1 + gce) * l1 + d2]
                || (d2 == 0 && dg_end_accept(e, ln, step_tab, init_tab,
                                             terminal_ta, symmetry,
                                             salt_tab, 1))) {
                f |= 8;
                break;
            }
        }
        flags[r] = f;
        if (tm_batch(s, 1, plen, tm_out + r) < 0) return -1;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Consensus Viterbi (multiPrime-core.py:579-593): max-sum DP over the
// [4, L] frequency nodes and [L-1, 4, 4] NN transition counts, ties to the
// lowest base index like np.argmax.  Exact int64 arithmetic, identical to
// the Python loop in models/mcdpd.py::_viterbi.

extern "C" {

// freq: int64 [4*L] (base-major, freq[b*L + t]); nn: int64 [(L-1)*16]
// (nn[(t)*16 + a*4 + b]); path_out: int64 [L].
void viterbi_path(const int64_t* freq, const int64_t* nn, int64_t L,
                  int64_t* path_out) {
    if (L <= 0) return;
    int64_t scores[4], nscores[4];
    // backpointers: 2 bits per state, one byte each for simplicity
    static thread_local std::vector<uint8_t> bp;
    bp.resize((size_t)(L > 1 ? (L - 1) * 4 : 0));
    for (int j = 0; j < 4; j++) scores[j] = freq[j * L];
    for (int64_t t = 1; t < L; t++) {
        const int64_t* tr = nn + (t - 1) * 16;
        for (int j = 0; j < 4; j++) {
            int64_t best = scores[0] + tr[0 * 4 + j];
            int bi = 0;
            for (int a = 1; a < 4; a++) {
                const int64_t v = scores[a] + tr[a * 4 + j];
                if (v > best) { best = v; bi = a; }
            }
            nscores[j] = best + freq[j * L + t];
            bp[(size_t)(t - 1) * 4 + j] = (uint8_t)bi;
        }
        for (int j = 0; j < 4; j++) scores[j] = nscores[j];
    }
    int bi = 0;
    int64_t best = scores[0];
    for (int j = 1; j < 4; j++) {
        if (scores[j] > best) { best = scores[j]; bi = j; }
    }
    path_out[L - 1] = bi;
    for (int64_t t = L - 1; t > 0; t--) {
        path_out[t - 1] = bp[(size_t)(t - 1) * 4 + path_out[t]];
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact Calc_Tm_v2 (multiPrime-core.py:282-336 via thermo/exact.py): plain
// IEEE-double transliteration with the identical operation order, including
// the buggy constant magnesium correction.  round(x, 2) is reproduced with
// glibc's correctly-rounded "%.2f" + strtod (round-half-even decimal
// conversion, same as CPython's _Py_dg_dtoa; fuzz-verified over 2M samples
// in tests/test_native_thermo.py).  All table values are passed in from the
// Python tables at init so the two sides can never drift.

extern "C" {

static double TM_DH[5][5];
static double TM_DS[5][5];
static double TM_DH_INIT[256];
static double TM_DS_INIT[256];
static double TM_DS_SYMMETRY = 0.0;
static double TM_MG_CORR = 0.0;
static double TM_CONC = 0.0;
static double TM_KELVIN = 0.0;
static int TM_BIT[256];
static uint8_t TM_COMP[256];

void tm_init(const double* dh, const double* ds,
             const char* bit_chars, const int64_t* bit_vals, int64_t nbit,
             const char* init_chars, const double* dh_init,
             const double* ds_init, int64_t ninit,
             double ds_symmetry, double mg_corr, double conc, double kelvin) {
    for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++) {
            TM_DH[i][j] = dh[i * 5 + j];
            TM_DS[i][j] = ds[i * 5 + j];
        }
    for (int i = 0; i < 256; i++) TM_BIT[i] = -1;
    for (int64_t i = 0; i < nbit; i++)
        TM_BIT[(uint8_t)bit_chars[i]] = (int)bit_vals[i];
    for (int i = 0; i < 256; i++) { TM_DH_INIT[i] = 0; TM_DS_INIT[i] = 0; }
    for (int64_t i = 0; i < ninit; i++) {
        TM_DH_INIT[(uint8_t)init_chars[i]] = dh_init[i];
        TM_DS_INIT[(uint8_t)init_chars[i]] = ds_init[i];
    }
    for (int i = 0; i < 256; i++) TM_COMP[i] = 0;
    TM_COMP[(uint8_t)'A'] = 'T'; TM_COMP[(uint8_t)'T'] = 'A';
    TM_COMP[(uint8_t)'C'] = 'G'; TM_COMP[(uint8_t)'G'] = 'C';
    TM_DS_SYMMETRY = ds_symmetry;
    TM_MG_CORR = mg_corr;
    TM_CONC = conc;
    TM_KELVIN = kelvin;
}

static inline double round2_exact(double x) {
    char buf[64];
    snprintf(buf, sizeof buf, "%.2f", x);
    return strtod(buf, NULL);
}

// The reference's "symmetry": first half == ELEMENTWISE complement of the
// second half (its RC helper also reverses, cancelling the slice reversal).
static inline int tm_symmetric(const char* s, int64_t n) {
    if (n % 2) return 0;
    const int64_t half = n / 2;
    for (int64_t i = 0; i < half; i++)
        if ((uint8_t)s[i] != TM_COMP[(uint8_t)s[half + i]]) return 0;
    return 1;
}

// seqs: k pure-ACGT strings of identical length, concatenated.  Returns 0,
// or -1 if any char is outside the NN table (caller falls back to Python).
int64_t tm_batch(const char* seqs, int64_t k, int64_t len, double* out) {
    if (len < 2) return -1;
    for (int64_t q = 0; q < k; q++) {
        const char* s = seqs + q * len;
        double dh = 0.0, ds = 0.0;
        for (int64_t n = 0; n < len - 1; n++) {
            const int i = TM_BIT[(uint8_t)s[n + 1]];
            const int j = TM_BIT[(uint8_t)s[n]];
            if (i < 0 || j < 0 || i > 4 || j > 4) return -1;
            dh += TM_DH[i][j];
            ds += TM_DS[i][j];
        }
        // Python adds the two init terms together first, then accumulates.
        dh += TM_DH_INIT[(uint8_t)s[0]] + TM_DH_INIT[(uint8_t)s[len - 1]];
        ds += TM_DS_INIT[(uint8_t)s[0]] + TM_DS_INIT[(uint8_t)s[len - 1]];
        const int sym = tm_symmetric(s, len);
        if (sym) ds += TM_DS_SYMMETRY;
        dh = dh * 1000;
        // math.log(x, math.e) == log(x)/log(e); log(double-e) rounds to
        // exactly 1.0, so plain log() is bit-identical (asserted Python-side)
        const double denom = sym ? (1 * pow(10, 9)) : (4 * pow(10, 9));
        const double t =
            1 / ((1 / (dh / (ds + 1.9872 * log(TM_CONC / denom))))
                 + TM_MG_CORR) - TM_KELVIN;
        out[q] = round2_exact(t);
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// v15/v16 greedy NN refinement loop (multiPrime-core_V15.py:964-986 /
// refine_by_NN_array core.py:922-1089), transliterated from
// models/mcdpd.py::_coverage_stats/_refine_step with identical candidate
// order (the tabulated np.argsort descending tie order is passed in) and
// identical integer bookkeeping.  v20 is NOT handled here: its loop
// interleaves the mismatch check whose output dict order depends on live
// CPython set layout.

namespace refine_detail {

struct KeyMap {
    // open-addressing FNV-1a map from plen-byte keys to counts
    std::vector<uint32_t> slot;   // index+1 into keys, 0 = empty
    const uint8_t* keys = nullptr;
    const int64_t* counts = nullptr;
    int64_t plen = 0;
    uint32_t mask = 0;

    static uint64_t hash(const uint8_t* p, int64_t n) {
        uint64_t h = 1469598103934665603ull;
        for (int64_t i = 0; i < n; i++) {
            h ^= p[i];
            h *= 1099511628211ull;
        }
        return h;
    }

    void build(const uint8_t* k, const int64_t* c, int64_t K, int64_t pl) {
        keys = k; counts = c; plen = pl;
        uint32_t cap = 8;
        while (cap < (uint32_t)(K * 2 + 2)) cap <<= 1;
        mask = cap - 1;
        slot.assign(cap, 0);
        for (int64_t i = 0; i < K; i++) {
            uint64_t h = hash(k + i * pl, pl);
            uint32_t j = (uint32_t)h & mask;
            while (slot[j]) j = (j + 1) & mask;
            slot[j] = (uint32_t)i + 1;
        }
    }

    int64_t get(const uint8_t* key) const {
        uint64_t h = hash(key, plen);
        uint32_t j = (uint32_t)h & mask;
        while (slot[j]) {
            const uint8_t* cand = keys + (size_t)(slot[j] - 1) * plen;
            if (memcmp(cand, key, (size_t)plen) == 0)
                return counts[slot[j] - 1];
            j = (j + 1) & mask;
        }
        return 0;
    }
};

}  // namespace refine_detail

extern "C" {

static uint8_t RF_ARGSORT[256][4];   // dense-rank pattern -> np.argsort desc
static uint8_t RF_CHAR2MASK[256];
static uint8_t RF_MASK2CHAR[16];
static const char RF_BASES[4] = {'A', 'C', 'G', 'T'};

void refine_init(const uint8_t* argsort_tab, const uint8_t* char2mask,
                 const uint8_t* mask2char) {
    memcpy(RF_ARGSORT, argsort_tab, 256 * 4);
    memcpy(RF_CHAR2MASK, char2mask, 256);
    memcpy(RF_MASK2CHAR, mask2char, 16);
}

// np.argsort(vals)[::-1] via the tabulated DENSE-rank pattern (the Python
// table keys are sorted(set(vals)).index(v_i): count of DISTINCT smaller
// values, not of smaller elements).
static inline const uint8_t* argsort4_desc(const int64_t v[4]) {
    int key = 0;
    for (int i = 0; i < 4; i++) {
        int r = 0;
        for (int j = 0; j < 4; j++) {
            if (v[j] >= v[i]) continue;
            bool dup = false;
            for (int k = 0; k < j; k++)
                if (v[k] == v[j]) { dup = true; break; }
            if (!dup) r++;
        }
        key = key * 4 + r;
    }
    return RF_ARGSORT[key];
}

// Sum of cover counts over all expansions of `prm` (iupac.expand member
// order is irrelevant for a sum).  Returns -1 on expansion blowup.
static int64_t coverage_of(const uint8_t* prm, int64_t plen,
                           const refine_detail::KeyMap& cover) {
    int64_t total_exp = 1;
    int npos[40];
    uint8_t members[40][4];
    if (plen > 40) return -1;
    for (int64_t i = 0; i < plen; i++) {
        uint8_t m = RF_CHAR2MASK[prm[i]];
        int c = 0;
        if (m == 0) {
            members[i][c++] = prm[i];      // gap stays itself
        } else {
            for (int b = 0; b < 4; b++)
                if (m & (1 << b)) members[i][c++] = RF_MASK2CHAR[1 << b];
        }
        npos[i] = c;
        total_exp *= c;
        if (total_exp > (1 << 20)) return -1;
    }
    uint8_t buf[40];
    int idx[40];
    memset(idx, 0, sizeof(int) * (size_t)plen);
    for (int64_t i = 0; i < plen; i++) buf[i] = members[i][0];
    int64_t sum = 0;
    for (;;) {
        sum += cover.get(buf);
        int64_t p = plen - 1;
        for (; p >= 0; p--) {
            if (++idx[p] < npos[p]) { buf[p] = members[p][idx[p]]; break; }
            idx[p] = 0;
            buf[p] = members[p][0];
        }
        if (p < 0) break;
    }
    return sum;
}

// One refine_by_NN_array move.  cur_* are replaced with the best candidate.
// Returns dege (member-count product) via out params.
static void refine_step(std::vector<uint8_t>& primer,          // plen chars
                        int64_t& coverage,
                        std::vector<int64_t>& nn,              // (plen-1)*16
                        std::vector<int64_t>& nncov,           // plen-1
                        const uint8_t* nn_index,               // (plen-1)*2
                        const refine_detail::KeyMap& cover,
                        int64_t plen, int* fallback,
                        int64_t* out_dege, int64_t* out_ndege) {
    const int64_t L = plen - 1;
    int64_t m = nncov[0];
    for (int64_t i = 1; i < L; i++) if (nncov[i] < m) m = nncov[i];

    // candidate buffers
    std::vector<uint8_t> best_primer;
    std::vector<int64_t> best_nn, best_nncov;
    int64_t best_cov = INT64_MIN;

    std::vector<uint8_t> lst(plen);
    std::vector<int64_t> nn_tmp((size_t)L * 16), nncov_tmp((size_t)L);

    for (int64_t i = 0; i < L; i++) {
        if (nncov[i] != m) continue;
        lst.assign(primer.begin(), primer.end());
        nn_tmp.assign(nn.begin(), nn.end());
        nncov_tmp.assign(nncov.begin(), nncov.end());
        int64_t cov_renew = coverage;
        const int row = nn_index[i * 2];
        const int column = nn_index[i * 2 + 1];
        int64_t* li = nn_tmp.data() + (size_t)i * 16;

        if (i == 0) {
            int pos_rows = 0;
            for (int r = 0; r < 4; r++) pos_rows += (li[r * 4 + column] > 0);
            if (pos_rows > 1) {
                int64_t colv[4];
                for (int j = 0; j < 4; j++) colv[j] = li[j * 4 + column];
                const uint8_t* order = argsort4_desc(colv);
                for (int oi = 0; oi < 4; oi++) {
                    const int idx = order[oi];
                    if (idx == row) continue;
                    const uint8_t merged = RF_MASK2CHAR[
                        RF_CHAR2MASK[lst[i]] | RF_CHAR2MASK[(uint8_t)RF_BASES[idx]]];
                    lst[i] = (uint8_t)RF_BASES[idx];
                    const int64_t add = coverage_of(lst.data(), plen, cover);
                    if (add < 0) { *fallback = 1; return; }
                    cov_renew += add;
                    lst[i] = merged;
                    int64_t* rr = li + row * 4;
                    int64_t* ri = li + idx * 4;
                    for (int j = 0; j < 4; j++) { rr[j] += ri[j]; ri[j] = 0; }
                    nncov_tmp[i] = rr[column];
                    break;
                }
            } else {
                int pos_row = 0;
                for (int j = 0; j < 4; j++) pos_row += (li[row * 4 + j] > 0);
                if (pos_row > 1) {
                    const int nrow = nn_index[(i + 1) * 2];
                    const int ncol = nn_index[(i + 1) * 2 + 1];
                    int64_t* lnext = nn_tmp.data() + (size_t)(i + 1) * 16;
                    int64_t rmin[4];
                    for (int j = 0; j < 4; j++) {
                        const int64_t a = li[row * 4 + j];
                        const int64_t b = lnext[j * 4 + ncol];
                        rmin[j] = a < b ? a : b;
                    }
                    const uint8_t* order = argsort4_desc(rmin);
                    int pos_min = 0;
                    for (int j = 0; j < 4; j++) pos_min += (rmin[j] > 0);
                    if (pos_min > 1) {
                        for (int oi = 0; oi < 4; oi++) {
                            const int idx = order[oi];
                            if (idx == column) continue;
                            const uint8_t merged = RF_MASK2CHAR[
                                RF_CHAR2MASK[lst[i + 1]] |
                                RF_CHAR2MASK[(uint8_t)RF_BASES[idx]]];
                            lst[i + 1] = (uint8_t)RF_BASES[idx];
                            const int64_t add =
                                coverage_of(lst.data(), plen, cover);
                            if (add < 0) { *fallback = 1; return; }
                            cov_renew += add;
                            lst[i + 1] = merged;
                            for (int r = 0; r < 4; r++) {
                                li[r * 4 + column] += li[r * 4 + idx];
                                li[r * 4 + idx] = 0;
                            }
                            int64_t* rn = lnext + nrow * 4;
                            int64_t* rx = lnext + idx * 4;
                            for (int j = 0; j < 4; j++) {
                                rn[j] += rx[j];
                                rx[j] = 0;
                            }
                            nncov_tmp[i] = li[row * 4 + column];
                            nncov_tmp[i + 1] = rn[ncol];
                            break;
                        }
                    }
                }
            }
        } else if (i == L - 1) {
            int64_t rrow[4];
            for (int j = 0; j < 4; j++) rrow[j] = li[row * 4 + j];
            const uint8_t* order = argsort4_desc(rrow);
            int pos = 0;
            for (int j = 0; j < 4; j++) pos += (rrow[j] > 0);
            if (pos > 1) {
                for (int oi = 0; oi < 4; oi++) {
                    const int idx = order[oi];
                    if (idx == column) continue;
                    const uint8_t merged = RF_MASK2CHAR[
                        RF_CHAR2MASK[lst[i + 1]] |
                        RF_CHAR2MASK[(uint8_t)RF_BASES[idx]]];
                    lst[i + 1] = (uint8_t)RF_BASES[idx];
                    const int64_t add = coverage_of(lst.data(), plen, cover);
                    if (add < 0) { *fallback = 1; return; }
                    cov_renew += add;
                    lst[i + 1] = merged;
                    for (int r = 0; r < 4; r++) {
                        li[r * 4 + column] += li[r * 4 + idx];
                        li[r * 4 + idx] = 0;
                    }
                    nncov_tmp[i] = li[row * 4 + column];
                    break;
                }
            }
        } else {
            const int nrow = nn_index[(i + 1) * 2];
            const int ncol = nn_index[(i + 1) * 2 + 1];
            int64_t* lnext = nn_tmp.data() + (size_t)(i + 1) * 16;
            int64_t rmin[4];
            for (int j = 0; j < 4; j++) {
                const int64_t a = li[row * 4 + j];
                const int64_t b = lnext[j * 4 + ncol];
                rmin[j] = a < b ? a : b;
            }
            const uint8_t* order = argsort4_desc(rmin);
            int pos_min = 0;
            for (int j = 0; j < 4; j++) pos_min += (rmin[j] > 0);
            if (pos_min > 1) {
                for (int oi = 0; oi < 4; oi++) {
                    const int idx = order[oi];
                    if (idx == column) continue;
                    const uint8_t merged = RF_MASK2CHAR[
                        RF_CHAR2MASK[lst[i + 1]] |
                        RF_CHAR2MASK[(uint8_t)RF_BASES[idx]]];
                    lst[i + 1] = (uint8_t)RF_BASES[idx];
                    const int64_t add = coverage_of(lst.data(), plen, cover);
                    if (add < 0) { *fallback = 1; return; }
                    cov_renew += add;
                    lst[i + 1] = merged;
                    for (int r = 0; r < 4; r++) {
                        li[r * 4 + column] += li[r * 4 + idx];
                        li[r * 4 + idx] = 0;
                    }
                    int64_t* rn = lnext + nrow * 4;
                    int64_t* rx = lnext + idx * 4;
                    for (int j = 0; j < 4; j++) { rn[j] += rx[j]; rx[j] = 0; }
                    nncov_tmp[i] = li[row * 4 + column];
                    nncov_tmp[i + 1] = rn[ncol];
                    break;
                }
            }
        }

        // candidates keep Python's first-max-wins selection
        if (cov_renew > best_cov) {
            best_cov = cov_renew;
            best_primer = lst;
            best_nn = nn_tmp;
            best_nncov = nncov_tmp;
        }
    }

    primer.swap(best_primer);
    coverage = best_cov;
    nn.swap(best_nn);
    nncov.swap(best_nncov);
    int64_t dege = 1, n_dege = 0;
    for (int64_t i = 0; i < plen; i++) {
        int mc = 0;
        const uint8_t msk = RF_CHAR2MASK[primer[i]];
        for (int b = 0; b < 4; b++) mc += ((msk >> b) & 1);
        if (mc == 0) mc = 1;                 // gap char: member count 1
        dege *= mc;
        if (mc > 1) n_dege += 1;
    }
    *out_dege = dege;
    *out_ndege = n_dege;
}

// The v15/v16 perfect-coverage-driven loop (core_V15.py:964-986).
// primer: in = consensus chars, out = refined chars.  nn is caller-copied
// (mutated).  Returns 0 on success, -1 when the caller must fall back to
// the Python loop (expansion blowup guard).
int64_t refine_v16_loop(uint8_t* primer, int64_t plen,
                        int64_t* nn_in,                // (plen-1)*16
                        const uint8_t* keys, const int64_t* counts,
                        int64_t K,
                        int64_t coverage_init, int64_t cover_number,
                        int64_t degeneracy_limit, int64_t dege_limit,
                        const uint8_t* nn_index,       // (plen-1)*2
                        int64_t* out_cov) {
    if (plen < 3 || plen > 40) return -1;
    refine_detail::KeyMap cover;
    cover.build(keys, counts, K, plen);

    std::vector<uint8_t> prm(primer, primer + plen);
    std::vector<int64_t> nn(nn_in, nn_in + (size_t)(plen - 1) * 16);
    std::vector<int64_t> nncov((size_t)(plen - 1));
    for (int64_t i = 0; i < plen - 1; i++)
        nncov[i] = nn[(size_t)i * 16 + nn_index[i * 2] * 4 + nn_index[i * 2 + 1]];

    int64_t cov = coverage_init;
    std::vector<int64_t> nncov_prev;
    while (cov < cover_number) {
        nncov_prev = nncov;
        int fallback = 0;
        int64_t dege = 0, n_dege = 0;
        refine_step(prm, cov, nn, nncov, nn_index, cover, plen, &fallback,
                    &dege, &n_dege);
        if (fallback) return -1;
        if (nncov == nncov_prev) break;
        if (dege >= degeneracy_limit || n_dege >= dege_limit) break;
    }
    memcpy(primer, prm.data(), (size_t)plen);
    *out_cov = cov;
    return 0;
}

// The v20 mis-coverage-driven loop (multiPrime-core.py:881-906).  The
// loop's intermediate _mis_primer_check calls feed only the f/r mis COUNT
// sums — pure order-independent integer reductions over the distinct
// window keys — so they run here; the final F/R non-cover dicts (whose
// key order follows CPython set layout) are recomputed once in Python on
// the returned primer, which is byte-identical to the last in-loop call
// because the counts and dicts are deterministic functions of the primer.
// covered: uint8 [128][128] truth table (the reference's Y_distance float
// arithmetic evaluated once per char pair); f/r_strict: per-position
// forbidden flags.  Returns 0, or -1 to fall back to the Python loop.

static void mis_counts_v20(const uint8_t* prm, int64_t plen,
                           const uint8_t* keys, const int64_t* counts,
                           int64_t K, const uint8_t* covered,
                           const uint8_t* f_strict, const uint8_t* r_strict,
                           int64_t variation,
                           int64_t* f_mis, int64_t* r_mis) {
    int64_t f = 0, r = 0;
    for (int64_t k = 0; k < K; k++) {
        const uint8_t* key = keys + k * plen;
        bool member = true;       // key in expansions(primer)?
        int64_t nmis = 0;
        bool fbad = false, rbad = false;
        for (int64_t i = 0; i < plen; i++) {
            const uint8_t pc = prm[i];
            const uint8_t kc = key[i];
            if (member) {
                const uint8_t pm = RF_CHAR2MASK[pc];
                if (pm == 0) {
                    member = (kc == pc);
                } else {
                    const uint8_t km = RF_CHAR2MASK[kc];
                    member = km && !(km & (km - 1)) && (km & pm);
                }
            }
            if (!covered[(size_t)pc * 128 + kc]) {
                nmis++;
                fbad |= (f_strict[i] != 0);
                rbad |= (r_strict[i] != 0);
            }
        }
        if (member || nmis > variation) continue;
        if (!fbad) f += counts[k];
        if (!rbad) r += counts[k];
    }
    *f_mis = f;
    *r_mis = r;
}

int64_t refine_v20_loop(uint8_t* primer, int64_t plen,
                        int64_t* nn_in,                // (plen-1)*16
                        const uint8_t* keys, const int64_t* counts,
                        int64_t K,
                        int64_t coverage_init, int64_t cover_number,
                        int64_t degeneracy_limit, int64_t dege_limit,
                        const uint8_t* nn_index,       // (plen-1)*2
                        const uint8_t* covered,        // [128*128]
                        const uint8_t* f_strict, const uint8_t* r_strict,
                        int64_t variation,
                        int64_t* out_cov) {
    if (plen < 3 || plen > 40) return -1;
    refine_detail::KeyMap cover;
    cover.build(keys, counts, K, plen);

    std::vector<uint8_t> prm(primer, primer + plen);
    std::vector<int64_t> nn(nn_in, nn_in + (size_t)(plen - 1) * 16);
    std::vector<int64_t> nncov((size_t)(plen - 1));
    for (int64_t i = 0; i < plen - 1; i++)
        nncov[i] = nn[(size_t)i * 16 + nn_index[i * 2] * 4 + nn_index[i * 2 + 1]];

    int64_t cov = coverage_init;
    int64_t f_mis, r_mis;
    mis_counts_v20(prm.data(), plen, keys, counts, K, covered, f_strict,
                   r_strict, variation, &f_mis, &r_mis);
    std::vector<int64_t> nncov_prev;
    while (cov + f_mis < cover_number || cov + r_mis < cover_number) {
        nncov_prev = nncov;
        int fallback = 0;
        int64_t dege = 0, n_dege = 0;
        refine_step(prm, cov, nn, nncov, nn_index, cover, plen, &fallback,
                    &dege, &n_dege);
        if (fallback) return -1;
        mis_counts_v20(prm.data(), plen, keys, counts, K, covered, f_strict,
                       r_strict, variation, &f_mis, &r_mis);
        const int64_t mx = f_mis > r_mis ? f_mis : r_mis;
        if (mx == cover_number) break;
        if (nncov == nncov_prev) break;
        // 2*dege > D or 3*dege/2 > D (exact: 3*dege > 2*D) or n_dege == lim
        if (2 * dege > degeneracy_limit || 3 * dege > 2 * degeneracy_limit
                || n_dege == dege_limit) break;
    }
    memcpy(primer, prm.data(), (size_t)plen);
    *out_cov = cov;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Distinct-row grouping for the design engine's per-window cover build
// (models/mcdpd.py::_design_window): group identical [N, plen] window rows,
// preserving first-occurrence order and ascending member indices — exactly
// the insertion semantics of the Python bytes-keyed dict loop it replaces.

extern "C" {

// rows: uint8 [n, plen] contiguous.  Outputs: order_out[R] = first row index
// of each distinct group (first-occurrence order), members_out[n] = row
// indices grouped (ascending inside each group), offsets_out[R+1].
// Returns R.
int64_t group_rows(const uint8_t* rows, int64_t n, int64_t plen,
                   int32_t* order_out, int32_t* members_out,
                   int32_t* offsets_out) {
    uint32_t cap = 8;
    while (cap < (uint32_t)(n * 2 + 2)) cap <<= 1;
    const uint32_t mask = cap - 1;
    static thread_local std::vector<uint32_t> slot;     // group index + 1
    slot.assign(cap, 0);
    static thread_local std::vector<int32_t> head, next_, tail, first;
    head.clear(); tail.clear(); first.clear();
    next_.assign((size_t)n, -1);

    for (int64_t si = 0; si < n; si++) {
        const uint8_t* key = rows + si * plen;
        uint64_t h = 1469598103934665603ull;
        for (int64_t i = 0; i < plen; i++) {
            h ^= key[i];
            h *= 1099511628211ull;
        }
        uint32_t j = (uint32_t)h & mask;
        int32_t gi = -1;
        while (slot[j]) {
            const int32_t cand = (int32_t)slot[j] - 1;
            if (memcmp(rows + (size_t)first[cand] * plen, key,
                       (size_t)plen) == 0) { gi = cand; break; }
            j = (j + 1) & mask;
        }
        if (gi < 0) {
            gi = (int32_t)first.size();
            slot[j] = (uint32_t)gi + 1;
            first.push_back((int32_t)si);
            head.push_back((int32_t)si);
            tail.push_back((int32_t)si);
        } else {
            next_[tail[gi]] = (int32_t)si;
            tail[gi] = (int32_t)si;
        }
    }
    const int64_t R = (int64_t)first.size();
    int32_t pos = 0;
    for (int64_t g = 0; g < R; g++) {
        order_out[g] = first[g];
        offsets_out[g] = pos;
        for (int32_t s = head[g]; s >= 0; s = next_[s])
            members_out[pos++] = s;
    }
    offsets_out[R] = pos;
    return R;
}

// Exact integer frequency / nearest-neighbour tensors over the distinct
// cover keys (models/mcdpd.py::_design_window): replaces the two einsum
// calls freq[b][l] = sum_k c_k [key_kl == base_b] and
// nn[l][i][j] = sum_k c_k [key_kl == base_i][key_k,l+1 == base_j].
// keys: uint8 ASCII [K, plen]; non-ACGT bytes (gaps) contribute nothing,
// matching the all-zero one-hot rows of the NumPy formulation.
void freq_nn(const uint8_t* keys, int64_t K, int64_t plen,
             const int64_t* counts,
             int64_t* freq_out /* [4, plen] */,
             int64_t* nn_out /* [plen-1, 4, 4] */) {
    int8_t map[256];
    memset(map, -1, sizeof(map));
    map['A'] = 0; map['C'] = 1; map['G'] = 2; map['T'] = 3;
    memset(freq_out, 0, sizeof(int64_t) * 4 * (size_t)plen);
    memset(nn_out, 0, sizeof(int64_t) * 16 * (size_t)(plen - 1));
    for (int64_t k = 0; k < K; k++) {
        const uint8_t* row = keys + k * plen;
        const int64_t c = counts[k];
        int8_t prev = map[row[0]];
        if (prev >= 0) freq_out[(int64_t)prev * plen] += c;
        for (int64_t l = 1; l < plen; l++) {
            const int8_t b = map[row[l]];
            if (b >= 0) {
                freq_out[(int64_t)b * plen + l] += c;
                if (prev >= 0) nn_out[(l - 1) * 16 + prev * 4 + b] += c;
            }
            prev = b;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Mask-based mismatch-tolerant scan — host fast path of the bowtie2
// replacement (primer_coverage_validation_by_BWT.py:264-301 semantics via
// validate/scan.py).  Targets are strict 4-bit base codes (A=1, C=2, G=4,
// T=8; everything else 0 = never matches, like encode_targets' purity
// zeroing); primers are per-position IUPAC member masks, so one degenerate
// primer covers its whole expansion set: a position matches iff the target
// base's bit is inside the mask, hence the window's mismatch set equals the
// best expansion's mismatch set and the reference's "exists an expansion
// with <= mm mismatches and a clean 3'-terminal run" is exactly
//   popcount{j : (t[o+j] & m[j]) == 0} <= mm  AND  no such j in the last
//   `term` positions.
// Early exit makes the expected per-window cost a handful of byte ops, far
// under the im2col+sgemm formulation for the small-N workloads the host
// path serves.

extern "C" {

// Hits are written as (row, pos, primer, mismatches) int32 quadruples in
// ascending (row, pos, primer) order — the exact np.nonzero contract of
// find_hits_numpy.  Returns the TOTAL hit count even when it exceeds
// max_hits (caller retries with a bigger buffer); rows are chunked across
// threads with per-thread buffers merged in row order.
static void mask_scan_rows(const uint8_t* targets, int64_t stride,
                           const int64_t* lens, int64_t row0, int64_t row1,
                           const uint8_t* masks, int64_t p, int64_t plen,
                           int64_t mm, int64_t term,
                           std::vector<int32_t>* out) {
    const int64_t suffix0 = term > 0 ? (plen - term) : plen;
    for (int64_t n = row0; n < row1; n++) {
        const uint8_t* t = targets + n * stride;
        const int64_t n_out = lens[n] - plen + 1;
        for (int64_t o = 0; o < n_out; o++) {
            const uint8_t* w = t + o;
            for (int64_t pi = 0; pi < p; pi++) {
                const uint8_t* m = masks + pi * plen;
                int64_t mis = 0;
                // suffix first: a single clean-run test rejects most
                // windows in <= term byte ops
                int64_t j = suffix0;
                for (; j < plen; j++)
                    if ((w[j] & m[j]) == 0) goto next_primer;
                for (j = 0; j < suffix0; j++) {
                    if ((w[j] & m[j]) == 0 && ++mis > mm) goto next_primer;
                }
                out->push_back((int32_t)n);
                out->push_back((int32_t)o);
                out->push_back((int32_t)pi);
                out->push_back((int32_t)mis);
            next_primer:;
            }
        }
    }
}

int64_t mask_scan(const uint8_t* targets, int64_t n, int64_t stride,
                  const int64_t* lens, const uint8_t* masks, int64_t p,
                  int64_t plen, int64_t mm, int64_t term,
                  int32_t* out, int64_t max_hits, int64_t nthreads) {
    if (plen <= 0 || p <= 0 || n <= 0) return 0;
    // find_hits_numpy semantics: term > plen can never reach `suffix >=
    // term` matches, so no window hits at all
    if (term > plen) return 0;
    int64_t nt = nthreads;
    if (nt <= 0) nt = 1;
    if (nt > n) nt = n;
    std::vector<std::vector<int32_t>> bufs((size_t)nt);
    if (nt == 1) {
        mask_scan_rows(targets, stride, lens, 0, n, masks, p, plen, mm,
                       term, &bufs[0]);
    } else {
        std::vector<std::thread> pool;
        const int64_t chunk = (n + nt - 1) / nt;
        for (int64_t t = 0; t < nt; t++) {
            const int64_t r0 = t * chunk;
            const int64_t r1 = (t + 1) * chunk < n ? (t + 1) * chunk : n;
            pool.emplace_back([=, &bufs]() {
                if (r0 < r1)
                    mask_scan_rows(targets, stride, lens, r0, r1, masks, p,
                                   plen, mm, term, &bufs[(size_t)t]);
            });
        }
        for (auto& th : pool) th.join();
    }
    int64_t total = 0;
    for (auto& b : bufs) total += (int64_t)(b.size() / 4);
    int64_t written = 0;
    for (auto& b : bufs) {
        const int64_t k = (int64_t)(b.size() / 4);
        const int64_t take = (written + k <= max_hits) ? k
                             : (max_hits > written ? max_hits - written : 0);
        if (take > 0)
            memcpy(out + written * 4, b.data(), (size_t)take * 4 * 4);
        written += take;
        if (written >= max_hits && total > max_hits) continue;
    }
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Pairing cross-dimer hit-end enumeration (models/pairing._dimer_hit_ends).
//
// For every expansion of a degenerate primer, every distinct substring s
// (len 5..18) at its first occurrence idx triggers when
// loss(len, GC, d2=n-len-idx) > 3.6 — a pure (len, gc, d2) predicate the
// caller passes as a precomputed table — or, failing that, when d2 == 0
// and dG(rc(s)) < -5.  dG evaluation stays in (memoised) Python: this
// routine returns the loss-triggered rc(s) strings plus the distinct
// d2==0 candidates.  The result is consumed as a SET, so only membership
// matters — no iteration-order contract to preserve.

extern "C" {

// trig: uint8 [l1][l1][l1] flattened (len, gc, d2).  Both output buffers
// receive '\n'-joined strings; returns total byte length written into
// trig_buf via *trig_len and dg_buf via *dg_len, or -1 on fallback
// (unknown code, expansion blowup, buffer overflow).
int64_t dimer_hit_ends(const char* primer, int64_t plen,
                       const uint8_t* trig, int64_t l1,
                       char* trig_buf, int64_t trig_cap, int64_t* trig_len,
                       char* dg_buf, int64_t dg_cap, int64_t* dg_len) {
    if (plen <= 0 || plen >= l1 || plen > 63) return -1;
    std::vector<std::string> expansions;
    if (!expandAll(primer, plen, &expansions, 4096)) return -1;
    // expansions are pure ACGT (<= 18-mers packed into 36 bits), so every
    // substring identity test packs into (len << 40) | 2-bit code — the
    // string-keyed set version spent ~90% of the call in substr allocs
    // and string hashing (38 us/primer; this form measures ~4 us)
    std::unordered_set<uint64_t> done;      // loss-triggered substrings
    std::unordered_set<uint64_t> dg_seen;   // emitted d2==0 candidates
    int64_t tpos = 0, dpos = 0;
    char rcbuf[64];
    // Enumeration is ln-major with a rolling packed code per length; the
    // per-expansion first-occurrence test is a flat scan over the few
    // same-length codes seen so far (p.find(s) < start, no hashing).  The
    // consumer builds SETS from both output streams, so the order change
    // vs the start-major walk is immaterial; the per-(expansion, substring)
    // first-occurrence d2 semantics are identical.
    for (const auto& p : expansions) {
        const int64_t n = (int64_t)p.size();
        int gcpre[64];
        int b2[64];
        gcpre[0] = 0;
        for (int64_t i = 0; i < n; i++) {
            const char c = p[i];
            gcpre[i + 1] = gcpre[i] + (c == 'G' || c == 'C');
            b2[i] = c == 'A' ? 0 : c == 'C' ? 1 : c == 'G' ? 2
                  : c == 'T' ? 3 : -1;
            if (b2[i] < 0) return -1;      // non-ACGT expansion: fallback
        }
        const int64_t maxln = std::min<int64_t>(18, n);
        uint64_t codes[64];
        for (int64_t ln = 5; ln <= maxln; ln++) {
            const int64_t m = n - ln + 1;
            const uint64_t mask = (ln * 2 >= 64)
                ? ~0ull : ((1ull << (ln * 2)) - 1);
            uint64_t code = 0;
            for (int64_t i = 0; i < ln; i++)
                code = (code << 2) | (uint64_t)b2[i];
            for (int64_t start = 0; start < m; start++) {
                if (start)
                    code = ((code << 2) | (uint64_t)b2[start + ln - 1])
                           & mask;
                codes[start] = code;
                bool first_occ = true;
                for (int64_t j = 0; j < start; j++)
                    if (codes[j] == code) { first_occ = false; break; }
                if (!first_occ) continue;
                const uint64_t key = ((uint64_t)ln << 40) | code;
                if (done.count(key)) continue;
                const int64_t d2 = n - ln - start;
                const int gc = gcpre[start + ln] - gcpre[start];
                const char* s = p.data() + start;
                if (trig[(ln * l1 + gc) * l1 + d2]) {
                    done.insert(key);
                    for (int64_t k = 0; k < ln; k++) {
                        const char ch = s[ln - 1 - k];
                        rcbuf[k] = ch == 'A' ? 'T' : ch == 'T' ? 'A'
                                 : ch == 'G' ? 'C' : 'G';
                    }
                    if (tpos + ln + 1 > trig_cap) return -1;
                    memcpy(trig_buf + tpos, rcbuf, (size_t)ln);
                    trig_buf[tpos + ln] = '\n';
                    tpos += ln + 1;
                } else if (d2 == 0 && dg_seen.insert(key).second) {
                    if (dpos + ln + 1 > dg_cap) return -1;
                    memcpy(dg_buf + dpos, s, (size_t)ln);
                    dg_buf[dpos + ln] = '\n';
                    dpos += ln + 1;
                }
            }
        }
    }
    *trig_len = tpos;
    *dg_len = dpos;
    return 0;
}

// Zacharias-model dG verdict for a pure end e (thermo/exact.delta_g with
// both_ends=False): accumulate the Python-precomputed per-step addends
// fl(F*H + P) in the same order, add the 5'-initiation (+TERMINAL_TA when
// e ends "TA"), subtract the Python-precomputed per-length salt term, add
// SYMMETRY for the reference's elementwise-complement "symmetry" (base
// codes pair iff they sum to 3: A0+T3, C1+G2).  round(dg, 2) < -5 is
// evaluated via snprintf("%.2f") + strtod — both correctly rounded, so the
// composition equals CPython's round() on every double (fuzz-verified in
// tests/test_pairing_golden.py).
static bool dg_end_accept(const char* e, int64_t ln, const double* step,
                          const double* init_tab, double terminal_ta,
                          double symmetry, const double* salt_tab,
                          int both_ends) {
    int b[64];
    for (int64_t i = 0; i < ln; i++) {
        const char c = e[i];
        b[i] = c == 'A' ? 0 : c == 'C' ? 1 : c == 'G' ? 2 : 3;
    }
    double dg = 0.0;
    for (int64_t n = 0; n + 1 < ln; n++)
        dg += step[b[n + 1] * 4 + b[n]];
    // thermo.delta_g: both_ends adds the 3'-initiation too; op order kept
    const double init5 = init_tab[b[0]];
    if (ln >= 2 && e[ln - 2] == 'T' && e[ln - 1] == 'A') {
        if (both_ends)
            dg += init5 + init_tab[b[ln - 1]] + terminal_ta;
        else
            dg += init5 + terminal_ta;
    } else {
        if (both_ends)
            dg += init5 + init_tab[b[ln - 1]];
        else
            dg += init5;
    }
    dg -= salt_tab[ln];
    if (ln % 2 == 0) {
        bool sym = true;
        const int64_t half = ln / 2;
        for (int64_t i = 0; i < half; i++)
            if (b[i] + b[half + i] != 3) { sym = false; break; }
        if (sym) dg += symmetry;
    }
    char buf[40];
    snprintf(buf, sizeof buf, "%.2f", dg);
    return strtod(buf, nullptr) < -5.0;
}

// dimer_hit_ends with the d2==0 dG verdict resolved natively: one output
// stream of hit ends (models/pairing._dimer_hit_ends without the Python
// delta_g tail — at the 21k/100k scales that tail was ~1/3 of every
// singleton cluster's pairing stage).  Same enumeration semantics as
// dimer_hit_ends above; dg-rejected substrings stay eligible for the loss
// gate in later expansions (only their dG evaluation is memoised).
int64_t dimer_hit_ends2(const char* primer, int64_t plen,
                        const uint8_t* trig, int64_t l1,
                        const double* step_tab, const double* init_tab,
                        double terminal_ta, double symmetry,
                        const double* salt_tab,
                        char* trig_buf, int64_t trig_cap,
                        int64_t* trig_len) {
    if (plen <= 0 || plen >= l1 || plen > 63) return -1;
    std::vector<std::string> expansions;
    if (!expandAll(primer, plen, &expansions, 4096)) return -1;
    std::unordered_set<uint64_t> done;      // emitted (hit) substrings
    std::unordered_set<uint64_t> dg_seen;   // dG-evaluated d2==0 substrings
    int64_t tpos = 0;
    char rcbuf[64];
    for (const auto& p : expansions) {
        const int64_t n = (int64_t)p.size();
        int gcpre[64];
        int b2[64];
        gcpre[0] = 0;
        for (int64_t i = 0; i < n; i++) {
            const char c = p[i];
            gcpre[i + 1] = gcpre[i] + (c == 'G' || c == 'C');
            b2[i] = c == 'A' ? 0 : c == 'C' ? 1 : c == 'G' ? 2
                  : c == 'T' ? 3 : -1;
            if (b2[i] < 0) return -1;      // non-ACGT expansion: fallback
        }
        const int64_t maxln = std::min<int64_t>(18, n);
        uint64_t codes[64];
        for (int64_t ln = 5; ln <= maxln; ln++) {
            const int64_t m = n - ln + 1;
            const uint64_t mask = (ln * 2 >= 64)
                ? ~0ull : ((1ull << (ln * 2)) - 1);
            uint64_t code = 0;
            for (int64_t i = 0; i < ln; i++)
                code = (code << 2) | (uint64_t)b2[i];
            for (int64_t start = 0; start < m; start++) {
                if (start)
                    code = ((code << 2) | (uint64_t)b2[start + ln - 1])
                           & mask;
                codes[start] = code;
                bool first_occ = true;
                for (int64_t j = 0; j < start; j++)
                    if (codes[j] == code) { first_occ = false; break; }
                if (!first_occ) continue;
                const uint64_t key = ((uint64_t)ln << 40) | code;
                if (done.count(key)) continue;
                const int64_t d2 = n - ln - start;
                const int gc = gcpre[start + ln] - gcpre[start];
                const char* s = p.data() + start;
                bool hit = false;
                if (trig[(ln * l1 + gc) * l1 + d2]) {
                    hit = true;
                } else if (d2 == 0 && dg_seen.insert(key).second) {
                    for (int64_t k = 0; k < ln; k++) {
                        const char ch = s[ln - 1 - k];
                        rcbuf[k] = ch == 'A' ? 'T' : ch == 'T' ? 'A'
                                 : ch == 'G' ? 'C' : 'G';
                    }
                    hit = dg_end_accept(rcbuf, ln, step_tab, init_tab,
                                        terminal_ta, symmetry, salt_tab,
                                        0);
                }
                if (!hit) continue;
                done.insert(key);
                for (int64_t k = 0; k < ln; k++) {
                    const char ch = s[ln - 1 - k];
                    rcbuf[k] = ch == 'A' ? 'T' : ch == 'T' ? 'A'
                             : ch == 'G' ? 'C' : 'G';
                }
                if (tpos + ln + 1 > trig_cap) return -1;
                memcpy(trig_buf + tpos, rcbuf, (size_t)ln);
                trig_buf[tpos + ln] = '\n';
                tpos += ln + 1;
            }
        }
    }
    *trig_len = tpos;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native banded pair enumeration for PURE candidate sets with no uncovered
// accessions (models/pairing.enumerate_pairs' dominant cluster class at
// scale: singleton and fully-covered gapless clusters).  Replicates the
// Python loop's gate semantics exactly in (ln<<40|code) key space:
//   ends(X)  = 5..18-mer suffix codes of X (current_end on a pure string)
//   hits(X)  = rc'd first-occurrence substrings triggering the loss gate,
//              plus d2==0 substrings passing the native dG verdict
//              (dimer_hit_ends2 semantics, single expansion)
//   pair (i,j) emits iff r_ok[j], |tm_i - tm_j| <= diff_tm, !self(F_i),
//              !self(R_j), ends(F_i) disjoint hits(R_j), ends(R_j)
//              disjoint hits(F_i)   [f_ok / band handled per start]
// String equality on pure ACGT is bijective with key equality, so the
// surviving (i, j) set — and the (i asc, j asc) emission order the stable
// coverage sort depends on — is identical to the Python path's.

namespace {

struct PairPrimerState {
    bool built = false;
    bool self_hit = false;
    uint64_t ends[16];
    int n_ends = 0;
    std::unordered_set<uint64_t> hits;
};

// hits(X) for one pure sequence; also fills the suffix end keys + self flag.
static bool build_pair_state(const uint8_t* s, int64_t n,
                             const uint8_t* trig, int64_t l1,
                             const double* step_tab, const double* init_tab,
                             double terminal_ta, double symmetry,
                             const double* salt_tab,
                             PairPrimerState* st) {
    if (n <= 0 || n >= l1 || n > 63) return false;
    int b2[64];
    int gcpre[64];
    gcpre[0] = 0;
    for (int64_t i = 0; i < n; i++) {
        const char c = (char)s[i];
        gcpre[i + 1] = gcpre[i] + (c == 'G' || c == 'C');
        b2[i] = c == 'A' ? 0 : c == 'C' ? 1 : c == 'G' ? 2
              : c == 'T' ? 3 : -1;
        if (b2[i] < 0) return false;
    }
    const int64_t maxln = std::min<int64_t>(18, n);
    uint64_t codes[64];
    char rcbuf[64];
    st->hits.clear();
    for (int64_t ln = 5; ln <= maxln; ln++) {
        const int64_t m = n - ln + 1;
        const uint64_t mask = (ln * 2 >= 64) ? ~0ull
                              : ((1ull << (ln * 2)) - 1);
        uint64_t code = 0;
        for (int64_t i = 0; i < ln; i++)
            code = (code << 2) | (uint64_t)b2[i];
        for (int64_t start = 0; start < m; start++) {
            if (start)
                code = ((code << 2) | (uint64_t)b2[start + ln - 1]) & mask;
            codes[start] = code;
            bool first_occ = true;
            for (int64_t j = 0; j < start; j++)
                if (codes[j] == code) { first_occ = false; break; }
            if (!first_occ) continue;
            const int64_t d2 = n - ln - start;
            const int gc = gcpre[start + ln] - gcpre[start];
            bool hit = false;
            if (trig[(ln * l1 + gc) * l1 + d2]) {
                hit = true;
            } else if (d2 == 0) {
                for (int64_t k = 0; k < ln; k++) {
                    const char ch = (char)s[start + ln - 1 - k];
                    rcbuf[k] = ch == 'A' ? 'T' : ch == 'T' ? 'A'
                             : ch == 'G' ? 'C' : 'G';
                }
                hit = dg_end_accept(rcbuf, ln, step_tab, init_tab,
                                    terminal_ta, symmetry, salt_tab, 0);
            }
            if (!hit) continue;
            // key of rc(substring): complement (3-b) of reversed walk
            uint64_t rccode = 0;
            for (int64_t k = 0; k < ln; k++)
                rccode = (rccode << 2)
                       | (uint64_t)(3 - b2[start + ln - 1 - k]);
            st->hits.insert(((uint64_t)ln << 40) | rccode);
        }
    }
    // suffix end keys (current_end: i = 5..18, primer[-i:] clamps to n)
    st->n_ends = 0;
    uint64_t prev = ~0ull;
    for (int64_t i = 5; i <= 18; i++) {
        const int64_t ln = i < n ? i : n;
        uint64_t code = 0;
        for (int64_t k = n - ln; k < n; k++)
            code = (code << 2) | (uint64_t)b2[k];
        const uint64_t key = ((uint64_t)ln << 40) | code;
        if (key != prev) {           // i >= n repeats the whole primer
            st->ends[st->n_ends++] = key;
            prev = key;
        }
    }
    st->self_hit = false;
    for (int e = 0; e < st->n_ends; e++)
        if (st->hits.count(st->ends[e])) { st->self_hit = true; break; }
    st->built = true;
    return true;
}

}  // namespace

extern "C" {

// str(round(x, 2)) for the finite doubles the pairing rows carry: glibc's
// %.2f is the correctly-rounded 2-decimal form (same value CPython's
// round(x, 2) snaps to); stripping trailing zeros while keeping one
// fractional digit reproduces CPython's shortest-repr str() of that
// double (grid-fuzzed in tests/test_pairing_golden.py).  Returns length.
static int py_round2_str(double x, char* out) {
    int n = snprintf(out, 32, "%.2f", x);
    // "%.2f" always ends "….BC"; only the final digit is droppable
    // ("52.50" -> "52.5", "53.00" -> "53.0", "53.05" stays)
    if (n > 0 && out[n - 1] == '0') n--;
    out[n] = '\0';
    return n;
}

// Returns the pair count written into out_pairs (i32 i,j interleaved)
// with the per-pair avg-Tm strings ('\n'-joined, Python str(round(.,2))
// bytes) in avg_buf, or -1 on fallback (non-ACGT rows, state-build
// failure, or cap overflow — the Python loop handles those).
int64_t pure_pair_bands(
    const uint8_t* fmat, const uint8_t* rmat, int64_t C, int64_t L,
    const int64_t* pos, const double* tm,
    const uint8_t* fok, const uint8_t* rok,
    int64_t min_len, int64_t max_len, double diff_tm,
    const uint8_t* trig, int64_t l1,
    const double* step_tab, const double* init_tab,
    double terminal_ta, double symmetry, const double* salt_tab,
    int64_t si0, int64_t si1,
    int32_t* out_pairs, int64_t cap,
    char* avg_buf, int64_t avg_cap, int64_t* avg_len) {
    if (C <= 0 || si0 < 0 || si1 > C) return -1;
    std::vector<PairPrimerState> fstate(C), rstate(C);
    int64_t n_out = 0;
    int64_t apos = 0;
    const int64_t last_pos = pos[C - 1];
    for (int64_t i = si0; i < si1; i++) {
        if (!fok[i]) continue;
        // band: bisect_left(pos, start+min_len) .. right
        const int64_t lo_t = pos[i] + min_len;
        int64_t lo = std::lower_bound(pos, pos + C, lo_t) - pos;
        int64_t hi;
        if (pos[i] + max_len > last_pos) {
            hi = C - 1;
        } else {
            hi = (std::lower_bound(pos, pos + C, pos[i] + max_len) - pos)
                 - 1;
        }
        if (lo > hi) continue;
        PairPrimerState& fs = fstate[i];
        if (!fs.built &&
            !build_pair_state(fmat + i * L, L, trig, l1, step_tab,
                              init_tab, terminal_ta, symmetry, salt_tab,
                              &fs))
            return -1;
        if (fs.self_hit) continue;
        const double tmf = tm[i];
        for (int64_t j = lo; j <= hi; j++) {
            if (!rok[j]) continue;
            const double d = tm[j] - tmf;
            if (d > diff_tm || d < -diff_tm) continue;
            PairPrimerState& rs = rstate[j];
            if (!rs.built &&
                !build_pair_state(rmat + j * L, L, trig, l1, step_tab,
                                  init_tab, terminal_ta, symmetry,
                                  salt_tab, &rs))
                return -1;
            if (rs.self_hit) continue;
            bool dimer = false;
            for (int e = 0; e < fs.n_ends; e++)
                if (rs.hits.count(fs.ends[e])) { dimer = true; break; }
            if (!dimer)
                for (int e = 0; e < rs.n_ends; e++)
                    if (fs.hits.count(rs.ends[e])) { dimer = true; break; }
            if (dimer) continue;
            if (n_out >= cap) return -1;
            out_pairs[n_out * 2] = (int32_t)i;
            out_pairs[n_out * 2 + 1] = (int32_t)j;
            n_out++;
            // avg Tm string: _stat_mean([a, b]) == (a+b)/2 for finite
            // doubles, then Python str(round(., 2)) bytes
            if (apos + 34 > avg_cap) return -1;
            apos += py_round2_str((tmf + tm[j]) / 2.0, avg_buf + apos);
            avg_buf[apos++] = '\n';
        }
    }
    *avg_len = apos;
    return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Seed-indexed mismatch scan — the large-P path of the bowtie2 replacement.
//
// Pigeonhole: a window with <= mm mismatches against a pattern must match
// at least one of mm+1 disjoint chunks exactly.  Chunk expansions (pure
// 2-bit codes) go into a hash index; the target is scanned once per
// distinct chunk length with a rolling packed code, and each index hit
// proposes a candidate alignment that is verified with the same mask test
// as mask_scan.  A candidate is accepted from chunk c only if every
// earlier chunk of the same pattern is NOT exact there, so each
// (row, pos, pattern) is generated exactly once.  Hit set and order are
// identical to mask_scan (ascending (row, pos, pattern); per-row sort).
// Patterns whose chunks exceed the expansion cap fall back to the
// early-exit brute walk within the same call.

namespace seed_detail {

struct Index {
    // open-addressing map: key -> chain head into entries
    std::vector<uint64_t> keys;
    std::vector<int32_t> head;
    std::vector<int32_t> nxt;          // entry chain
    std::vector<int32_t> e_pat;        // pattern id
    std::vector<int32_t> e_off;        // chunk offset in pattern
    uint64_t mask = 0;

    void init(size_t expected) {
        size_t cap = 64;
        while (cap < expected * 2) cap <<= 1;
        keys.assign(cap, ~0ull);
        head.assign(cap, -1);
        mask = cap - 1;
    }
    static uint64_t mix(uint64_t k) {
        k *= 0x9E3779B97F4A7C15ull;
        k ^= k >> 29;
        k *= 0xBF58476D1CE4E5B9ull;
        k ^= k >> 32;
        return k;
    }
    void add(uint64_t key, int32_t pat, int32_t off) {
        uint64_t j = mix(key) & mask;
        while (keys[j] != ~0ull && keys[j] != key) j = (j + 1) & mask;
        keys[j] = key;
        e_pat.push_back(pat);
        e_off.push_back(off);
        nxt.push_back(head[j]);
        head[j] = (int32_t)(e_pat.size() - 1);
    }
    int32_t find(uint64_t key) const {
        uint64_t j = mix(key) & mask;
        while (keys[j] != ~0ull) {
            if (keys[j] == key) return head[j];
            j = (j + 1) & mask;
        }
        return -1;
    }
};

// enumerate 2-bit packed expansions of masks[off..off+len); false on blowup
static bool chunk_codes(const uint8_t* masks, int64_t off, int64_t len,
                        int64_t cap, std::vector<uint64_t>* out) {
    out->clear();
    out->push_back(0);
    for (int64_t j = 0; j < len; j++) {
        const uint8_t m = masks[off + j];
        if (m == 0) return false;
        const size_t n = out->size();
        size_t first_done = 0;
        uint64_t firstb = 99;
        for (int b = 0; b < 4; b++) {
            if (!(m & (1 << b))) continue;
            if (firstb == 99) { firstb = (uint64_t)b; continue; }
            for (size_t e = 0; e < n; e++) {
                out->push_back(((*out)[e] << 2) | (uint64_t)b);
                if ((int64_t)out->size() > cap) return false;
            }
            (void)first_done;
        }
        if (firstb == 99) return false;
        for (size_t e = 0; e < n; e++)
            (*out)[e] = ((*out)[e] << 2) | firstb;
    }
    return true;
}

struct Plan {
    Index index;
    std::vector<int32_t> brute;            // pattern ids on the brute path
    std::vector<int64_t> chunk_lo;         // [n_chunks+1] bounds
    std::vector<int64_t> lens;             // distinct chunk lengths
    int64_t n_chunks = 0;
};

}  // namespace seed_detail

extern "C" {

// Same contract as mask_scan.  exp_cap bounds per-chunk expansions before a
// pattern falls back to the brute walk.
int64_t seed_scan(const uint8_t* targets, int64_t n, int64_t stride,
                  const int64_t* lens, const uint8_t* masks, int64_t p,
                  int64_t plen, int64_t mm, int64_t term,
                  int32_t* out, int64_t max_hits, int64_t nthreads,
                  int64_t exp_cap) {
    if (plen <= 0 || p <= 0 || n <= 0) return 0;
    if (term > plen) return 0;
    const int64_t n_chunks = mm + 1;
    // guard: 2*Lmax+6 key bits must fit in 64 so (code, L) keys are exact
    // (no truncation => two expansions of one chunk can never share a
    // chain => no duplicate proposals)
    const int64_t lmax = n_chunks > 0 ? (plen + n_chunks - 1) / n_chunks : 64;
    if (mm < 0 || n_chunks > plen || plen > 31 || 2 * lmax + 6 > 64)
        return mask_scan(targets, n, stride, lens, masks, p, plen, mm, term,
                         out, max_hits, nthreads);
    seed_detail::Plan plan;
    plan.n_chunks = n_chunks;
    plan.chunk_lo.resize(n_chunks + 1);
    for (int64_t c = 0; c <= n_chunks; c++)
        plan.chunk_lo[c] = c * plen / n_chunks;
    for (int64_t c = 0; c < n_chunks; c++) {
        const int64_t L = plan.chunk_lo[c + 1] - plan.chunk_lo[c];
        bool seen = false;
        for (int64_t x : plan.lens) seen |= (x == L);
        if (!seen && L > 0) plan.lens.push_back(L);
    }
    // build
    std::vector<uint64_t> codes;
    std::vector<std::pair<uint64_t, std::pair<int32_t, int32_t>>> staged;
    for (int64_t pi = 0; pi < p; pi++) {
        bool ok = true;
        size_t mark = staged.size();
        for (int64_t c = 0; c < n_chunks && ok; c++) {
            const int64_t off = plan.chunk_lo[c];
            const int64_t L = plan.chunk_lo[c + 1] - off;
            if (!seed_detail::chunk_codes(masks + pi * plen, off, L,
                                          exp_cap, &codes)) {
                ok = false;
                break;
            }
            for (uint64_t code : codes)
                staged.push_back({(code << 6) | (uint64_t)L,
                                  {(int32_t)pi, (int32_t)off}});
        }
        if (!ok) {
            staged.resize(mark);
            plan.brute.push_back((int32_t)pi);
        }
    }
    plan.index.init(staged.size() + 1);
    for (auto& s : staged)
        plan.index.add(s.first, s.second.first, s.second.second);

    int64_t nt = nthreads <= 0 ? 1 : nthreads;
    if (nt > n) nt = n;
    std::vector<std::vector<int32_t>> bufs((size_t)nt);
    const int64_t suffix0 = term > 0 ? (plen - term) : plen;
    auto scan_rows = [&](int64_t r0, int64_t r1, std::vector<int32_t>* ob) {
        std::vector<std::pair<uint64_t, int32_t>> row_hits;   // key, mis
        for (int64_t row = r0; row < r1; row++) {
            const uint8_t* t = targets + row * stride;
            const int64_t tl = lens[row];
            const int64_t n_out = tl - plen + 1;
            if (n_out <= 0) continue;
            row_hits.clear();
            // brute subset first? order fixed by final per-row sort.
            for (int32_t pi : plan.brute) {
                const uint8_t* m = masks + (int64_t)pi * plen;
                for (int64_t o = 0; o < n_out; o++) {
                    const uint8_t* w = t + o;
                    int64_t mis = 0, j = suffix0;
                    for (; j < plen; j++)
                        if ((w[j] & m[j]) == 0) goto next_o;
                    for (j = 0; j < suffix0; j++)
                        if ((w[j] & m[j]) == 0 && ++mis > mm) goto next_o;
                    row_hits.push_back({((uint64_t)o * (uint64_t)p)
                                        + (uint64_t)pi, (int32_t)mis});
                next_o:;
                }
            }
            for (int64_t L : plan.lens) {
                const uint64_t cmask =
                    L >= 32 ? ~0ull : ((1ull << (2 * L)) - 1);
                uint64_t code = 0;
                int64_t invalid_until = -1;    // last pos with non-pure base
                for (int64_t pos = 0; pos + 1 <= tl; pos++) {
                    const uint8_t b = t[pos];
                    int64_t v;
                    switch (b) {
                        case 1: v = 0; break;
                        case 2: v = 1; break;
                        case 4: v = 2; break;
                        case 8: v = 3; break;
                        default: v = 0; invalid_until = pos; break;
                    }
                    code = ((code << 2) | (uint64_t)v) & cmask;
                    const int64_t start = pos - L + 1;
                    if (start < 0 || invalid_until >= start) continue;
                    const int32_t h = plan.index.find((code << 6)
                                                      | (uint64_t)L);
                    for (int32_t e = h; e >= 0; e = plan.index.nxt[e]) {
                        const int32_t pi = plan.index.e_pat[e];
                        const int32_t off = plan.index.e_off[e];
                        const int64_t cand = start - off;
                        if (cand < 0 || cand >= n_out) continue;
                        const uint8_t* m = masks + (int64_t)pi * plen;
                        const uint8_t* w = t + cand;
                        // the proposing chunk must itself be exact here
                        // (hash-key truncation/collisions only cost false
                        // proposals, never wrong hits or duplicates)
                        {
                            bool self_exact = true;
                            for (int64_t j = off; j < off + L; j++)
                                if ((w[j] & m[j]) == 0) {
                                    self_exact = false;
                                    break;
                                }
                            if (!self_exact) continue;
                        }
                        // exactly-once: an earlier chunk must not be exact
                        {
                            bool dup = false;
                            for (int64_t c = 0;
                                 plan.chunk_lo[c] < off && c < n_chunks;
                                 c++) {
                                bool exact = true;
                                for (int64_t j = plan.chunk_lo[c];
                                     j < plan.chunk_lo[c + 1]; j++)
                                    if ((w[j] & m[j]) == 0) {
                                        exact = false;
                                        break;
                                    }
                                if (exact) { dup = true; break; }
                            }
                            if (dup) continue;
                        }
                        int64_t mis = 0, j = suffix0;
                        for (; j < plen; j++)
                            if ((w[j] & m[j]) == 0) goto next_e;
                        for (j = 0; j < suffix0; j++)
                            if ((w[j] & m[j]) == 0 && ++mis > mm)
                                goto next_e;
                        row_hits.push_back({((uint64_t)cand * (uint64_t)p)
                                            + (uint64_t)pi, (int32_t)mis});
                    next_e:;
                    }
                }
            }
            std::sort(row_hits.begin(), row_hits.end());
            for (auto& h : row_hits) {
                ob->push_back((int32_t)row);
                ob->push_back((int32_t)(h.first / (uint64_t)p));
                ob->push_back((int32_t)(h.first % (uint64_t)p));
                ob->push_back(h.second);
            }
        }
    };
    if (nt == 1) {
        scan_rows(0, n, &bufs[0]);
    } else {
        std::vector<std::thread> pool;
        const int64_t chunk = (n + nt - 1) / nt;
        for (int64_t th = 0; th < nt; th++) {
            const int64_t r0 = th * chunk;
            const int64_t r1 = (th + 1) * chunk < n ? (th + 1) * chunk : n;
            pool.emplace_back([=, &bufs, &scan_rows]() {
                if (r0 < r1) scan_rows(r0, r1, &bufs[(size_t)th]);
            });
        }
        for (auto& th : pool) th.join();
    }
    int64_t total = 0;
    for (auto& b : bufs) total += (int64_t)(b.size() / 4);
    int64_t written = 0;
    for (auto& b : bufs) {
        const int64_t k = (int64_t)(b.size() / 4);
        const int64_t take = (written + k <= max_hits) ? k
                             : (max_hits > written ? max_hits - written : 0);
        if (take > 0)
            memcpy(out + written * 4, b.data(), (size_t)take * 4 * 4);
        written += take;
    }
    return total;
}

}  // extern "C"
