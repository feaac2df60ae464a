# Copied from multiprime_tpu/align/progressive.py (host code, no JAX).
"""Guide-tree progressive multiple alignment (MAFFT-style construction).

The center-star construction (`centerstar.py`) aligns every member to one
center, which is fast but degrades on deeply divergent clusters: two
members that disagree with the center in the same region are merged
arbitrarily.  This module adds the classic progressive scheme the
reference's MAFFT/MUSCLE provide (run_mafft.py:66-72):

1. pairwise k-mer distances (exact set intersections, reusing the
   clusterer's packed k-mer machinery);
2. a UPGMA guide tree (average linkage on the host — the matrix is tiny,
   <= max_seq=500 leaves);
3. post-order profile-profile merges: each internal node aligns its two
   children's column profiles with an affine-gap (Gotoh) DP whose
   substitution score is the expected pair score f_a · S · f_b.  The whole
   [La, Lb] substitution matrix is ONE matmul per merge ((F_a S) F_b^T), so
   the hot loop is the same vectorised-row DP as `centerstar.align_ops` and
   the FLOPs sit in BLAS/MXU-friendly GEMMs rather than per-cell Python.

Gap columns inserted by a merge apply to every row of that side, so row
strings are materialised incrementally as uint8 matrices (total memory
N x L_final).  The result keeps the input row order and, like the
center-star path, is polished by `refine.refine_msa` in the pipeline.

This is intentionally NOT a MAFFT port: no FFT anchoring, no tree
re-estimation; quality comes from the guide tree + the same
profile-realignment polish both constructions share.
"""

from __future__ import annotations

import numpy as np

from ..cluster.greedy import _encode, kmer_set
from .centerstar import GAP_EXT, GAP_OPEN, MATCH, MISMATCH
from . import centerstar

NEG = np.float32(-1e30)

# substitution score between column letters A C G T gap other:
# ACGT match/mismatch like the pairwise DP; gaps and masked bases score 0.
_S = np.zeros((6, 6), np.float32)
_S[:4, :4] = MISMATCH
np.fill_diagonal(_S[:4, :4], MATCH)


def kmer_distance_matrix(seqs, k=8):
    """1 - |K_i ∩ K_j| / min(|K_i|, |K_j|) over packed k-mer sets."""
    sets = [kmer_set(_encode(s), k) for s in seqs]
    inter = centerstar._pairwise_intersections(sets).astype(np.float64)
    lens = np.array([max(s.size, 1) for s in sets], np.float64)
    denom = np.minimum(lens[:, None], lens[None, :])
    d = 1.0 - inter / denom
    np.fill_diagonal(d, 0.0)
    return d


def upgma(dist):
    """Average-linkage merge order.

    -> list of (left, right) node ids; leaves are 0..n-1, internal node i
    gets id n+i.  Deterministic: ties break on the smallest (i, j).
    """
    n = dist.shape[0]
    if n == 1:
        return []
    d = dist.astype(np.float64).copy()
    np.fill_diagonal(d, np.inf)
    active = {i: (i, 1) for i in range(n)}      # slot -> (node id, size)
    merges = []
    next_id = n
    for _ in range(n - 1):
        slots = sorted(active)
        sub = d[np.ix_(slots, slots)]
        flat = np.argmin(sub)
        ai, aj = divmod(flat, len(slots))
        if ai > aj:
            ai, aj = aj, ai
        si, sj = slots[ai], slots[aj]
        (id_i, n_i), (id_j, n_j) = active[si], active[sj]
        merges.append((id_i, id_j))
        # average-linkage update into slot si
        others = [s for s in slots if s != si and s != sj]
        if others:
            upd = (d[si, others] * n_i + d[sj, others] * n_j) / (n_i + n_j)
            d[si, others] = upd
            d[others, si] = upd
        d[sj, :] = np.inf
        d[:, sj] = np.inf
        active[si] = (next_id, n_i + n_j)
        del active[sj]
        next_id += 1
    return merges


_CODE_LUT = np.full(256, 5, np.uint8)
for _ch, _v in zip(b"ACGT-", range(5)):
    _CODE_LUT[_ch] = _v


def _row_codes(rows_mat):
    return _CODE_LUT[rows_mat]


OP_M, OP_D, OP_I = 0, 1, 2


def profile_align(fa, fb):
    """Op codes (uint8: 0=M, 1=D column only from A, 2=I only from B)
    aligning profile A to profile B (Gotoh).  The substitution matrix is
    one GEMM; the DP runs in the native library when available (GIL-free,
    bit-identical to the NumPy fallback) or as vectorised NumPy rows."""
    la, lb = fa.shape[0], fb.shape[0]
    if la == 0:
        return np.full(lb, OP_I, np.uint8)
    if lb == 0:
        return np.full(la, OP_D, np.uint8)
    score = (fa @ _S) @ fb.T                     # [La, Lb] in one GEMM
    from .. import native
    ops = native.profile_align_ops(score, float(GAP_OPEN), float(GAP_EXT))
    if ops is not None:
        return ops
    jar = np.arange(lb + 1, dtype=np.float32)
    v_prev = np.empty(lb + 1, np.float32)
    v_prev[0] = 0
    v_prev[1:] = GAP_OPEN + GAP_EXT * jar[1:]
    f_prev = np.full(lb + 1, NEG, np.float32)
    ptr = np.zeros((la + 1, lb + 1), np.uint8)
    fcont = np.zeros((la + 1, lb + 1), bool)
    econt = np.zeros((la + 1, lb + 1), bool)
    ptr[0, 1:] = 2
    econt[0, 2:] = True
    for i in range(1, la + 1):
        sub = score[i - 1]
        f_cur = np.maximum(f_prev + GAP_EXT, v_prev + GAP_OPEN + GAP_EXT)
        fcont[i] = f_prev + GAP_EXT >= v_prev + GAP_OPEN + GAP_EXT
        diag = v_prev[:-1] + sub
        vert = np.empty(lb + 1, np.float32)
        vert[0] = f_cur[0]
        vert[1:] = np.maximum(diag, f_cur[1:])
        p = np.empty(lb + 1, np.uint8)
        p[0] = 1
        p[1:] = np.where(diag >= f_cur[1:], 0, 1)
        t = vert + GAP_OPEN - GAP_EXT * jar
        run = np.maximum.accumulate(t[:-1])
        e_cur = np.full(lb + 1, NEG, np.float32)
        e_cur[1:] = run + GAP_EXT * jar[1:]
        open_here = vert[:-1] + GAP_OPEN - GAP_EXT * jar[:-1]
        econt[i, 1:] = open_here < run
        v_cur = np.maximum(vert, e_cur)
        p = np.where(e_cur > vert, 2, p).astype(np.uint8)
        ptr[i] = p
        v_prev, f_prev = v_cur, f_cur
    ops = []
    i, j = la, lb
    state = 0
    while i > 0 or j > 0:
        if i == 0:
            m = 2
        elif j == 0:
            m = 1
        elif state == 1:
            m = 1
        elif state == 2:
            m = 2
        else:
            m = ptr[i, j]
        if m == 0:
            ops.append(OP_M)
            i -= 1
            j -= 1
            state = 0
        elif m == 1:
            ops.append(OP_D)
            state = 1 if fcont[i, j] else 0
            i -= 1
        else:
            ops.append(OP_I)
            state = (2 if econt[i, j] else 0) if (i > 0 and j > 0) else 0
            j -= 1
    ops.reverse()
    return np.array(ops, np.uint8)


def _expand(rows_mat, keep_mask, out_len):
    """Insert all-gap columns: keep_mask[col_out] says whether this output
    column consumes the next input column."""
    out = np.full((rows_mat.shape[0], out_len), ord("-"), np.uint8)
    out[:, keep_mask] = rows_mat
    return out


def _expand_counts(counts, keep_mask, out_len, n_members):
    """Insert all-gap columns into a count profile: new columns carry
    n_members gaps."""
    out = np.zeros((out_len, 6), np.float32)
    out[keep_mask] = counts
    out[~keep_mask, 4] = n_members
    return out


def progressive_msa(ids, seqs, k=8):
    """-> (ids, rows) multiple alignment in the input row order."""
    n = len(seqs)
    if n == 0:
        return ids, []
    if n == 1:
        return ids, [seqs[0]]
    merges = upgma(kmer_distance_matrix(seqs, k))
    # node id -> (row matrix, count profile [L,6], original row indices);
    # profiles merge incrementally (O(L) per merge) instead of rescanning
    # every row near the root (O(N L))
    nodes = {}
    for i, s in enumerate(seqs):
        mat = np.frombuffer(s.encode("ascii"), np.uint8).reshape(1, -1)
        counts = np.zeros((mat.shape[1], 6), np.float32)
        counts[np.arange(mat.shape[1]), _row_codes(mat[0])] = 1.0
        nodes[i] = (mat.copy(), counts, [i])
    def do_merge(left, right):
        ra, ca, idx_a = nodes.pop(left)
        rb, cb, idx_b = nodes.pop(right)
        ops = profile_align(ca / len(idx_a), cb / len(idx_b))
        in_a = ops != OP_I
        in_b = ops != OP_D
        merged = np.concatenate([
            _expand(ra, in_a, len(ops)),
            _expand(rb, in_b, len(ops))])
        counts = _expand_counts(ca, in_a, len(ops), len(idx_a)) \
            + _expand_counts(cb, in_b, len(ops), len(idx_b))
        return merged, counts, idx_a + idx_b

    # schedule merges in dependency waves: all merges of a wave touch
    # disjoint subtrees, so they run concurrently (the native DP drops the
    # GIL; the GEMMs thread inside BLAS)
    import os as _os
    from concurrent.futures import ThreadPoolExecutor
    depth = {i: 0 for i in range(n)}
    waves = {}
    next_id = n
    for left, right in merges:
        d = max(depth[left], depth[right]) + 1
        depth[next_id] = d
        waves.setdefault(d, []).append((next_id, left, right))
        next_id += 1
    nt = min(_os.cpu_count() or 1, 16)
    with ThreadPoolExecutor(nt) as pool:
        for d in sorted(waves):
            wave = waves[d]
            if len(wave) == 1 or nt == 1:
                for nid, left, right in wave:
                    nodes[nid] = do_merge(left, right)
            else:
                for nid, res in zip(
                        [w[0] for w in wave],
                        pool.map(lambda w: do_merge(w[1], w[2]), wave)):
                    nodes[nid] = res
    (rows_mat, _, order), = nodes.values()
    inv = np.argsort(order)
    rows_mat = rows_mat[inv]
    return ids, [bytes(r).decode("ascii") for r in rows_mat]
