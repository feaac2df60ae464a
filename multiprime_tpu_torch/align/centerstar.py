# Copied from multiprime_tpu/align/centerstar.py (host code, no JAX).
"""Center-star multiple alignment (MAFFT/MUSCLE replacement).

The reference shells out to ``mafft --auto`` (or muscle for singleton
clusters, run_mafft.py:66-72) purely to build the per-cluster MSA that the
window-design engine consumes.  This module provides a TPU-era stand-in:

* center selection by maximum summed k-mer similarity;
* global pairwise alignment of every member against the center, one
  vectorised DP row at a time (the within-row "gap in center" dependency is
  resolved with a prefix-max relaxation, so each row is pure vector ops);
* the classic center-star merge: per-center-position gap slots sized by the
  max insertion any pairwise alignment requires.

A center-star MSA is not column-identical to MAFFT's progressive alignment;
for bit-parity regression the pipeline ingests reference-produced .tmsa
files directly (pipeline stage ``align: external``).  The conserved windows
the design engine feeds on are stable across both.
"""

from __future__ import annotations

import numpy as np

from ..cluster.greedy import _encode, kmer_set

MATCH, MISMATCH, GAP = 2, -1, -2
GAP_OPEN, GAP_EXT = -4, -1

# the pairwise DP that served this process's last center_star_msa call:
# "native", "device", "numpy", or "none" for a single sequence
LAST_BACKEND = None
# pairs of the ragged k-mer pair expansion a chunk of
# _pairwise_intersections (bounds its memory)
_PAIR_CHUNK = 4_000_000


def _pairwise_intersections(sets):
    """Exact |set_i ∩ set_j| matrix for sorted-unique int arrays.

    Two regimes: homogeneous clusters have few distinct k-mers shared by
    many sequences (indicator matmul wins); diverse clusters have many
    k-mers each shared by few (group-pair bincount wins).  Both give the
    same exact integer counts as per-pair ``intersect1d``."""
    n = len(sets)
    lens = np.array([s.size for s in sets], np.int64)
    if n == 0 or lens.sum() == 0:
        return np.zeros((n, n), np.int64)
    all_k = np.concatenate(sets)
    owners = np.repeat(np.arange(n, dtype=np.int64), lens)
    uniq, col = np.unique(all_k, return_inverse=True)
    v = uniq.size
    if v <= 65536:
        ind = np.zeros((n, v), np.float32)
        ind[owners, col] = 1.0
        return (ind @ ind.T).astype(np.int64)
    order = np.argsort(all_k, kind="stable")   # owners ascend within groups
    ow = owners[order]
    gid = col[order]
    new = np.empty(len(ow), bool)
    new[0] = True
    new[1:] = gid[1:] != gid[:-1]
    start = np.flatnonzero(new)
    grp_of = np.cumsum(new) - 1
    rank = np.arange(len(ow)) - start[grp_of]
    inter = np.zeros(n * n, np.int64)
    # chunk the ragged pair expansion to bound memory (~4M pairs per chunk)
    cum = np.concatenate([[0], np.cumsum(rank)])
    total = int(cum[-1])
    step = _PAIR_CHUNK
    # a cut past the last group (the last step overshoots total) ends
    # where the groups do
    cuts = np.minimum(
        np.searchsorted(cum, np.arange(step, total + step, step)), len(ow))
    lo = 0
    for hi in np.unique(np.append(cuts, len(ow))):
        hi = int(hi)
        npairs = int(cum[hi] - cum[lo])
        if npairs:
            r = rank[lo:hi]
            rep = np.repeat(np.arange(lo, hi), r)
            within = np.arange(npairs) - np.repeat(
                (cum[lo:hi] - cum[lo]), r)
            earlier = rep - 1 - within
            flat = ow[earlier] * n + ow[rep]
            inter += np.bincount(flat, minlength=n * n)
        lo = hi
    mat = inter.reshape(n, n)
    mat = mat + mat.T
    mat[np.arange(n), np.arange(n)] = lens
    return mat


def pick_center(seqs, k=12, sample=200):
    """Index of the sequence with the largest summed k-mer Jaccard."""
    if len(seqs) == 1:
        return 0
    idx = list(range(len(seqs)))
    if len(idx) > sample:
        step = len(idx) / sample
        idx = sorted({int(i * step) for i in range(sample)})
    sets = {i: kmer_set(_encode(seqs[i]), k) for i in idx}
    inter = _pairwise_intersections([sets[i] for i in idx])
    sizes = {i: sets[i].size for i in idx}
    best, best_score = idx[0], -1.0
    for ii, i in enumerate(idx):
        score = 0.0
        for jj, j in enumerate(idx):
            if i == j:
                continue
            if sizes[i] and sizes[j]:
                cnt = int(inter[ii, jj])
                score += cnt / (sizes[i] + sizes[j] - cnt)
        if score > best_score:
            best, best_score = i, score
    return best


def align_ops(a, b, affine=True):
    """Global alignment op string between code arrays a (center) and b.

    Returns a list of ops: 'M' consumes one char of each, 'D' consumes only
    the center (gap in member), 'I' consumes only the member (gap in
    center).  Affine gaps (Gotoh) by default; each DP row is vectorised —
    the within-row left dependency of both the linear and the affine E
    matrix folds into a prefix-max relaxation.
    """
    if not affine:
        return _align_ops_linear(a, b)
    la, lb = len(a), len(b)
    if la == 0:
        return ["I"] * lb
    if lb == 0:
        return ["D"] * la
    NEG = np.int32(-1 << 28)
    jar = np.arange(lb + 1, dtype=np.int32)
    # V = best score, F = gap-in-b (vertical) state
    v_prev = np.empty(lb + 1, np.int32)
    v_prev[0] = 0
    v_prev[1:] = GAP_OPEN + GAP_EXT * jar[1:]
    f_prev = np.full(lb + 1, NEG, np.int32)
    # packed backpointers: 2 bits state ptr + flags for gap continuations
    ptr = np.zeros((la + 1, lb + 1), np.uint8)   # 0 diag, 1 up, 2 left
    fcont = np.zeros((la + 1, lb + 1), bool)     # F came from F (extend up)
    econt = np.zeros((la + 1, lb + 1), bool)     # E came from E (extend left)
    ptr[0, 1:] = 2
    econt[0, 2:] = True
    for i in range(1, la + 1):
        sub = np.where((b == a[i - 1]) & (a[i - 1] < 4), MATCH,
                       MISMATCH).astype(np.int32)
        f_cur = np.maximum(f_prev + GAP_EXT, v_prev + GAP_OPEN + GAP_EXT)
        fcont[i] = f_prev + GAP_EXT >= v_prev + GAP_OPEN + GAP_EXT
        diag = v_prev[:-1] + sub
        vert = np.empty(lb + 1, np.int32)
        vert[0] = f_cur[0]
        vert[1:] = np.maximum(diag, f_cur[1:])
        p = np.empty(lb + 1, np.uint8)
        p[0] = 1
        p[1:] = np.where(diag >= f_cur[1:], 0, 1)
        # E (gap in center): E[j] = max(E[j-1]+ext, V[j-1]+open+ext); with
        # t[j] = cand[j] - ext*j the recurrence is a running prefix max.
        t = vert + GAP_OPEN - GAP_EXT * jar      # candidate openings at j'
        run = np.maximum.accumulate(t[:-1])
        e_cur = np.full(lb + 1, NEG, np.int32)
        e_cur[1:] = run + GAP_EXT * jar[1:]
        # econt: E[j] extends an E (i.e. the opening was before j-1)
        open_here = vert[:-1] + GAP_OPEN - GAP_EXT * jar[:-1]
        econt[i, 1:] = open_here < run
        v_cur = np.maximum(vert, e_cur)
        p = np.where(e_cur > vert, 2, p).astype(np.uint8)
        ptr[i] = p
        v_prev, f_prev = v_cur, f_cur
    ops = []
    i, j = la, lb
    state = 0      # 0 main, 1 in-F, 2 in-E
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
            ops.append("M")
            i -= 1
            j -= 1
            state = 0
        elif m == 1:
            ops.append("D")
            state = 1 if fcont[i, j] else 0
            i -= 1
        else:
            ops.append("I")
            if i > 0 and j > 0:
                state = 2 if econt[i, j] else 0
            else:
                state = 0
            j -= 1
    ops.reverse()
    return ops


def _align_ops_linear(a, b):
    la, lb = len(a), len(b)
    if la == 0:
        return ["I"] * lb
    if lb == 0:
        return ["D"] * la
    jar = np.arange(lb + 1, dtype=np.int32)
    prev = (GAP * jar).astype(np.int32)
    ptr = np.zeros((la + 1, lb + 1), np.uint8)   # 0 diag, 1 up, 2 left
    ptr[0, 1:] = 2
    for i in range(1, la + 1):
        sub = np.where((b == a[i - 1]) & (a[i - 1] < 4), MATCH,
                       MISMATCH).astype(np.int32)
        vert = np.empty(lb + 1, np.int32)
        vert[0] = prev[0] + GAP
        diag = prev[:-1] + sub
        up = prev[1:] + GAP
        vert[1:] = np.maximum(diag, up)
        p = np.empty(lb + 1, np.uint8)
        p[0] = 1
        p[1:] = np.where(diag >= up, 0, 1)
        # gap-in-center (left) moves: dp[j] = max_{j'<=j} vert[j'] + GAP*(j-j')
        t = vert - GAP * jar
        cur = (np.maximum.accumulate(t) + GAP * jar).astype(np.int32)
        p = np.where(cur > vert, 2, p).astype(np.uint8)
        ptr[i] = p
        prev = cur
    ops = []
    i, j = la, lb
    while i > 0 or j > 0:
        if i == 0:
            m = 2
        elif j == 0:
            m = 1
        else:
            m = ptr[i, j]
        if m == 0:
            ops.append("M")
            i -= 1
            j -= 1
        elif m == 1:
            ops.append("D")
            i -= 1
        else:
            ops.append("I")
            j -= 1
    ops.reverse()
    return ops


def align_ops_batch(c, member_codes):
    """align_ops for many members at once: one vectorised row loop over
    [M, lb+1] state arrays (identical results to per-member align_ops)."""
    la = len(c)
    ms = len(member_codes)
    lbs = np.array([len(b) for b in member_codes])
    lb_max = int(lbs.max())
    bmat = np.full((ms, lb_max), 4, np.int8)
    for i, b in enumerate(member_codes):
        bmat[i, :len(b)] = b
    NEG = np.int32(-1 << 28)
    jar = np.arange(lb_max + 1, dtype=np.int32)
    valid = jar[None, :] <= lbs[:, None]
    v_prev = np.where(valid, GAP_OPEN + GAP_EXT * jar[None, :], NEG
                      ).astype(np.int32)
    v_prev[:, 0] = 0
    f_prev = np.full((ms, lb_max + 1), NEG, np.int32)
    ptr = np.zeros((la + 1, ms, lb_max + 1), np.uint8)
    fcont = np.zeros((la + 1, ms, lb_max + 1), bool)
    econt = np.zeros((la + 1, ms, lb_max + 1), bool)
    ptr[0, :, 1:] = 2
    econt[0, :, 2:] = True
    for i in range(1, la + 1):
        sub = np.where((bmat == c[i - 1]) & (c[i - 1] < 4), MATCH,
                       MISMATCH).astype(np.int32)
        f_cur = np.maximum(f_prev + GAP_EXT, v_prev + GAP_OPEN + GAP_EXT)
        fcont[i] = f_prev + GAP_EXT >= v_prev + GAP_OPEN + GAP_EXT
        diag = v_prev[:, :-1] + sub
        vert = np.empty_like(v_prev)
        vert[:, 0] = f_cur[:, 0]
        vert[:, 1:] = np.maximum(diag, f_cur[:, 1:])
        p = np.empty_like(ptr[0])
        p[:, 0] = 1
        p[:, 1:] = np.where(diag >= f_cur[:, 1:], 0, 1)
        t = vert + GAP_OPEN - GAP_EXT * jar[None, :]
        run = np.maximum.accumulate(t[:, :-1], axis=1)
        e_cur = np.full_like(v_prev, NEG)
        e_cur[:, 1:] = run + GAP_EXT * jar[None, 1:]
        open_here = vert[:, :-1] + GAP_OPEN - GAP_EXT * jar[None, :-1]
        econt[i, :, 1:] = open_here < run
        v_cur = np.where(valid, np.maximum(vert, e_cur), NEG)
        p = np.where(e_cur > vert, 2, p).astype(np.uint8)
        ptr[i] = p
        v_prev, f_prev = v_cur, np.where(valid, f_cur, NEG)
    out = []
    for mi in range(ms):
        ops = []
        i, j = la, int(lbs[mi])
        state = 0
        while i > 0 or j > 0:
            if i == 0:
                mv = 2
            elif j == 0:
                mv = 1
            elif state == 1:
                mv = 1
            elif state == 2:
                mv = 2
            else:
                mv = ptr[i, mi, j]
            if mv == 0:
                ops.append("M")
                i -= 1
                j -= 1
                state = 0
            elif mv == 1:
                ops.append("D")
                state = 1 if fcont[i, mi, j] else 0
                i -= 1
            else:
                ops.append("I")
                if i > 0 and j > 0:
                    state = 2 if econt[i, mi, j] else 0
                else:
                    state = 0
                j -= 1
        ops.reverse()
        out.append(ops)
    return out


def _use_device_backend(backend, n_members, la, device="cuda"):
    """Whether the device DP (align/device.py) serves this alignment:
    always for "device"; for "auto" (after native) when ``device`` is a
    CUDA device and the pointer tensor is large (n_members * la of at
    least 512 * 1024), the JAX package's size rule; never otherwise."""
    if backend == "device":
        return True
    if backend != "auto" or n_members * la < 512 * 1024:
        return False
    import torch
    return torch.device(device).type == "cuda"


def center_star_msa(ids, seqs, backend="auto", device="cuda"):
    """-> (ids, aligned rows as equal-length strings).

    ``backend``: "numpy" = vectorised host row loop, "native" = the
    threaded C++ Gotoh (native/seqlib.cpp gotoh_ops_batch), "device" = the
    jax scan DP + on-device backtrace (align/device.py), "auto" prefers
    native, then the device path per :func:`_use_device_backend`, then
    NumPy.  All produce identical op strings, so the MSA is
    backend-invariant.  ``device`` is the torch device of the device DP
    (default cuda; raises without a GPU).  ``LAST_BACKEND`` names the DP
    that served the call ("none" for a single sequence).
    """
    global LAST_BACKEND
    if len(seqs) == 1:
        LAST_BACKEND = "none"
        return ids, [seqs[0]]
    center = pick_center(seqs)
    codes = [_encode(s) for s in seqs]
    c = codes[center]
    member_idx = [m for m in range(len(seqs)) if m != center]
    per_member = [None] * len(seqs)
    if backend in ("auto", "native"):
        # The threaded C++ Gotoh wins at every measured shape (499 x 1.9 kb:
        # 7.1 s native vs 15.6+ s NumPy vs >600 s CPU-XLA device), so
        # "auto" tries it before the device policy; "native" falls through
        # to NumPy when the toolchain is missing.
        from .. import native
        fmat = native.gotoh_ops_batch(c, [codes[m] for m in member_idx])
        if fmat is not None:
            LAST_BACKEND = "native"
            rows = _merge_rows_vec(seqs, center, member_idx, fmat)
            assert len({len(r) for r in rows}) == 1
            return ids, rows
    if _use_device_backend(backend, len(member_idx), len(c), device):
        from .device import align_ops_batch_device
        fmat = align_ops_batch_device(c, [codes[m] for m in member_idx],
                                      as_codes=True, device=device)
        LAST_BACKEND = "device"
        rows = _merge_rows_vec(seqs, center, member_idx, fmat)
        assert len({len(r) for r in rows}) == 1
        return ids, rows
    LAST_BACKEND = "numpy"
    # Chunk so the [la, M, lb] pointer tensors stay within ~1 GB.
    lb_max = max(len(codes[m]) for m in member_idx)
    chunk = max(1, int(1e9 // max((len(c) + 1) * (lb_max + 1) * 3, 1)))
    for lo in range(0, len(member_idx), chunk):
        part = member_idx[lo:lo + chunk]
        batch = align_ops_batch(c, [codes[m] for m in part])
        for m, ops in zip(part, batch):
            per_member[m] = ops
    fmat = _ops_to_code_matrix([per_member[m] for m in member_idx])
    rows = _merge_rows_vec(seqs, center, member_idx, fmat)
    assert len({len(r) for r in rows}) == 1
    return ids, rows


_OP_CODE = np.full(256, 3, np.uint8)
_OP_CODE[ord("M")] = 0
_OP_CODE[ord("D")] = 1
_OP_CODE[ord("I")] = 2


def _ops_to_code_matrix(per_member_ops):
    """Char-op lists -> forward uint8 code matrix [M, S] (0=M,1=D,2=I,3=pad,
    pads at the end of each row)."""
    m = len(per_member_ops)
    smax = max((len(o) for o in per_member_ops), default=0)
    fmat = np.full((m, smax), 3, np.uint8)
    for i, ops in enumerate(per_member_ops):
        fmat[i, :len(ops)] = _OP_CODE[
            np.frombuffer("".join(ops).encode("ascii"), np.uint8)]
    return fmat


def _merge_rows_scalar(seqs, center, member_idx, per_member):
    """Reference per-op merge loop (oracle for _merge_rows_vec)."""
    la = len(seqs[center])
    slot = np.zeros(la + 1, np.int64)
    for ops in per_member:
        if ops is None:
            continue
        ci = run = 0
        for op in ops:
            if op == "I":
                run += 1
            else:
                slot[ci] = max(slot[ci], run)
                run = 0
                ci += 1
        slot[la] = max(slot[la], run)
    rows = []
    center_chars = []
    for i in range(la):
        center_chars.append("-" * int(slot[i]))
        center_chars.append(seqs[center][i])
    center_chars.append("-" * int(slot[la]))
    center_row = "".join(center_chars)
    for m in range(len(seqs)):
        if m == center:
            rows.append(center_row)
            continue
        ops = per_member[m]
        out = []
        mi = ci = 0
        run = []
        for op in ops:
            if op == "I":
                run.append(seqs[m][mi])
                mi += 1
            else:
                out.append("".join(run) + "-" * int(slot[ci] - len(run)))
                run = []
                if op == "M":
                    out.append(seqs[m][mi])
                    mi += 1
                else:
                    out.append("-")
                ci += 1
        out.append("".join(run) + "-" * int(slot[la] - len(run)))
        rows.append("".join(out))
    return rows


def _merge_rows_vec(seqs, center, member_idx, fmat):
    """Vectorised center-star merge.

    ``fmat`` [M, S]: forward op codes per member (0=M, 1=D, 2=I, 3=pad).
    Every member has exactly ``la`` non-I ops (each M/D consumes one center
    position), so the non-I positions form a dense [M, la] matrix and the
    whole merge — slot sizing, run placement, residue scatter — is a handful
    of NumPy gathers instead of a per-op Python walk."""
    la = len(seqs[center])
    m, s = fmat.shape
    is_real = fmat != 3
    non_i = is_real & (fmat != 2)
    consume = (fmat == 0) | (fmat == 2)        # M and I eat a member residue
    n_real = is_real.sum(axis=1)
    # int32 throughout: op/column counts are far below 2**31 and the int32
    # boolean cumsum is ~5x the int64 one
    kmat = np.cumsum(non_i, axis=1, dtype=np.int32) - 1
    rows_, cols_ = np.nonzero(non_i)
    pmat = np.full((m, la), -1, np.int32)
    pmat[rows_, kmat[rows_, cols_]] = cols_
    pfull = np.concatenate([np.full((m, 1), -1, np.int32), pmat], axis=1)
    runs = pmat - pfull[:, :-1] - 1            # I-run before each center pos
    trail = n_real - 1 - pmat[:, la - 1]
    slot = np.zeros(la + 1, np.int64)
    if m:
        slot[:la] = runs.max(axis=0)
        slot[la] = trail.max()
    off = np.zeros(la + 1, np.int64)
    off[1:] = np.cumsum(slot[:la] + 1)
    row_len = int(off[la] + slot[la])
    out = np.full((m, row_len), ord("-"), np.uint8)
    lbs = np.array([len(seqs[mm]) for mm in member_idx], np.int64)
    seq_mat = np.zeros((m, int(lbs.max()) if m else 1), np.uint8)
    for i, mm in enumerate(member_idx):
        seq_mat[i, :lbs[i]] = np.frombuffer(
            seqs[mm].encode("ascii"), np.uint8)
    mi = np.cumsum(consume, axis=1, dtype=np.int32) - 1
    mr, mc = np.nonzero(fmat == 0)             # M ops -> center column
    k_m = kmat[mr, mc]
    out[mr, off[k_m] + slot[k_m]] = seq_mat[mr, mi[mr, mc]]
    ir, ic = np.nonzero(fmat == 2)             # I ops -> left-aligned in slot
    q = kmat[ir, ic] + 1                       # next center position index
    prev = pfull[ir, q]
    out[ir, off[q] + (ic - prev - 1)] = seq_mat[ir, mi[ir, ic]]
    center_chars = []
    for i in range(la):
        center_chars.append("-" * int(slot[i]))
        center_chars.append(seqs[center][i])
    center_chars.append("-" * int(slot[la]))
    blob = out.tobytes().decode("latin-1")
    rows = [None] * len(seqs)
    rows[center] = "".join(center_chars)
    for i, mm in enumerate(member_idx):
        rows[mm] = blob[i * row_len:(i + 1) * row_len]
    return rows


def write_msa(ids, rows, path, width=60):
    with open(path, "w") as f:
        for i, r in zip(ids, rows):
            f.write(">" + i.lstrip(">") + "\n")
            for off in range(0, len(r), width):
                f.write(r[off:off + width] + "\n")
