"""Plain reference of the center-star MSA and its polish: the merge of the
members' pairwise ops against the center into one alignment, then the
profile-realignment passes (each member's residues placed back into the
fixed columns by a two-state DP against the profile of the other rows, a
pass kept only where the column-agreement score rises, all-gap columns
dropped), with the rules and the float32 rounding of the port's host pass
(align/refine.py ``refine_msa``).

The column DP runs in float32 a column at a time over a block of members
on any torch device, its pointers (one byte a cell) on the device, in
member blocks whose pointers fit ``ptr_bytes``; the trace runs there too,
a column a step over the block.
"""

import numpy as np
import torch

GAP_OPEN = -4.0     # opening a skip run, scaled by the column's occupancy
GAP_EXT = -1.0      # each skipped column, scaled by its occupancy
NEG = -1e30
_GAP, _OTHER = 4, 5
_CODE = np.full(256, _OTHER, np.int64)
_CODE[ord("-")] = _GAP
for _i, _ch in enumerate(b"ACGT"):
    _CODE[_ch] = _i


# -- the center-star merge ----------------------------------------------------

def merge(center, members, ops):
    """The center-star MSA: the center's row, then each member's, as uint8
    ASCII [1 + M, width].  ``center`` and ``members`` are byte strings;
    ``ops`` forward op codes a member (0 both advance, 1 a gap in the member,
    2 a gap in the center).  Before each center base, and after the last,
    a slot as wide as the longest run of center gaps any member puts there;
    a member's run sits at the left of its slot."""
    la = len(center)
    slot = np.zeros(la + 1, np.int64)
    starts = []
    for o in ops:
        o = np.asarray(o)
        at = np.flatnonzero(o != 2)           # the op of each center base
        runs = np.diff(np.concatenate([[-1], at])) - 1
        slot[:la] = np.maximum(slot[:la], runs)
        slot[la] = max(slot[la], len(o) - 1 - (at[-1] if la else -1))
        starts.append(at)
    off = np.concatenate([[0], np.cumsum(slot[:la] + 1)])
    width = int(off[la] + slot[la])
    out = np.full((1 + len(members), width), ord("-"), np.uint8)
    out[0, off[:la] + slot[:la]] = np.frombuffer(center, np.uint8)
    for k, (seq, o, at) in enumerate(zip(members, ops, starts)):
        o = np.asarray(o)
        seq = np.frombuffer(seq, np.uint8)
        # the center base before each op (-1 before the first)
        before = np.cumsum(o != 2) - 1
        col = np.where(o == 2, 0, off[np.maximum(before, 0)]
                       + slot[np.maximum(before, 0)])
        # a center gap: its slot (the next center base's), at its rank
        nxt = before + 1
        prev_op = np.where(nxt > 0, at[np.maximum(nxt - 1, 0)], -1)
        ins = o == 2
        col[ins] = off[nxt[ins]] + (np.arange(len(o))[ins] - prev_op[ins] - 1)
        eats = (o == 0) | (o == 2)
        out[1 + k, col[eats]] = seq
    return out


# -- the polish ---------------------------------------------------------------

def codes(mat):
    """uint8 ASCII rows [M, C] -> codes (A, C, G, T = 0..3, gap 4, other 5)."""
    return _CODE[mat]


def agreement(mat):
    """Sum over columns of each base's count squared."""
    cd = codes(mat)
    return int(sum(((cd == b).sum(axis=0).astype(np.int64) ** 2).sum()
                   for b in range(4)))


def drop_gap_columns(mat):
    keep = (mat != ord("-")).any(axis=0)
    return mat if keep.all() else np.ascontiguousarray(mat[:, keep])


def _block_pass(cd, counts, denom, sel, device):
    """The new placed column of each residue of the members ``sel`` ->
    int64 [len(sel), lmax] (-1 past a member's residues)."""
    dev = torch.device(device)
    mine = cd[sel]                                         # [mb, C]
    mb, c = mine.shape
    res = mine != _GAP
    lens = res.sum(axis=1)
    lmax = max(int(lens.max()), 1)
    rank = np.cumsum(res, axis=1) - 1
    rcodes = np.full((mb, lmax), _OTHER, np.int64)
    rr, cc = np.nonzero(res)
    rcodes[rr, rank[rr, cc]] = mine[rr, cc]
    # the profile of the other rows, in NumPy float32 as the host pass
    # rounds it (a CUDA tensor divided by a number is multiplied by its
    # reciprocal, which rounds otherwise)
    cnt = counts[None] - np.eye(6, dtype=np.float32)[mine]    # [mb, C, 6]
    f6 = cnt / np.float32(denom)
    f6[:, :, 4:] = 0.0
    occ = np.float32(1.0) - cnt[:, :, 4] / np.float32(denom)  # [mb, C]
    f6 = torch.from_numpy(np.ascontiguousarray(f6.transpose(1, 0, 2))).to(
        dev)                                               # [C, mb, 6]
    occ = torch.from_numpy(np.ascontiguousarray(occ.T)).to(dev)
    # each column's terms, scaled once: 2 * (2 f - occ) = 4 f - 2 occ and
    # the gap terms exactly (scaling by a power of two rounds nothing)
    s4, occ2 = 4.0 * f6, 2.0 * occ
    go, ge = GAP_OPEN * occ, GAP_EXT * occ
    rc = torch.from_numpy(rcodes).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    iar = torch.arange(lmax + 1, device=dev)
    active = iar[None, :] <= lens_t[:, None]
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    v = torch.full((mb, lmax + 1), NEG, dtype=torch.float32, device=dev)
    v[:, 0] = 0.0
    g = torch.full((mb, lmax + 1), NEG, dtype=torch.float32, device=dev)
    best_v = torch.full((mb,), NEG, dtype=torch.float32, device=dev)
    best_j = torch.zeros(mb, dtype=torch.int64, device=dev)
    ptr = torch.zeros((c + 1, mb, lmax + 1), dtype=torch.uint8, device=dev)
    rows = torch.arange(mb, device=dev)
    for j in range(1, c + 1):
        s = torch.gather(s4[j - 1], 1, rc) - occ2[j - 1][:, None]
        open_ = v + go[j - 1][:, None]
        gcont = g >= open_
        g_new = torch.maximum(g, open_) + ge[j - 1][:, None]
        diag = torch.cat([neg.expand(mb, 1), v[:, :-1] + s], dim=1)
        skip = g_new > diag
        v_new = torch.where(skip, g_new, diag)
        v_new[:, 0] = 0.0
        v = torch.where(active, v_new, neg)
        g = torch.where(active, g_new, neg)
        ptr[j] = skip.to(torch.uint8) | (gcont.to(torch.uint8) << 1)
        end = v[rows, lens_t]
        better = end > best_v
        best_v = torch.where(better, end, best_v)
        best_j = torch.where(better, j, best_j)
    # the trace: from (lens, best_j) back to the first residue
    i, j = lens_t.clone(), best_j
    skipping = torch.zeros(mb, dtype=torch.bool, device=dev)
    placed = torch.full((mb, lmax), -1, dtype=torch.int64, device=dev)
    for _ in range(c):
        live = i > 0
        p = ptr[j, rows, i].to(torch.int64)
        take = live & (j > i) & (skipping | ((p & 1) == 1))
        put = live & ~take
        at = (i - 1).clamp(min=0)
        placed[rows, at] = torch.where(put, j - 1, placed[rows, at])
        skipping = take & ((p & 2) == 2)
        i = torch.where(put, i - 1, i)
        j = torch.where(live, j - 1, j)
    return placed.cpu().numpy(), lens


def refine_pass(mat, device, ptr_bytes=24 << 30):
    """One pass over every member of uint8 ASCII rows [M, C] -> new rows
    (each member's residues in order, in possibly other columns)."""
    m, c = mat.shape
    if m < 2:
        return mat.copy()
    cd = codes(mat)
    counts = np.stack([(cd == v).sum(axis=0) for v in range(6)],
                      axis=1).astype(np.float32)            # [C, 6]
    denom = max(m - 1, 1)
    lmax = max(int((cd != _GAP).sum(axis=1).max()), 1)
    step = max(1, int(ptr_bytes // ((c + 1) * (lmax + 1))))
    out = np.full_like(mat, ord("-"))
    for lo in range(0, m, step):
        sel = np.arange(lo, min(lo + step, m))
        placed, lens = _block_pass(cd, counts, denom, sel, device)
        for k, r in enumerate(sel):
            chars = mat[r][cd[r] != _GAP]
            out[r, placed[k, :lens[k]]] = chars
    return out


def refine(mat, passes, device, ptr_bytes=24 << 30):
    """-> (the polished MSA of uint8 ASCII rows [M, C], the passes kept):
    all-gap columns dropped, then up to ``passes`` passes, each kept only
    where the agreement rises (the first that does not ends the polish)."""
    if mat.shape[0] < 2 or passes <= 0:
        return mat, 0
    cur = drop_gap_columns(mat)
    q = agreement(cur)
    kept = 0
    for _ in range(passes):
        cand = drop_gap_columns(refine_pass(cur, device, ptr_bytes))
        q_new = agreement(cand)
        if q_new <= q:
            break
        cur, q = cand, q_new
        kept += 1
    return cur, kept
