"""Plain references of the center-star pairwise alignment that fit at genome
length: the DP of ``gotoh.py`` (the same scores and tie rules), a row of
the center at a time over every member at once, with its pointers packed
into one byte a cell and kept only for the members asked for, so that
member blocks of 8.3 kb genomes fit the card; and the optimum score of
every member, from the same row DP without pointers.

Ops come back as forward codes as in ``gotoh.py``: 0 = both advance, 1 = a
gap in the member, 2 = a gap in the center.
"""

import numpy as np
import torch

from .gotoh import GAP_EXT, GAP_OPEN, MATCH, MISMATCH, NEG

# the packed pointer byte: the move (0 diag, 1 up, 2 left) | an up-gap
# extends << 2 | a left-gap extends << 3
_FCONT, _ECONT = 4, 8


def dp(c, members, device, keep=()):
    """The row DP of every member against the center ``c`` -> (the optimum
    score of each member, int64 [M]; the packed pointers of the members
    ``keep``, uint8 [la + 1, len(keep), lb + 1] on the host, or None)."""
    dev = torch.device(device)
    m, la = len(members), len(c)
    lens = torch.tensor([len(b) for b in members], dtype=torch.int64,
                        device=dev)
    lb = max(int(lens.max()), 1)
    bmat = np.full((m, lb), 5, np.int64)        # 5: padding, never a match
    for k, b in enumerate(members):
        bmat[k, :len(b)] = b
    bmat = torch.from_numpy(bmat).to(torch.int32).to(dev)
    jar = torch.arange(lb + 1, device=dev, dtype=torch.int32)
    v_prev = (GAP_OPEN + GAP_EXT * jar).expand(m, lb + 1).clone()
    v_prev[:, 0] = 0
    f_prev = torch.full((m, lb + 1), NEG, dtype=torch.int32, device=dev)
    neg = torch.full((m, 1), NEG, dtype=torch.int32, device=dev)
    ones = torch.ones((m, 1), dtype=torch.uint8, device=dev)
    keep = torch.as_tensor(list(keep), dtype=torch.int64, device=dev)
    ptr = None
    if len(keep):
        ptr = torch.empty((la + 1, len(keep), lb + 1), dtype=torch.uint8,
                          device=dev)
        ptr[0] = 2 + _ECONT * (jar >= 2).to(torch.uint8)
        ptr[0, :, 0] = 0
    matches = [(bmat == a).to(torch.int32) * (MATCH - MISMATCH) + MISMATCH
               for a in range(4)]
    mismatch = torch.full_like(bmat, MISMATCH)
    open_j = GAP_OPEN - GAP_EXT * jar        # t's offset at column j
    ext_j = GAP_EXT * jar[1:]                # E's drift to column j
    for i in range(1, la + 1):
        a = int(c[i - 1])
        sub = matches[a] if a < 4 else mismatch
        f_ext = f_prev + GAP_EXT
        f_open = v_prev + (GAP_OPEN + GAP_EXT)
        f_cur = torch.maximum(f_ext, f_open)
        diag = v_prev[:, :-1] + sub
        vert = torch.cat([f_cur[:, :1], torch.maximum(diag, f_cur[:, 1:])],
                         dim=1)
        t = vert + open_j
        run = torch.cummax(t[:, :-1], dim=1).values
        e_cur = torch.cat([neg, run + ext_j], dim=1)
        if ptr is not None:
            p = torch.cat([ones, (diag < f_cur[:, 1:]).to(torch.uint8)],
                          dim=1)
            p = torch.where(e_cur > vert, 2, p)
            p |= (f_ext >= f_open).to(torch.uint8) * _FCONT
            p[:, 1:] |= (t[:, :-1] < run).to(torch.uint8) * _ECONT
            ptr[i] = p[keep]
        v_prev = torch.maximum(vert, e_cur)
        f_prev = f_cur
    scores = v_prev.gather(1, lens[:, None])[:, 0].cpu().numpy()
    return scores, None if ptr is None else ptr.cpu().numpy()


def trace(ptr, la, lens):
    """Packed pointers [la + 1, K, lb + 1] and the K members' lengths ->
    their forward op-code arrays (uint8), walked on the host."""
    k = ptr.shape[1]
    rows = np.arange(k)
    i = np.full(k, la, np.int64)
    j = np.asarray(lens, np.int64).copy()
    state = np.zeros(k, np.int64)
    ops = np.full((k, la + (int(j.max()) if k else 0)), 3, np.uint8)
    n = np.zeros(k, np.int64)
    while True:
        live = (i > 0) | (j > 0)
        if not live.any():
            break
        b = ptr[i, rows, j].astype(np.int64)
        op = np.where(i == 0, 2, np.where(
            j == 0, 1, np.where(state == 1, 1, np.where(
                state == 2, 2, b & 3))))
        op = np.where(live, op, 3)
        ops[rows[live], n[live]] = op[live]
        n += live
        diag, up, left = op == 0, op == 1, op == 2
        state = np.where(diag, 0, np.where(
            up, (b & _FCONT) // _FCONT, np.where(
                left, np.where((i > 0) & (j > 0) & ((b & _ECONT) > 0), 2, 0),
                state)))
        i = i - (diag | up)
        j = j - (diag | left)
    return [ops[r, :n[r]][::-1].copy() for r in range(k)]


def members_fitting(la, lb, ptr_bytes):
    """Members whose packed pointers fit ``ptr_bytes`` (at least one)."""
    return max(1, int(ptr_bytes // ((la + 1) * (lb + 1))))


def align(c, members, device, ptr_bytes=8 << 30):
    """Forward op-code arrays of every member, in member blocks whose
    packed pointers fit ``ptr_bytes``."""
    c = np.asarray(c, np.int64)
    if len(c) == 0 or not members:
        return [np.full(len(b), 2, np.uint8) for b in members]
    lb = max(max(len(b) for b in members), 1)
    step = members_fitting(len(c), lb, ptr_bytes)
    out = []
    for lo in range(0, len(members), step):
        part = members[lo:lo + step]
        _, ptr = dp(c, part, device, keep=range(len(part)))
        out += trace(ptr, len(c), [len(b) for b in part])
    return out


def ops_score(c, b, ops):
    """The score of one alignment path: forward ops of member ``b`` against
    the center ``c`` (match 2, mismatch -1, a non-base never matches, a gap
    of k -4 - k); None where the ops do not consume both sequences."""
    ops = np.asarray(ops, np.int64)
    c = np.asarray(c, np.int64)
    b = np.asarray(b, np.int64)
    if ((ops == 0) | (ops == 1)).sum() != len(c) \
            or ((ops == 0) | (ops == 2)).sum() != len(b) or (ops > 2).any():
        return None
    ci = np.cumsum((ops == 0) | (ops == 1)) - 1
    bi = np.cumsum((ops == 0) | (ops == 2)) - 1
    diag = ops == 0
    ca, bb = c[ci[diag]], b[bi[diag]]
    score = int(np.where((ca == bb) & (ca < 4), MATCH, MISMATCH).sum())
    gap = ops > 0
    opens = gap & np.concatenate([[True], ops[1:] != ops[:-1]])
    return score + GAP_OPEN * int(opens.sum()) + GAP_EXT * int(gap.sum())
