"""Plain reference of the center-star pairwise alignment: the affine-gap
(Gotoh) global alignment of each member against the center, with the tie
rules of the port's host path (align/centerstar.py align_ops): match 2,
mismatch -1 (a non-base never matches), a gap of length k costs -4 - k.

The DP runs a row of the center at a time over every member at once, on
any torch device; the traceback follows the pointers on the host.  Ops
come back as forward codes: 0 = both advance, 1 = a gap in the member,
2 = a gap in the center.
"""

import numpy as np
import torch

MATCH, MISMATCH = 2, -1
GAP_OPEN, GAP_EXT = -4, -1
NEG = -(1 << 28)
_CODE = np.full(256, 4, np.int64)
for _i, _ch in enumerate(b"ACGT"):
    _CODE[_ch] = _i
_CHARS = np.frombuffer(b"ACGTN", np.uint8)


def encode(seq):
    """A sequence -> int64 codes (A, C, G, T = 0..3, anything else 4)."""
    return _CODE[np.frombuffer(seq.encode("ascii"), np.uint8)]


def decode(codes):
    return _CHARS[np.minimum(np.asarray(codes, np.int64), 4)].tobytes(
        ).decode("ascii")


def _pointers(c, members, device):
    """The DP's pointers for every member: ptr [la + 1, M, lb + 1] (0 diag,
    1 up, 2 left), fcont and econt (a gap extends) of the same shape."""
    dev = torch.device(device)
    m = len(members)
    la = len(c)
    lb = max(len(b) for b in members)
    bmat = np.full((m, lb), 5, np.int64)        # 5: padding, never a match
    for k, b in enumerate(members):
        bmat[k, :len(b)] = b
    bmat = torch.from_numpy(bmat).to(dev)
    jar = torch.arange(lb + 1, device=dev, dtype=torch.int64)
    v_prev = (GAP_OPEN + GAP_EXT * jar).expand(m, lb + 1).clone()
    v_prev[:, 0] = 0
    f_prev = torch.full((m, lb + 1), NEG, dtype=torch.int64, device=dev)
    ptr = torch.zeros((la + 1, m, lb + 1), dtype=torch.uint8, device=dev)
    fcont = torch.zeros((la + 1, m, lb + 1), dtype=torch.bool, device=dev)
    econt = torch.zeros((la + 1, m, lb + 1), dtype=torch.bool, device=dev)
    ptr[0, :, 1:] = 2
    econt[0, :, 2:] = True
    ones = torch.ones((m, 1), dtype=torch.uint8, device=dev)
    neg = torch.full((m, 1), NEG, dtype=torch.int64, device=dev)
    for i in range(1, la + 1):
        a = int(c[i - 1])
        sub = torch.where((bmat == a) & (a < 4), MATCH, MISMATCH)
        f_ext = f_prev + GAP_EXT
        f_open = v_prev + GAP_OPEN + GAP_EXT
        f_cur = torch.maximum(f_ext, f_open)
        fcont[i] = f_ext >= f_open
        diag = v_prev[:, :-1] + sub
        vert = torch.cat([f_cur[:, :1], torch.maximum(diag, f_cur[:, 1:])],
                         dim=1)
        p = torch.cat([ones, (diag < f_cur[:, 1:]).to(torch.uint8)], dim=1)
        t = vert + GAP_OPEN - GAP_EXT * jar
        run = torch.cummax(t[:, :-1], dim=1).values
        e_cur = torch.cat([neg, run + GAP_EXT * jar[1:]], dim=1)
        econt[i, :, 1:] = t[:, :-1] < run
        v_prev = torch.maximum(vert, e_cur)
        ptr[i] = torch.where(e_cur > vert, 2, p)
        f_prev = f_cur
    return ptr.cpu().numpy(), fcont.cpu().numpy(), econt.cpu().numpy()


def align(c, members, device):
    """c: codes of the center; members: list of code arrays -> list of
    forward op-code arrays (uint8), one a member."""
    la = len(c)
    if la == 0 or not members:
        return [np.full(len(b), 2, np.uint8) for b in members]
    ptr, fcont, econt = _pointers(np.asarray(c, np.int64), members, device)
    m = len(members)
    rows = np.arange(m)
    i = np.full(m, la, np.int64)
    j = np.array([len(b) for b in members], np.int64)
    state = np.zeros(m, np.int64)
    ops = np.full((m, la + j.max()), 3, np.uint8)
    n = np.zeros(m, np.int64)
    while True:
        live = (i > 0) | (j > 0)
        if not live.any():
            break
        op = np.where(i == 0, 2, np.where(
            j == 0, 1, np.where(state == 1, 1, np.where(
                state == 2, 2, ptr[i, rows, j]))))
        op = np.where(live, op, 3)
        ops[rows[live], n[live]] = op[live]
        n += live
        fc = fcont[i, rows, j]
        ec = econt[i, rows, j]
        diag, up, left = op == 0, op == 1, op == 2
        state = np.where(diag, 0, np.where(
            up, fc.astype(np.int64), np.where(
                left, np.where((i > 0) & (j > 0) & ec, 2, 0), state)))
        i = i - (diag | up)
        j = j - (diag | left)
    return [ops[k, :n[k]][::-1].copy() for k in range(m)]
