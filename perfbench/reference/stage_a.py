"""Plain reference of design Stage A: for every primer-length window of an
MSA, the gap-patched windows, the base frequencies and nearest-neighbour
transitions weighted by IUPAC expansion multiplicity, the cover and gap
counts and the Viterbi consensus (multiPrime-core.py:579-593, 666-687).

A frozen copy of the plain PyTorch versions the port keeps beside its
Stage-A kernels, so that a later change to the port cannot change the
yardstick; it runs on any torch device.
"""

import numpy as np
import torch

from . import iupac

_POP = np.array([bin(i).count("1") for i in range(16)], dtype=np.int64)
_MC = np.maximum(_POP, 1)            # a gap expands to itself: 1 member
_CHUNK_ELEMS = 1 << 25
_KEEP = np.full(256, ord("-"), np.uint8)
for _b in b"ACGTRYMKSWHBVD":
    _KEEP[_b] = _b


def read_msa_masks(path):
    """An MSA FASTA -> uint8 masks [N, L]: rows uppercased, every character
    outside ACGTRYMKSWHBVD a gap (N too), lines starting with '#' skipped."""
    rows, cur = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            if line.startswith(">"):
                if cur:
                    rows.append("".join(cur))
                cur = []
            else:
                cur.append(line.strip().upper())
    if cur:
        rows.append("".join(cur))
    chars = np.stack([np.frombuffer(r.encode("ascii"), np.uint8)
                      for r in rows])
    return iupac.ASCII_TO_MASK[_KEEP[chars]]


def patch_windows(masks, positions, plen):
    """masks int [N, L], positions int [W] -> patched windows [N, W, plen]."""
    dev = masks.device
    masks = masks.to(torch.int32)
    positions = positions.to(torch.int64)
    n, length = masks.shape
    nz = masks != 0
    pos = torch.arange(length, device=dev)
    cs = torch.cumsum(nz, dim=1)
    before = torch.cat([torch.zeros((n, 1), dtype=cs.dtype, device=dev),
                        cs[:, :-1]], dim=1)
    total = cs[:, -1]
    nxt = torch.where(nz, pos, length)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    run_from = nxt - pos
    prv = torch.cummax(torch.where(nz, pos, -1), dim=1).values
    run_to = pos - prv
    packed = torch.zeros((n, length + 1), dtype=masks.dtype, device=dev)
    packed.scatter_(1, torch.where(nz, before, length),
                    torch.where(nz, masks, 0))
    packed = packed[:, :length]
    j = torch.arange(plen, device=dev)
    last = positions + plen - 1
    win = masks[:, positions[:, None] + j[None, :]]
    lead = run_from[:, positions].clamp(max=plen)
    trail = run_to[:, last].clamp(max=plen)
    allgap = lead >= plen
    c_start = before[:, positions]
    c_end = before[:, last] + nz[:, last]
    use_lead = ~allgap & (lead > 0) & (c_start >= lead)
    use_trail = ~allgap & (trail > 0) & ((total[:, None] - c_end) >= trail)
    lead_idx = (c_start[:, :, None] - lead[:, :, None] + j).clamp(
        0, length - 1)
    lead_vals = torch.gather(packed, 1, lead_idx.reshape(n, -1)).reshape(
        win.shape)
    win = torch.where(use_lead[:, :, None] & (j < lead[:, :, None]),
                      lead_vals, win)
    trail_off = j - (plen - trail[:, :, None])
    trail_idx = (c_end[:, :, None] + trail_off).clamp(0, length - 1)
    trail_vals = torch.gather(packed, 1, trail_idx.reshape(n, -1)).reshape(
        win.shape)
    return torch.where(use_trail[:, :, None] & (trail_off >= 0), trail_vals,
                       win)


def window_stats(win, variation):
    """Patched windows [N, W, plen] -> freq [W, plen, 4], nn [W, plen-1, 4,
    4], cover_number [W], gap_number [W] (int64)."""
    dev = win.device
    win = win.to(torch.int64)
    n, w, plen = win.shape
    mc = torch.as_tensor(_MC, device=dev)[win]
    is_gap = (win == 0).sum(dim=2) > variation
    alive = ~is_gap
    total_exp = torch.prod(mc, dim=2)
    w_pos = torch.where(alive[:, :, None], total_exp[:, :, None] // mc, 0)
    pair_mc = mc[:, :, :-1] * mc[:, :, 1:]
    w_pair = torch.where(alive[:, :, None],
                         total_exp[:, :, None] // pair_mc, 0)
    bits = torch.arange(4, device=dev)
    freq = torch.zeros((w, plen, 4), dtype=torch.int64, device=dev)
    nn = torch.zeros((w, plen - 1, 4, 4), dtype=torch.int64, device=dev)
    step = max(1, _CHUNK_ELEMS // max(w * plen * 4, 1))
    for lo in range(0, n, step):
        member = (win[lo:lo + step, :, :, None] >> bits) & 1
        freq += (w_pos[lo:lo + step, :, :, None] * member).sum(dim=0)
        for a in range(4):
            left = w_pair[lo:lo + step] * member[:, :, :-1, a]
            nn[:, :, a, :] += (left[:, :, :, None]
                               * member[:, :, 1:, :]).sum(dim=0)
    return {"freq": freq, "nn": nn, "cover_number": alive.sum(dim=0),
            "gap_number": is_gap.sum(dim=0)}


def viterbi(freq, nn):
    """Max-sum consensus of each window -> int64 [W, plen]; ties take the
    first maximum."""
    w, plen = freq.shape[:2]
    scores = freq[:, 0, :]
    backs = []
    for t in range(plen - 1):
        m = scores[:, :, None] + nn[:, t] + freq[:, t + 1, None, :]
        backs.append(torch.argmax(m, dim=1))
        scores = m.amax(dim=1)
    state = torch.argmax(scores, dim=1)
    rows = torch.arange(w, device=freq.device)
    path = [state]
    for back in reversed(backs):
        state = back[rows, state]
        path.append(state)
    return torch.stack(path[::-1], dim=1)


def stats(masks, positions, *, plen, variation, device, counts=None):
    """Stage A of one block of windows -> dict of NumPy arrays: freq, nn,
    cover_number, gap_number, viterbi (int64) and win (int8 [N, W, plen]).
    ``counts``: a narrower integer type the counts are held in before the
    Viterbi pass (the control; they wrap past its range)."""
    dev = torch.device(device)
    m = torch.as_tensor(np.asarray(masks, np.int32), device=dev)
    p = torch.as_tensor(np.asarray(positions, np.int64), device=dev)
    win = patch_windows(m, p, plen)
    out = window_stats(win, variation)
    if counts is not None:
        out = {k: v.to(counts).to(torch.int64) for k, v in out.items()}
    out["viterbi"] = viterbi(out["freq"], out["nn"])
    out = {k: v.cpu().numpy().astype(np.int64) for k, v in out.items()}
    out["win"] = win.cpu().numpy().astype(np.int8)
    return out
