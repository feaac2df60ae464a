"""Batched window-design statistics on the device: Stage A of the MC-EDPD
engine.

PyTorch port of multiprime_tpu/ops/design_scan.py.  For every primer-length
window of an MSA at once it computes

* the gap-patched windows (core.py:666-687 semantics through prefix sums
  and gathers),
* per-window base frequencies [W, plen, 4] and nearest-neighbour
  transitions [W, plen-1, 4, 4], weighted by IUPAC expansion multiplicity
  exactly like the reference's per-expansion counting,
* per-window coverage and gap counts,
* the batched Viterbi consensus path (core.py:579-593).

These are torch ops on an explicit device: the JAX module is XLA code
(``lax.scan``, ``lax.cummax``, ``einsum``) with no Pallas kernel.  Every
count is int64, as on the host path (the JAX package, without x64, counts
in int32).  CUDA has no int64 matmul, so the sums over sequences are
broadcast products summed over the sequence axis, in chunks; integer sums
are exact in any order, so the card's values equal the CPU's.  The
order-dependent Stage B consumes the tensors on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import link as linkmod

# popcount / member-count tables for 4-bit IUPAC masks.
_POP = np.array([bin(i).count("1") for i in range(16)], dtype=np.int64)
_MC = np.maximum(_POP, 1)        # '-' (mask 0) expands to itself: 1 member
# elements of the largest int64 temporary of window_stats ([chunk, W, plen,
# 4]): 2**25 is 256 MiB
_CHUNK_ELEMS = 1 << 25


def patch_windows(masks, positions, plen, *, device="cuda"):
    """Gap-patched windows for all start positions.

    masks: int [N, L] IUPAC 4-bit masks (0 = gap)
    positions: int [W] window starts
    -> int32 [N, W, plen] patched masks, on ``device``
    """
    dev = linkmod.resolve_device(device)
    masks = torch.as_tensor(masks, device=dev).to(torch.int32)
    positions = torch.as_tensor(positions, device=dev).to(torch.int64)
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
    # left-packed gapless characters; gaps scatter into a dropped column
    packed = torch.zeros((n, length + 1), dtype=masks.dtype, device=dev)
    packed.scatter_(1, torch.where(nz, before, length),
                    torch.where(nz, masks, 0))
    packed = packed[:, :length]

    j = torch.arange(plen, device=dev)
    last = positions + plen - 1
    win = masks[:, positions[:, None] + j[None, :]]          # [N, W, plen]
    lead = run_from[:, positions].clamp(max=plen)             # [N, W]
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


def window_stats(win, variation, *, device="cuda"):
    """Per-window tensors from patched windows.

    win: int [N, W, plen] masks
    -> dict with freq [W, plen, 4], nn [W, plen-1, 4, 4] (int64),
       cover_number [W], gap_number [W] (int64), on ``device``

    freq/nn are weighted by expansion multiplicity: a window with member
    counts mc_j contributes prod(mc)/mc_j copies of each member base at j,
    identical totals to the reference's per-expansion counting.
    """
    dev = linkmod.resolve_device(device)
    win = torch.as_tensor(win, device=dev).to(torch.int64)
    n, w, plen = win.shape
    mc = torch.as_tensor(_MC, device=dev)[win]               # [N, W, plen]
    is_gap = (win == 0).sum(dim=2) > variation                # [N, W]
    alive = ~is_gap
    total_exp = torch.prod(mc, dim=2)                         # expansions
    w_pos = torch.where(alive[:, :, None], total_exp[:, :, None] // mc, 0)
    # NN: weight total / (mc_j * mc_{j+1})
    pair_mc = mc[:, :, :-1] * mc[:, :, 1:]
    w_pair = torch.where(alive[:, :, None],
                         total_exp[:, :, None] // pair_mc, 0)
    bits = torch.arange(4, device=dev)
    freq = torch.zeros((w, plen, 4), dtype=torch.int64, device=dev)
    nn = torch.zeros((w, plen - 1, 4, 4), dtype=torch.int64, device=dev)
    step = max(1, _CHUNK_ELEMS // max(w * plen * 4, 1))
    for lo in range(0, n, step):
        member = (win[lo:lo + step, :, :, None] >> bits) & 1  # [c, W, plen, 4]
        freq += (w_pos[lo:lo + step, :, :, None] * member).sum(dim=0)
        for a in range(4):
            left = w_pair[lo:lo + step] * member[:, :, :-1, a]
            nn[:, :, a, :] += (left[:, :, :, None]
                               * member[:, :, 1:, :]).sum(dim=0)
    return {"freq": freq, "nn": nn, "cover_number": alive.sum(dim=0),
            "gap_number": is_gap.sum(dim=0)}


def viterbi_batch(freq, nn, *, device="cuda"):
    """Batched max-sum consensus (core.py:579-593). freq [W, plen, 4],
    nn [W, plen-1, 4, 4] -> paths int32 [W, plen].  Ties take the first
    maximum (``torch.argmax``), like np.argmax."""
    dev = linkmod.resolve_device(device)
    freq = torch.as_tensor(freq, device=dev).to(torch.int64)
    nn = torch.as_tensor(nn, device=dev).to(torch.int64)
    w, plen = freq.shape[:2]
    scores = freq[:, 0, :]
    backs = []
    for t in range(plen - 1):
        m = scores[:, :, None] + nn[:, t] + freq[:, t + 1, None, :]
        backs.append(torch.argmax(m, dim=1))
        scores = m.amax(dim=1)
    state = torch.argmax(scores, dim=1)                     # last position
    rows = torch.arange(w, device=dev)
    path = [state]
    for back in reversed(backs):
        state = back[rows, state]
        path.append(state)
    return torch.stack(path[::-1], dim=1).to(torch.int32)


def design_stats_full(masks, positions, *, plen=18, variation=1,
                      device="cuda"):
    """The Stage-A step: masks [N, L] + window starts [W] -> per-window
    tensors, Viterbi consensus and the patched windows themselves (int8
    masks, [N, W, plen], so host Stage B consumes them without
    re-patching), on ``device``."""
    win = patch_windows(masks, positions, plen, device=device)
    stats = window_stats(win, variation, device=device)
    stats["viterbi"] = viterbi_batch(stats["freq"], stats["nn"],
                                     device=device)
    stats["win"] = win.to(torch.int8)
    return stats


def design_stats(masks, positions, *, plen=18, variation=1, device="cuda"):
    """design_stats_full without the patched windows."""
    stats = design_stats_full(masks, positions, plen=plen,
                              variation=variation, device=device)
    del stats["win"]
    return stats


def design_stats_blocks(masks, positions, *, plen=18, variation=1,
                        block=512, device="cuda"):
    """Block runner over the window axis: the masks go to ``device`` once,
    then positions are processed ``block`` at a time (the last block is
    short; eager torch needs no padding to reuse a compiled shape).
    Yields (pos_block, stats as NumPy arrays) per block.

    masks: uint8/int32 [N, L] IUPAC 4-bit masks; positions: int [W].
    """
    dev = linkmod.resolve_device(device)
    masks_d = torch.as_tensor(np.ascontiguousarray(masks, dtype=np.int32),
                              device=dev)
    positions = np.asarray(positions, dtype=np.int64)
    for b0 in range(0, len(positions), block):
        pos = positions[b0:b0 + block]
        out = design_stats_full(masks_d, torch.from_numpy(pos).to(dev),
                                plen=plen, variation=variation, device=dev)
        yield pos, {k: v.cpu().numpy() for k, v in out.items()}
