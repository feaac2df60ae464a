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

The JAX module is one jitted XLA program (``lax.scan``, ``lax.cummax``,
``einsum``) with no Pallas kernel; here it is three hand-written CUDA
kernels of ``csrc/design_stage_a.cu`` for CUDA tensors:

* ``stage_a_rows``: each row's non-gap prefix counts ``before`` [N, L+1]
  and its left-packed residues, once an MSA;
* ``window_stats_from_masks``: the patched windows, freq, nn and the
  cover/gap counts of a block of windows, one launch a block;
* ``viterbi_batch``: the consensus of each window, one launch a block (a
  mesh sums its shards' counts first).

CPU tensors take their plain versions, the torch ops whose names end in
``_reference``.  Every count is int64, as on the host path (the JAX
package, without x64, counts in int32); integer sums are exact in any
order, so the card's values equal the CPU's.  The order-dependent Stage B
consumes the tensors on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import link as linkmod
from ..utils import trace
from . import _cuda

# popcount / member-count tables for 4-bit IUPAC masks.
_POP = np.array([bin(i).count("1") for i in range(16)], dtype=np.int64)
_MC = np.maximum(_POP, 1)        # '-' (mask 0) expands to itself: 1 member
# elements of the largest int64 temporary of window_stats_reference
# ([chunk, W, plen, 4]): 2**25 is 256 MiB
_CHUNK_ELEMS = 1 << 25
_LIB = "design_stage_a"


def patch_windows_reference(masks, positions, plen, *, device="cpu"):
    """Plain version of the windows kernel's patching: gap-patched windows
    for all start positions.

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


def window_stats_reference(win, variation, *, device="cpu"):
    """Plain version of the windows kernel's sums: per-window tensors from
    patched windows.

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


def viterbi_batch_reference(freq, nn, *, device="cpu"):
    """Plain version of the Viterbi kernel: batched max-sum consensus
    (core.py:579-593). freq [W, plen, 4], nn [W, plen-1, 4, 4] -> paths
    int32 [W, plen].  Ties take the first maximum (``torch.argmax``), like
    np.argmax."""
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


def stage_a_rows_reference(masks):
    """Plain version of the rows kernel: int32 masks [N, L] -> (before
    int32 [N, L + 1], the non-gaps left of each column and the row's total
    at L; packed uint8 [N, L], the row's residues left-packed, zeros past
    them)."""
    n, length = masks.shape
    nz = masks != 0
    before = torch.zeros((n, length + 1), dtype=torch.int32,
                         device=masks.device)
    before[:, 1:] = torch.cumsum(nz, dim=1)
    packed = torch.zeros((n, length + 1), dtype=torch.uint8,
                         device=masks.device)
    packed.scatter_(1, torch.where(nz, before[:, :-1], length).long(),
                    torch.where(nz, masks, 0).to(torch.uint8))
    return before, packed[:, :length].contiguous()


def design_stats_full_reference(masks, positions, *, plen=18, variation=1,
                                device="cpu"):
    """Plain version of the three kernels: the Stage-A step of
    ``design_stats_full`` as torch ops on ``device``."""
    win = patch_windows_reference(masks, positions, plen, device=device)
    stats = window_stats_reference(win, variation, device=device)
    stats["viterbi"] = viterbi_batch_reference(stats["freq"], stats["nn"],
                                               device=device)
    stats["win"] = win.to(torch.int8)
    return stats


def _ranges(t):
    """(min, max) of a non-empty integer tensor, one sync."""
    return torch.stack(torch.aminmax(t)).tolist()


def _load(fn, dev):
    """The kernels' library, for a launch on ``dev`` (a CUDA device)."""
    lib = _cuda.load(_LIB)
    if dev.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (fn, dev))
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def stage_a_rows(masks):
    """The rows of ``window_stats_from_masks``: int32 masks [N, L] (IUPAC
    4-bit, 0 = gap) -> (before int32 [N, L + 1], packed uint8 [N, L]), as
    ``stage_a_rows_reference`` gives them.  CUDA tensors launch
    ``stage_a_rows_kernel`` (or raise), after one sync that checks the
    masks lie in 0..15; CPU tensors take the plain version."""
    dev = masks.device
    if dev.type == "cpu":
        return stage_a_rows_reference(masks)
    _cuda.check_inputs("stage_a_rows", dev,
                       (("masks", masks, torch.int32, 2),))
    lib = _load("stage_a_rows", dev)
    n, length = masks.shape
    if masks.numel():
        lo, hi = _ranges(masks)
        if lo < 0 or hi > 15:
            raise ValueError("stage_a_rows: masks must lie in 0..15, got "
                             "%d..%d" % (lo, hi))
    before = torch.empty((n, length + 1), dtype=torch.int32, device=dev)
    packed = torch.empty((n, length), dtype=torch.uint8, device=dev)
    if n:
        launch_rows(lib, masks, before, packed)
    return before, packed


def _positions(fn, positions, length, plen, dev):
    """Window starts as a contiguous int64 tensor on ``dev``, each with
    its window inside the row; starts on the card cost one sync."""
    if isinstance(positions, torch.Tensor) and positions.device.type != "cpu":
        pos = positions.to(device=dev, dtype=torch.int64).contiguous()
        lo, hi = _ranges(pos) if pos.numel() else (0, 0)
    else:
        host = np.ascontiguousarray(np.asarray(positions), dtype=np.int64)
        lo, hi = (int(host.min()), int(host.max())) if host.size else (0, 0)
        pos = torch.from_numpy(host).to(dev)
    if pos.dim() != 1:
        raise ValueError("%s: positions must be 1D, got %s"
                         % (fn, tuple(pos.shape)))
    if lo < 0 or hi > length - plen:
        raise ValueError("%s: window starts must lie in 0..%d (L %d, plen "
                         "%d), got %d..%d" % (fn, length - plen, length, plen,
                                              lo, hi))
    return pos


def launch_rows(lib, masks, before, packed):
    """One launch of the rows kernel on checked tensors (the wrapper's, and
    the smoke check's timing loop)."""
    dev = masks.device
    with torch.cuda.device(dev):
        _cuda.launch(lib, "stage_a_rows", masks.data_ptr(),
                     before.data_ptr(), packed.data_ptr(), masks.shape[0],
                     masks.shape[1], _stream(dev))


def launch_windows(lib, masks, rows, pos, out, win, plen, variation):
    """One launch of the windows kernel on checked tensors (as
    ``launch_rows``)."""
    dev = masks.device
    n, length = masks.shape
    with torch.cuda.device(dev):
        _cuda.launch(lib, "stage_a_windows", masks.data_ptr(),
                     rows[0].data_ptr(), rows[1].data_ptr(), pos.data_ptr(),
                     None if win is None else win.data_ptr(),
                     out["freq"].data_ptr(), out["nn"].data_ptr(),
                     out["cover_number"].data_ptr(),
                     out["gap_number"].data_ptr(), n, length, pos.shape[0],
                     plen, int(variation), _stream(dev))


def launch_viterbi(lib, freq, nn, path):
    """One launch of the Viterbi kernel on checked tensors (as
    ``launch_rows``)."""
    dev = freq.device
    with torch.cuda.device(dev):
        _cuda.launch(lib, "stage_a_viterbi", freq.data_ptr(),
                     nn.data_ptr(), path.data_ptr(), path.shape[0],
                     path.shape[1], _stream(dev))


def window_stats_from_masks(masks, positions, *, plen=18, variation=1,
                            with_win=False, rows=None):
    """The counts of ``design_stats_full`` without its Viterbi paths: int32
    masks [N, L] on a device and window starts [W] -> dict of freq int64
    [W, plen, 4], nn int64 [W, plen-1, 4, 4], cover_number and gap_number
    int64 [W] (and the patched windows, int8 [N, W, plen], ``with_win``),
    on the masks' device.

    CUDA tensors launch ``stage_a_windows_kernel`` once (or raise), on
    ``rows`` = ``stage_a_rows(masks)`` (made here when not given: pass
    them to run it once an MSA); CPU tensors take the plain versions."""
    dev = masks.device
    if dev.type == "cpu":
        win = patch_windows_reference(masks, positions, plen, device=dev)
        stats = window_stats_reference(win, variation, device=dev)
        if with_win:
            stats["win"] = win.to(torch.int8)
        return stats
    fn = "window_stats_from_masks"
    _cuda.check_inputs(fn, dev, (("masks", masks, torch.int32, 2),))
    if plen < 1:
        raise ValueError("%s: plen must be at least 1, got %d" % (fn, plen))
    lib = _load(fn, dev)
    n, length = masks.shape
    pos = _positions(fn, positions, length, plen, dev)
    if rows is None:
        rows = stage_a_rows(masks)
    before, packed = rows
    _cuda.check_inputs(fn, dev, (("before", before, torch.int32, 2),
                                 ("packed", packed, torch.uint8, 2)))
    if tuple(before.shape) != (n, length + 1) \
            or tuple(packed.shape) != (n, length):
        raise ValueError("%s: rows must be [%d, %d] and [%d, %d], got %s and "
                         "%s" % (fn, n, length + 1, n, length,
                                 tuple(before.shape), tuple(packed.shape)))
    w = pos.shape[0]
    out = {"freq": torch.empty((w, plen, 4), dtype=torch.int64, device=dev),
           "nn": torch.empty((w, plen - 1, 4, 4), dtype=torch.int64,
                             device=dev),
           "cover_number": torch.empty(w, dtype=torch.int64, device=dev),
           "gap_number": torch.empty(w, dtype=torch.int64, device=dev)}
    win = torch.empty((n, w, plen), dtype=torch.int8, device=dev) \
        if with_win else None
    if w:
        launch_windows(lib, masks, rows, pos, out, win, plen, variation)
    if with_win:
        out["win"] = win
    return out


def viterbi_batch(freq, nn, *, device="cuda"):
    """Batched max-sum consensus (core.py:579-593): freq [W, plen, 4], nn
    [W, plen-1, 4, 4] -> paths int32 [W, plen], on ``device``.  Ties take
    the first maximum, like np.argmax.  CUDA launches
    ``stage_a_viterbi_kernel`` (or raises), the CPU takes the plain
    version."""
    dev = linkmod.resolve_device(device)
    freq = torch.as_tensor(freq, device=dev).to(torch.int64)
    nn = torch.as_tensor(nn, device=dev).to(torch.int64)
    if dev.type == "cpu":
        return viterbi_batch_reference(freq, nn, device=dev)
    freq, nn = freq.contiguous(), nn.contiguous()
    dev = freq.device                 # "cuda" resolved to its index
    _cuda.check_inputs("viterbi_batch", dev,
                       (("freq", freq, torch.int64, 3),
                        ("nn", nn, torch.int64, 4)))
    w, plen = freq.shape[:2]
    if plen < 1 or freq.shape[2] != 4 \
            or tuple(nn.shape) != (w, plen - 1, 4, 4):
        raise ValueError("viterbi_batch: freq must be [W, plen >= 1, 4] and "
                         "nn [W, plen - 1, 4, 4], got %s and %s"
                         % (tuple(freq.shape), tuple(nn.shape)))
    lib = _load("viterbi_batch", dev)
    path = torch.empty((w, plen), dtype=torch.int32, device=dev)
    if w:
        launch_viterbi(lib, freq, nn, path)
    return path


def _stats(masks, positions, plen, variation, with_win, rows=None):
    """The Stage-A step on ``masks``' device: the plain versions on the
    CPU, the three kernels elsewhere (``rows`` given: the rows kernel not
    again)."""
    if masks.device.type == "cpu":
        stats = design_stats_full_reference(masks, positions, plen=plen,
                                            variation=variation,
                                            device=masks.device)
        if not with_win:
            del stats["win"]
        return stats
    stats = window_stats_from_masks(masks, positions, plen=plen,
                                    variation=variation, with_win=with_win,
                                    rows=rows)
    win = stats.pop("win", None)
    stats["viterbi"] = viterbi_batch(stats["freq"], stats["nn"],
                                     device=masks.device)
    if with_win:
        stats["win"] = win
    return stats


def _device_masks(masks, dev):
    return torch.as_tensor(masks, device=dev).to(torch.int32).contiguous()


def design_stats_full(masks, positions, *, plen=18, variation=1,
                      device="cuda"):
    """The Stage-A step: masks [N, L] + window starts [W] -> per-window
    tensors, Viterbi consensus and the patched windows themselves (int8
    masks, [N, W, plen], so host Stage B consumes them without
    re-patching), on ``device``: the three kernels on a card, the plain
    versions on the CPU."""
    dev = linkmod.resolve_device(device)
    return _stats(_device_masks(masks, dev), positions, plen, variation,
                  with_win=True)


def design_stats(masks, positions, *, plen=18, variation=1, device="cuda"):
    """design_stats_full without the patched windows."""
    dev = linkmod.resolve_device(device)
    return _stats(_device_masks(masks, dev), positions, plen, variation,
                  with_win=False)


def design_stats_blocks(masks, positions, *, plen=18, variation=1,
                        block=512, device="cuda"):
    """Block runner over the window axis: the masks go to ``device`` once
    (on a card, with the rows kernel once), then positions are processed
    ``block`` at a time (the last block is short: nothing is padded).
    Yields (pos_block, stats as NumPy arrays) per block.

    masks: uint8/int32 [N, L] IUPAC 4-bit masks; positions: int [W].
    """
    dev = linkmod.resolve_device(device)
    masks_d = _device_masks(np.ascontiguousarray(masks, dtype=np.int32), dev)
    copies = trace.ON and dev.type != "cpu"
    if copies:
        trace.count("h2d_bytes", masks_d.numel() * masks_d.element_size())
    positions = np.asarray(positions, dtype=np.int64)
    rows = None if dev.type == "cpu" else stage_a_rows(masks_d)
    for b0 in range(0, len(positions), block):
        pos = positions[b0:b0 + block]
        out = _stats(masks_d, pos, plen, variation, with_win=True, rows=rows)
        stats = {k: v.cpu().numpy() for k, v in out.items()}
        if copies:
            trace.count("d2h_bytes", sum(a.nbytes for a in stats.values()))
        yield pos, stats
