"""Mismatch-tolerant primer-vs-target scan on PyTorch: the port's hot kernel.

PyTorch port of multiprime_tpu/ops/mismatch_scan.py.  A window of a target
is a hit for a pattern when

    total mismatches <= mm   AND   suffix matches >= term

where the suffix is the pattern's 3'-terminal ``term`` positions (the
reference's MD-tag trailing-run filter).  Hits come back as int8 codes
(0 = miss, mismatches + 1 = hit) and then as sparse flat indices.

* NumPy host helpers (encoders, decoders, ``find_hits_numpy``) are copies
  of the JAX module's.
* ``hit_codes`` launches the hand-written CUDA kernel
  ``csrc/hit_codes.cu`` for CUDA tensors; for CPU tensors it runs its plain
  PyTorch version ``hit_codes_reference`` (the conv formulation of the JAX
  package's ``hit_codes_conv``).
* ``find_hits`` launches ``csrc/find_hits.cu`` for CUDA tensors: the hit
  list (ascending flat indices, n_hits, mismatches) straight from the
  tensor-core window product, with the window-length mask and no codes
  tensor.  For CPU tensors it runs its plain version ``find_hits_reference``
  (``hit_codes_reference`` + ``find_hits_from_codes``, the JAX package's
  two-level compaction in torch ops).  ``find_hits_packed`` /
  ``find_hits_batched`` go through it.
* ``match_counts`` (the JAX package's ``match_counts_conv`` /
  ``match_counts_pallas``) launches ``csrc/match_counts.cu``: exact match
  counts with no purity rule, the correlation under ``ops/dimer.py``.
* ``hit_window_bitmap`` / ``find_hits_bitmap`` are the two-phase sparse
  scan: an any-hit window bitmap from ``csrc/hit_window_bitmap.cu``, then
  a host re-match of the flagged windows.

Patterns reach the kernels packed as bit-planes (``pattern_planes``,
``pack_patterns``): int64 [P, 4], bit k of plane b set iff the pattern
admits base b at position k; the int64 bits are the kernels' uint64 planes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import iupac
from ..utils import link as linkmod
from . import _cuda

# the combined-weight trick of hit_codes_conv: score = counts + W * suffix
_W = 64
MAX_PLEN = 63          # hit codes and bitmap: below _W
MAX_COUNT_PLEN = 64    # match counts: every bit of the 64-bit planes


def encode_targets(seqs, length=None):
    """List of ACGT/N strings -> (one-hot uint8 [N, L, 4], lengths [N])."""
    if length is None:
        length = max((len(s) for s in seqs), default=0)
    n = len(seqs)
    chars = np.zeros((n, length), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode("ascii"), np.uint8)[:length]
        chars[i, :len(b)] = b
        lengths[i] = len(b)
    masks = iupac.bytes_to_masks(chars)
    onehot = ((masks[..., None] >> np.arange(4)[None, None, :]) & 1)
    # Ambiguity codes in targets match nothing (bowtie-like): zero them out.
    pure = np.isin(masks, [1, 2, 4, 8])
    onehot = onehot * pure[..., None]
    return onehot.astype(np.uint8), lengths


def encode_target_masks(seqs, length=None):
    """List of strings -> (IUPAC 4-bit masks uint8 [N, L], lengths [N]):
    the compact upload format, 1/4 the bytes of the one-hot encoding."""
    if length is None:
        length = max((len(s) for s in seqs), default=0)
    n = len(seqs)
    chars = np.zeros((n, length), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode("ascii"), np.uint8)[:length]
        chars[i, :len(b)] = b
        lengths[i] = len(b)
    return iupac.bytes_to_masks(chars), lengths


def encode_target_codes(seqs, length=None):
    """List of strings -> (STRICT 4-bit codes uint8 [N, L], lengths [N]):
    pure bases keep their bit, ambiguity codes/gaps/padding become 0 (match
    nothing) — the mask-scan form of encode_targets' purity zeroing."""
    masks, lengths = encode_target_masks(seqs, length)
    pure = np.isin(masks, [1, 2, 4, 8])
    return np.where(pure, masks, 0).astype(np.uint8), lengths


def encode_pattern_masks(patterns):
    """List of (possibly degenerate) equal-length patterns -> uint8
    [P, plen] IUPAC member masks; unknown characters map to 0 = always a
    mismatch, like encode_primers' zero one-hot rows."""
    arr = np.stack([
        np.frombuffer(p.encode("ascii"), np.uint8) for p in patterns])
    return iupac.bytes_to_masks(arr)


def encode_primers(primers):
    """List of equal-length primers -> one-hot uint8 [P, l, 4] (a
    degenerate position sets every member base)."""
    arr = np.stack([
        np.frombuffer(p.encode("ascii"), np.uint8) for p in primers])
    masks = iupac.bytes_to_masks(arr)
    onehot = ((masks[..., None] >> np.arange(4)[None, None, :]) & 1)
    return onehot.astype(np.uint8)


def expand_masks(masks):
    """uint8 [N, L] IUPAC masks (tensor) -> one-hot uint8 [N, L, 4];
    ambiguity codes in targets match nothing (bowtie-like), same semantics
    as encode_targets."""
    m = masks.to(torch.int64)
    onehot = (m[..., None] >> torch.arange(4, device=m.device)) & 1
    pure = (m > 0) & (m < 16) & ((m & (m - 1)) == 0)
    return torch.where(pure[..., None], onehot, 0).to(torch.uint8)


def onehot_masks(onehot):
    """One-hot [..., 4] (NumPy array or tensor) -> uint8 masks [...] on the
    same device: bit b set iff onehot[..., b] != 0.  No purity rule: a
    position with several bases keeps them all."""
    oh = torch.as_tensor(onehot)
    weights = torch.tensor([1, 2, 4, 8], dtype=torch.uint8, device=oh.device)
    return ((oh != 0).to(torch.uint8) * weights).sum(-1, dtype=torch.uint8)


def pattern_planes(patterns_1h, *, device):
    """Pattern one-hots [P, plen <= 64, 4] (NumPy, the JAX package's layout)
    -> int64 [P, 4] bit-planes on ``device``: bit k of plane b is set iff
    one-hot [p, k, b] != 0 (bit 63 is the int64 sign bit)."""
    oh = np.asarray(patterns_1h)
    plen = oh.shape[1]
    if plen > MAX_COUNT_PLEN:
        raise ValueError("pattern length %d exceeds %d" % (plen,
                                                           MAX_COUNT_PLEN))
    weights = np.left_shift(np.int64(1), np.arange(plen, dtype=np.int64))
    bits = (oh != 0).astype(np.int64)                     # [P, plen, 4]
    # distinct powers of two: the int64 sum is exact, bit 63 included
    return torch.from_numpy(np.einsum("pkb,k->pb", bits, weights)).to(device)


def pack_patterns(primers_1h, suffix_1h, *, device):
    """Pattern one-hots [P, plen <= 63, 4] and their 3'-suffix one-hots ->
    (planes, suffix_planes), int64 [P, 4] on ``device``, for the hit-code
    and bitmap kernels."""
    plen = np.shape(primers_1h)[1]
    if plen > MAX_PLEN:
        raise ValueError("pattern length %d exceeds %d" % (plen, MAX_PLEN))
    return (pattern_planes(primers_1h, device=device),
            pattern_planes(suffix_1h, device=device))


def _unpack_planes(planes, plen):
    """int64 [P, 4] bit-planes -> one-hot float32 [P, 4, plen]."""
    bits = torch.arange(plen, device=planes.device)
    return ((planes[:, :, None] >> bits) & 1).to(torch.float32)


def hit_codes_reference(target_masks, planes, suffix_planes, *, plen, mm,
                        term):
    """Plain PyTorch version of the hit-code kernel: one float32 conv1d over
    the combined weight ``primers + 64 * suffix`` and its threshold, as in
    the JAX package's hit_codes_conv.  Scores are integers below 2**12, so
    float32 is exact; TF32 is switched off, as it would round them."""
    if not (plen < _W and mm < _W):
        raise ValueError("hit_codes_reference: plen and mm must be below "
                         "%d, got %d and %d" % (_W, plen, mm))
    n, length = target_masks.shape
    n_out = length - plen + 1
    if n_out <= 0:
        return torch.zeros((n, 0, planes.shape[0]), dtype=torch.int8,
                           device=target_masks.device)
    x = expand_masks(target_masks).permute(0, 2, 1).to(torch.float32)
    weight = (_unpack_planes(planes, plen)
              + _W * _unpack_planes(suffix_planes, plen))     # [P, 4, plen]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        score = F.conv1d(x, weight)                           # [N, P, O]
    thresh = _W * term + plen - mm
    mism = plen - (score - _W * term)
    codes = torch.where(score >= thresh, mism + 1, 0).to(torch.int8)
    return codes.permute(0, 2, 1).contiguous()                # [N, O, P]


def hit_codes(target_masks, planes, suffix_planes, *, plen, mm, term):
    """int8 hit codes [N, O = L - plen + 1, P] (0 = no hit, mismatches + 1
    = hit under the mm/term rule) for uint8 [N, L] target masks and int64
    [P, 4] pattern planes.

    CUDA tensors launch the CUDA kernel ``csrc/hit_codes.cu`` (or raise):
    the match counts as an int8 tensor-core product (mma.sync), a suffix
    test for the rare candidates only, the codes zeroed by bulk copies and
    the hits' codes written over them.  CPU tensors take the plain
    version."""
    dev = target_masks.device
    if dev.type == "cpu":
        return hit_codes_reference(target_masks, planes, suffix_planes,
                                   plen=plen, mm=mm, term=term)
    n, length, p = _check_scan_inputs("hit_codes", target_masks, planes,
                                      suffix_planes, plen)
    codes = torch.empty((n, max(length - plen + 1, 0), p), dtype=torch.int8,
                        device=dev)
    if codes.numel() == 0:
        return codes
    with torch.cuda.device(dev):
        _cuda.launch(_cuda.load("hit_codes"), "hit_codes",
                     target_masks.data_ptr(), planes.data_ptr(),
                     suffix_planes.data_ptr(), codes.data_ptr(), n, length,
                     p, int(plen), int(mm), int(term),
                     torch.cuda.current_stream(dev).cuda_stream)
    return codes


def _check_scan_inputs(fn, target_masks, planes, suffix_planes, plen):
    """The CUDA-side checks shared by the hit-code, find_hits and bitmap
    wrappers -> (N, L, P)."""
    if target_masks.device.type != "cuda":
        raise ValueError("%s: unsupported device %s"
                         % (fn, target_masks.device))
    return _scan_shapes(fn, target_masks, planes, suffix_planes, plen)


def _scan_shapes(fn, target_masks, planes, suffix_planes, plen):
    """``_check_scan_inputs`` but for the device type -> (N, L, P)."""
    dev = target_masks.device
    _cuda.check_inputs(fn, dev, (
        ("target_masks", target_masks, torch.uint8, 2),
        ("planes", planes, torch.int64, 2),
        ("suffix_planes", suffix_planes, torch.int64, 2)))
    p = planes.shape[0]
    if planes.shape[1] != 4 or tuple(suffix_planes.shape) != (p, 4):
        raise ValueError("%s: planes and suffix_planes must be [P, 4], got "
                         "%s and %s" % (fn, tuple(planes.shape),
                                        tuple(suffix_planes.shape)))
    if not 1 <= plen <= MAX_PLEN:
        raise ValueError("%s: plen must be in 1..%d, got %d"
                         % (fn, MAX_PLEN, plen))
    return target_masks.shape[0], target_masks.shape[1], p


# ---------------------------------------------------------------------------
# match counts: the correlation under ops/dimer.py
# ---------------------------------------------------------------------------

def match_counts_reference(target_masks, planes, *, plen):
    """Plain PyTorch version of the match-count kernel: one float32 conv1d
    of the masks' one-hots (every set bit, no purity rule) against the
    patterns' -> float32 [N, O, P], as the JAX package's match_counts_conv.
    Counts are integers <= 4 * plen; TF32 is switched off, as it would
    round them."""
    n, length = target_masks.shape
    p = planes.shape[0]
    n_out = length - plen + 1
    if n_out <= 0:
        return torch.zeros((n, 0, p), dtype=torch.float32,
                           device=target_masks.device)
    m = target_masks.to(torch.int64)
    x = ((m[:, None, :] >> torch.arange(4, device=m.device)[None, :, None])
         & 1).to(torch.float32)                               # [N, 4, L]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        counts = F.conv1d(x, _unpack_planes(planes, plen))    # [N, P, O]
    return counts.permute(0, 2, 1).contiguous()               # [N, O, P]


def match_counts_kernel(target_masks, planes, *, plen):
    """float32 match counts [N, O = L - plen + 1, P] for uint8 [N, L]
    target masks and int64 [P, 4] pattern planes: the number of (position,
    base) pairs where both have the bit set.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take the
    plain version."""
    dev = target_masks.device
    if dev.type == "cpu":
        return match_counts_reference(target_masks, planes, plen=plen)
    if dev.type != "cuda":
        raise ValueError("match_counts: unsupported device %s" % dev)
    _cuda.check_inputs("match_counts", dev,
                       (("target_masks", target_masks, torch.uint8, 2),
                        ("planes", planes, torch.int64, 2)))
    if planes.shape[1] != 4:
        raise ValueError("match_counts: planes must be [P, 4], got %s"
                         % (tuple(planes.shape),))
    if not 1 <= plen <= MAX_COUNT_PLEN:
        raise ValueError("match_counts: plen must be in 1..%d, got %d"
                         % (MAX_COUNT_PLEN, plen))
    n, length = target_masks.shape
    p = planes.shape[0]
    counts = torch.empty((n, max(length - plen + 1, 0), p),
                         dtype=torch.float32, device=dev)
    if counts.numel() == 0:
        return counts
    with torch.cuda.device(dev):
        _cuda.launch(_cuda.load("match_counts"), "match_counts",
                     target_masks.data_ptr(), planes.data_ptr(),
                     counts.data_ptr(), n, length, p, int(plen),
                     torch.cuda.current_stream(dev).cuda_stream)
    return counts


def match_counts(targets_1h, primers_1h, *, device="cuda"):
    """[N, L, 4] x [P, plen, 4] one-hots (NumPy or tensors) -> float32
    match counts [N, L - plen + 1, P] on ``device``: the values of the JAX
    package's match_counts_conv and match_counts_pallas."""
    dev = linkmod.resolve_device(device)
    masks = onehot_masks(targets_1h).to(dev)
    planes = pattern_planes(np.asarray(primers_1h), device=dev)
    return match_counts_kernel(masks, planes, plen=np.shape(primers_1h)[1])


# ---------------------------------------------------------------------------
# the two-phase bitmap scan
# ---------------------------------------------------------------------------

def pure_masks(target_masks):
    """uint8 [N, L] IUPAC masks (tensor) -> the same with every mask that is
    not a single base set to 0: ambiguity codes, gaps and padding match
    nothing, the purity rule of expand_masks and of the hit-code kernel."""
    m = target_masks
    return torch.where((m == 1) | (m == 2) | (m == 4) | (m == 8), m, 0)


def hit_window_bitmap_reference(target_masks, planes, suffix_planes, *, plen,
                                mm, term):
    """Plain PyTorch version of the bitmap kernel: the plain match counts of
    the patterns and of their suffixes (every mask bit a base), the mm/term
    rule, ``any`` over the patterns -> int8 [N, O].  On pure targets (at
    most one bit a position) it is the plain hit codes reduced with
    ``any``."""
    counts = match_counts_reference(target_masks, planes, plen=plen)
    sfx = match_counts_reference(target_masks, suffix_planes, plen=plen)
    return ((plen - counts <= mm) & (sfx >= term)).any(dim=2).to(torch.int8)


def hit_window_bitmap_kernel(target_masks, planes, suffix_planes, *, plen,
                             mm, term):
    """int8 any-hit bitmap [N, O = L - plen + 1]: 1 iff some pattern hits
    the window under the mm/term rule of ``hit_codes`` (no window-length
    mask).  ``target_masks`` are uint8 [N, L] base sets, bit b set iff the
    position holds base b: a position with several bases counts once per
    base it shares with the pattern, as the JAX package's matmul counts
    such a one-hot.  IUPAC masks go through ``pure_masks`` first.
    CUDA tensors launch the CUDA kernel ``csrc/hit_window_bitmap.cu`` (or
    raise): the match counts as an int8 tensor-core product (wgmma), their
    row maximum against plen - mm, the suffix test for candidates only.
    CPU tensors take the plain version."""
    if target_masks.device.type == "cpu":
        return hit_window_bitmap_reference(target_masks, planes,
                                           suffix_planes, plen=plen, mm=mm,
                                           term=term)
    n, length, p = _check_scan_inputs("hit_window_bitmap", target_masks,
                                      planes, suffix_planes, plen)
    dev = target_masks.device
    bitmap = torch.empty((n, max(length - plen + 1, 0)), dtype=torch.int8,
                         device=dev)
    if bitmap.numel() == 0:
        return bitmap
    with torch.cuda.device(dev):
        _cuda.launch(_cuda.load("hit_window_bitmap"), "hit_window_bitmap",
                     target_masks.data_ptr(), planes.data_ptr(),
                     suffix_planes.data_ptr(), bitmap.data_ptr(), n, length,
                     p, int(plen), int(mm), int(term),
                     torch.cuda.current_stream(dev).cuda_stream)
    return bitmap


def hit_window_bitmap(targets, lengths, planes, suffix_planes, *, plen, mm=1,
                      term=4):
    """Any-hit window bitmap [N, O] int8 with the in-sequence length mask
    applied, the JAX package's hit_window_bitmap.  ``targets`` is uint8
    [N, L] IUPAC masks (ambiguity codes match nothing, as expand_masks) or
    a one-hot [N, L, 4] taken as it is: a position with several bases
    counts once per base it shares with the pattern, as in the JAX
    package."""
    masks = onehot_masks(targets) if targets.dim() == 3 else \
        pure_masks(targets)
    bm = hit_window_bitmap_kernel(masks, planes, suffix_planes, plen=plen,
                                  mm=mm, term=term)
    return _inside_windows(bm, lengths, plen)


def _inside_windows(bm, lengths, plen):
    """Zero the windows of bm [N, O] that run past their sequence's
    length."""
    o_idx = torch.arange(bm.shape[1], device=bm.device)
    inside = (o_idx[None, :] + plen) <= lengths.to(bm.device)[:, None]
    return torch.where(inside, bm, 0)


# flagged windows re-matched per host matmul: bounds its [H, 2P] float32
# accumulator (390 MB at P = 744)
_REMATCH_CHUNK = 1 << 16


def find_hits_bitmap(targets_1h, lengths, primers_1h, suffix_1h, *, mm=1,
                     term=4, device="cuda"):
    """Two-phase sparse scan, the JAX package's find_hits_bitmap: a device
    any-hit bitmap (N * O bytes instead of N * O * P), then a host re-match
    of the flagged windows only.  NumPy one-hots in; (seq, window, primer,
    mism) arrays out, in ascending (n, o, p) order as find_hits.  The
    re-match applies the same mm/term rule, _REMATCH_CHUNK windows at a
    time."""
    dev = linkmod.resolve_device(device)
    t1h = np.asarray(targets_1h)
    p1h = np.asarray(primers_1h)
    s1h = np.asarray(suffix_1h)
    p, plen = p1h.shape[0], p1h.shape[1]
    planes, sfx = pack_patterns(p1h, s1h, device=dev)
    # the base sets cross to the device: a quarter of the one-hot's bytes
    masks = onehot_masks(t1h).to(dev)
    bm = hit_window_bitmap_kernel(masks, planes, sfx, plen=plen, mm=mm,
                                  term=term)
    bm = _inside_windows(bm, torch.as_tensor(np.asarray(lengths)), plen)
    ns, os_ = np.nonzero(bm.cpu().numpy())
    if len(ns) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z.astype(np.int32)
    out = ([], [], [], [])
    weights = np.concatenate([p1h, s1h], axis=0).reshape(
        2 * p, plen * 4).astype(np.float32).T                # [4*plen, 2P]
    # [N, O, 4, plen] view: one fancy index gathers the flagged windows
    win_view = np.lib.stride_tricks.sliding_window_view(t1h, plen, axis=1)
    for lo in range(0, len(ns), _REMATCH_CHUNK):
        n_c = ns[lo:lo + _REMATCH_CHUNK]
        o_c = os_[lo:lo + _REMATCH_CHUNK]
        wmat = win_view[n_c, o_c].transpose(0, 2, 1).reshape(
            len(n_c), plen * 4).astype(np.float32)           # [H, plen*4]
        acc = wmat @ weights                                 # [H, 2P]
        counts = acc[:, :p].astype(np.int32)
        sfx_c = acc[:, p:].astype(np.int32)
        mism = plen - counts
        h, pi = np.nonzero((mism <= mm) & (sfx_c >= term))
        for dst, part in zip(out, (n_c[h], o_c[h], pi, mism[h, pi])):
            dst.append(part)
    seq, win, pat, mis = (np.concatenate(part) for part in out)
    return (seq.astype(np.int64), win.astype(np.int64), pat.astype(np.int64),
            mis.astype(np.int32))


# level-1 compaction block length, as in the JAX package's find_hits: the
# per-block hit counts shrink the nonzero problem 64-fold before the exact
# index extraction
_BLK = 64
# blocks counted a step: bounds the step's boolean temporary (128 MiB)
_COUNT_BLOCKS = 1 << 21


def find_hits_from_codes(codes, lengths, *, plen, max_hits):
    """Window-length mask + sparse compaction of hit codes [N, O, P]
    -> (hit_idx [max_hits] int64, n_hits (0-d int64), mismatches
    [max_hits] int64).

    hit_idx holds the ascending flat indices n * (O * P) + o * P + p of the
    first max_hits hits, -1 padding; n_hits counts all of them.  Stays on
    the codes' device with no host sync.  Masks ``codes`` in place.

    Two levels, as the JAX package's find_hits: hit counts of 64-element
    blocks of the flat codes (the last block short), a nonzero over the
    non-empty blocks, then an exact nonzero over the max_hits x 64
    gathered candidates.  At most max_hits hits lie in at most max_hits
    blocks, and blocks and offsets are enumerated ascending, so the result
    is the flat nonzero's first max_hits hits.  The blocks are counted
    _COUNT_BLOCKS at a time: no flat index tensor and no boolean mask of
    the codes' size is ever built.

    The full-size passes work on int64 words, eight codes each: the window
    mask (when P is a multiple of 8), and the block counts, which sum a
    block's eight words of 0/1 bytes (each byte lane <= 8, no carry) and
    fold the lanes; int8 and bool element-wise kernels, and a cast before
    the sum, cost several times more on the card."""
    dev = codes.device
    n, n_out, p = codes.shape
    o_idx = torch.arange(n_out, device=dev)
    outside = (o_idx[None, :] + plen) > lengths.to(dev)[:, None]
    words = codes.is_contiguous() and p % 8 == 0 \
        and codes.data_ptr() % 8 == 0
    (codes.view(torch.int64) if words else codes).masked_fill_(
        outside[:, :, None], 0)
    total = codes.numel()
    if total == 0:
        none = torch.full((max_hits,), -1, dtype=torch.int64, device=dev)
        return none, torch.zeros((), dtype=torch.int64, device=dev), \
            none.clone()
    flat = codes.reshape(-1)
    n_full = total // _BLK
    blk_cnt = torch.empty(-(-total // _BLK), dtype=torch.int64, device=dev)
    full = flat[:n_full * _BLK].view(n_full, _BLK)
    for lo in range(0, n_full, _COUNT_BLOCKS):
        hi = min(lo + _COUNT_BLOCKS, n_full)
        torch.sum((full[lo:hi] != 0).view(torch.int64), dim=1,
                  out=blk_cnt[lo:hi])
    for shift in (32, 16, 8):           # fold the byte lanes into lane 0
        blk_cnt += blk_cnt >> shift
    blk_cnt &= 0xFF
    if n_full < len(blk_cnt):
        blk_cnt[n_full] = (flat[n_full * _BLK:] != 0).sum()
    n_hits = blk_cnt.sum()
    blk_idx = torch.nonzero_static(blk_cnt > 0, size=max_hits,
                                   fill_value=-1)[:, 0]
    # the candidates' flat indices, ascending; int32 as the flat index
    # space stays under 2**31 (safe_batch_size)
    cand = (blk_idx.to(torch.int32)[:, None] * _BLK
            + torch.arange(_BLK, dtype=torch.int32, device=dev))
    inside = (blk_idx >= 0)[:, None] & (cand < total)
    vals = torch.where(inside, flat[cand.clamp(0, total - 1)], 0)
    pos = torch.nonzero_static((vals > 0).reshape(-1), size=max_hits,
                               fill_value=-1)[:, 0]
    found = pos >= 0
    at = pos.clamp(min=0)
    idx = torch.where(found, cand.reshape(-1)[at].to(torch.int64), -1)
    mism = torch.where(found, vals.reshape(-1)[at].to(torch.int64) - 1, -1)
    return idx, n_hits, mism


def find_hits_reference(target_masks, lengths, planes, suffix_planes, *,
                        plen, mm=1, term=4, max_hits=1 << 18):
    """Plain PyTorch version of the find_hits kernels: the plain hit codes,
    then the window-length mask and the two-level compaction."""
    codes = hit_codes_reference(target_masks, planes, suffix_planes,
                                plen=plen, mm=mm, term=term)
    return find_hits_from_codes(codes, lengths, plen=plen, max_hits=max_hits)


def find_hits(target_masks, lengths, planes, suffix_planes, *, plen, mm=1,
              term=4, max_hits=1 << 18):
    """Sparse scan of uint8 [N, L] target masks with lengths [N] (int32 or
    int64): -> (hit_idx [max_hits], n_hits, mismatches [max_hits]), the
    contract of the JAX package's find_hits (flat index n * O * P + o * P +
    p, ascending, -1 padding, the first max_hits hits), in int64.

    CUDA tensors launch the kernels of ``csrc/find_hits.cu`` (or raise):
    per-block hit counts from the tensor-core window product, their
    offsets, then each block's hits below max_hits written in order and
    the padding, with no [N, O, P] codes tensor.  CPU tensors take the
    plain version."""
    dev = target_masks.device
    if dev.type == "cpu":
        return find_hits_reference(target_masks, lengths, planes,
                                   suffix_planes, plen=plen, mm=mm,
                                   term=term, max_hits=max_hits)
    n, length, p = _scan_shapes("find_hits", target_masks, planes,
                                suffix_planes, plen)
    if lengths.device != dev or lengths.dtype not in (torch.int32,
                                                      torch.int64) \
            or tuple(lengths.shape) != (n,) or not lengths.is_contiguous():
        raise ValueError(
            "find_hits: lengths must be a contiguous int32 or int64 [%d] "
            "tensor on %s, got %s %s on %s" % (
                n, dev, lengths.dtype, tuple(lengths.shape), lengths.device))
    if max_hits < 0:
        raise ValueError("find_hits: max_hits must be >= 0, got %d"
                         % max_hits)
    lib = _cuda.load("find_hits")
    if dev.type != "cuda":
        raise ValueError("find_hits: unsupported device %s" % dev)
    hit_idx = torch.empty(max_hits, dtype=torch.int64, device=dev)
    mism = torch.empty(max_hits, dtype=torch.int64, device=dev)
    n_hits = torch.empty((), dtype=torch.int64, device=dev)
    # a count and an offset a block; a block is a tile of at least 16
    # windows of one row
    blocks = max(n * -(-max(length - plen + 1, 0) // 16), 1)
    counts = torch.empty(blocks, dtype=torch.int32, device=dev)
    offsets = torch.empty(blocks, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _cuda.launch(lib, "find_hits", target_masks.data_ptr(),
                     lengths.data_ptr(), int(lengths.dtype == torch.int64),
                     planes.data_ptr(), suffix_planes.data_ptr(),
                     counts.data_ptr(), offsets.data_ptr(), blocks,
                     n_hits.data_ptr(), hit_idx.data_ptr(), mism.data_ptr(),
                     n, length, p, int(plen), int(mm), int(term),
                     int(max_hits),
                     torch.cuda.current_stream(dev).cuda_stream)
    return hit_idx, n_hits, mism


def find_hits_packed(target_masks, lengths, planes, suffix_planes, *, plen,
                     mm=1, term=4, max_hits=1 << 18, want_mism=True):
    """find_hits packed into one int64 vector so the caller pays a single
    device->host copy: out[0] = n_hits, out[1:max_hits+1] = flat hit
    indices (-1 padding), out[max_hits+1:] = mismatch counts."""
    idx, n_hits, mism = find_hits(target_masks, lengths, planes,
                                  suffix_planes, plen=plen, mm=mm, term=term,
                                  max_hits=max_hits)
    parts = [n_hits.reshape(1), idx]
    if want_mism:
        parts.append(mism)
    return torch.cat(parts)


def find_hits_batched(target_masks, lengths, planes, suffix_planes, *, plen,
                      mm=1, term=4, max_hits=1 << 17, want_mism=False):
    """The whole corpus, pre-batched as uint8 mask rows [B, bs, L] with
    lengths [B, bs], in one loop on the device -> packed hit blocks
    [B, 1 + max_hits (+ max_hits)] int64, still on the device: the caller's
    copy to the host is the one sync of the scan."""
    return torch.stack([
        find_hits_packed(target_masks[b], lengths[b], planes, suffix_planes,
                         plen=plen, mm=mm, term=term, max_hits=max_hits,
                         want_mism=want_mism)
        for b in range(target_masks.shape[0])])


def safe_batch_size(requested, n_out, p, mem_bytes=3 << 30):
    """Largest batch <= requested keeping (a) the flat index space under
    2**31 and (b) one [N, n_out, p] 4-byte tensor under ``mem_bytes`` —
    the JAX package's batching, kept so both scan the same batches."""
    cap = max(1, ((1 << 31) - 1) // max(n_out * p, 1))
    mem_cap = max(1, int(mem_bytes) // max(4 * n_out * p, 1))
    return max(1, min(requested, cap, mem_cap))


def decode_packed(packed, n_out, p, max_hits):
    """Host-side decode of find_hits_packed output (with or without the
    mismatch block)."""
    packed = np.asarray(packed)
    n_hits = int(packed[0])
    idx = packed[1:max_hits + 1].astype(np.int64)
    has_mism = len(packed) > max_hits + 1
    mism_blk = packed[max_hits + 1:] if has_mism else None
    keep = idx >= 0
    idx = idx[keep]
    mism = mism_blk[keep] if has_mism else np.zeros(len(idx), np.int32)
    seq = idx // (n_out * p)
    rem = idx % (n_out * p)
    return seq, rem // p, rem % p, mism.astype(np.int32), n_hits


def find_hits_numpy(targets_1h, lengths, primers_1h, suffix_1h, *, mm=1,
                    term=4):
    """Pure NumPy scan for small workloads (identical hits).  Correlation via
    einsum over uint8 one-hots; avoids device compile latency when
    N*O*P is tiny relative to the compile cost."""
    n, length, _ = targets_1h.shape
    p, plen, _ = primers_1h.shape
    n_out = length - plen + 1
    if n_out <= 0:
        return np.empty((0, 4), np.int64)
    # One sgemm over the f32 im2col: [chunk*O, 4*plen] x [4*plen, 2P]
    # (primer and 3'-suffix weights side by side).  BLAS with K = 4*plen
    # beats einsum's two int32 [N, O, 4, plen] materialisations ~8x; match
    # counts are small ints, exact in f32.  Rows are chunked to bound the
    # im2col + accumulator working set.
    weights = np.concatenate([primers_1h, suffix_1h], axis=0).reshape(
        2 * p, plen * 4).astype(np.float32).T       # [4*plen, 2P]
    per_row = n_out * (4 * plen * 4 + 8 * p)        # bytes per target row
    chunk = max(1, min(n, (512 << 20) // max(per_row, 1)))
    out = []
    o_idx = np.arange(n_out)[None, :, None]
    for base in range(0, n, chunk):
        tc = targets_1h[base:base + chunk]
        win = np.lib.stride_tricks.sliding_window_view(
            tc, plen, axis=1)                       # [C, O, 4, plen]
        col = np.ascontiguousarray(
            win.transpose(0, 1, 3, 2), dtype=np.float32).reshape(
                -1, plen * 4)
        acc = (col @ weights).reshape(len(tc), n_out, 2 * p)
        counts = acc[:, :, :p].astype(np.int32)
        suffix = acc[:, :, p:].astype(np.int32)
        mism = plen - counts
        ok = (mism <= mm) & (suffix >= term)
        ok &= (o_idx + plen) <= lengths[base:base + chunk, None, None]
        s, o, pi = np.nonzero(ok)
        out.append(np.stack([s + base, o, pi, mism[s, o, pi]], axis=1))
    if not out:
        return np.empty((0, 4), np.int64)
    return out[0] if len(out) == 1 else np.concatenate(out, axis=0)


def decode_hits(idx, mism, n_out, p):
    """Host-side: flat indices -> (seq, window, primer, mismatches) arrays."""
    idx = np.asarray(idx)
    keep = idx >= 0
    idx = idx[keep]
    mism = np.asarray(mism)[keep]
    seq = idx // (n_out * p)
    rem = idx % (n_out * p)
    return seq, rem // p, rem % p, mism.astype(np.int32)
