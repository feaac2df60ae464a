"""Banded identities of many (query, representative) pairs in one launch:
the greedy clusterer's alignments on the card.

``greedy.greedy_cluster_windows`` hands a window's pairs here.  Each pair
is the DP of ``native.banded_identity`` (seqlib.cpp:51-105, the JAX
package's NumPy ``greedy.banded_identity``): a banded affine global
alignment of the shorter sequence against the longer, (score, matches)
maximised lexicographically.  The result is each pair's match count on
its best alignment, or -1 where native returns 0.0 before dividing (an
empty sequence, an end cell at NEG); ``identities`` divides by the
shorter length in float64 as native does, so the identities are equal
to the bit.

* ``banded_matches`` launches ``csrc/banded_identity.cu`` for CUDA tensors
  (one warp a pair): the register kernel for bands of up to
  ``_MAX_WIDTH`` cells, the wide kernel (the band in chunks through a
  scratch row) for the rest.  CPU tensors take the plain version
  ``banded_matches_reference``: a loop over rows of ~25 vector ops on
  ``[pairs, width]`` lanes, the within-row E state folded into
  ``torch.cummax``, in the kernel's key type.
* ``identity_plan`` gives a launch's cells a lane and key width from the
  pairs' lengths; ``kernel_takes`` says whether a pair's keys fit at all.
* ``resolve_clustering`` decides once a job where its clustering runs.

The keys (see the kernel's source note): 32-bit with S = 2**bitlen(max la)
and NEG = -2**30 while (la + lb + width + 19) * S <= 2**30 for every
pair, else 64-bit with native's S = 2**20 and NEG = -2**40; either orders
(score, matches) exactly as native's int64 key does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _cuda

# the register kernel's cells a lane (its instantiations in
# csrc/banded_identity.cu) and the widest band it takes: 32 lanes of the
# largest; the wide kernel's cells a chunk, and its scratch a launch
_KS = (4, 8, 12, 16, 24, 32)
_MAX_WIDTH = 32 * _KS[-1]
_WIDE_CHUNK = 256
_WIDE_SCRATCH_BYTES = 1 << 28
_NEG32 = -(1 << 30)
_NEG64 = -(1 << 40)
_SHIFT64 = 20
# a's codes of 4 or more and b's past its ends: never equal to a code
_NO_MATCH_A = 1000
_NO_MATCH_B = 2000


def _width(la, lb, band):
    """Cells of a pair's band: 2 band + |lb - la| + 1."""
    return 2 * band + np.abs(np.subtract(lb, la)) + 1


def _span(la, lb, band):
    """la + lb + width + 19: the key's range over S (see above)."""
    return np.add(la, lb) + _width(la, lb, band) + 19


def band_cells(la, lb, band):
    """DP cells of pairs of lengths ``la``, ``lb``: the shorter's rows
    times the band's width."""
    return np.minimum(la, lb) * _width(la, lb, band)


def kernel_takes(la, lb, band):
    """Whether the kernels take a pair of lengths ``la``, ``lb``: its keys
    inside native's 64-bit packing (la + lb + width + 19 < 2**20, which is
    2 max(la, lb) + 2 band + 20 < 2**20: sequences up to about 524 kb)."""
    return bool(_span(la, lb, band) < 1 << _SHIFT64)


def identity_plan(la, lb, band):
    """(cells a lane K, key bits, shift) of a launch over pairs of lengths
    ``la``, ``lb`` (non-empty arrays, each pair taken by ``kernel_takes``):
    K the smallest of ``_KS`` with 32 K >= the widest band, None where the
    band is wider than ``_MAX_WIDTH`` (the wide kernel); 32-bit keys with
    S = 2**bitlen(max shorter length) while (la + lb + width + 19) S <=
    2**30 for every pair, else 64-bit keys with S = 2**20."""
    la = np.asarray(la, np.int64)
    lb = np.asarray(lb, np.int64)
    width = int(_width(la, lb, band).max())
    k = next((k for k in _KS if 32 * k >= width), None)
    shift = int(np.minimum(la, lb).max()).bit_length()
    if int(_span(la, lb, band).max()) << shift <= 1 << 30:
        return k, 32, shift
    return k, 64, _SHIFT64


def banded_matches_reference(codes, meta, band):
    """Plain PyTorch version of the kernel, on ``codes``' device: the same
    keys, rows and prefix max, every pair a lane of ``[P, width]`` tensors
    -> int32 [P] matches (or -1)."""
    dev = codes.device
    meta = np.asarray(meta, np.int64)
    p = meta.shape[1]
    if p == 0:
        return torch.empty((0,), dtype=torch.int32, device=dev)
    _, bits, shift = identity_plan(meta[1], meta[3], band)
    dtype = torch.int32 if bits == 32 else torch.int64
    neg = _NEG32 if bits == 32 else _NEG64
    s = 1 << shift
    ext, opn, hit, miss = -s, -6 * s, 2 * s + 1, -2 * s
    q_off, q_len, r_off, r_len = torch.from_numpy(meta).to(dev)
    # a: the shorter of each pair (the query where the lengths tie)
    swap = q_len > r_len
    a_off = torch.where(swap, r_off, q_off)
    b_off = torch.where(swap, q_off, r_off)
    la = torch.minimum(q_len, r_len)
    lb = torch.maximum(q_len, r_len)
    width = 2 * band + (lb - la) + 1
    wmax = int(width.max())
    la_max = int(la.max())
    w = torch.arange(wmax, dtype=torch.int64, device=dev)
    codes32 = codes.to(torch.int32)
    # a's codes [P, la_max] (codes of 4 or more never match); b's codes by
    # row and cell: b[i + w - band] at column i + w of b_ext
    ia = torch.arange(max(la_max, 1), dtype=torch.int64, device=dev)
    a_in = ia[None, :] < la[:, None]
    a_mat = codes32[torch.where(a_in, a_off[:, None] + ia[None, :], 0)]
    a_mat = torch.where(a_in & (a_mat < 4), a_mat, _NO_MATCH_A)
    ib = torch.arange(la_max + wmax, dtype=torch.int64, device=dev) - band
    b_in = (ib[None, :] >= 0) & (ib[None, :] < lb[:, None])
    b_ext = torch.where(
        b_in, codes32[torch.where(b_in, b_off[:, None] + ib[None, :], 0)],
        _NO_MATCH_B)
    in_band = w[None, :] < width[:, None]
    j0 = w[None, :] - band
    v = torch.where(j0 == 0, 0, torch.where((j0 >= 1) & (j0 <= lb[:, None]),
                                            opn + ext * j0, neg))
    v = torch.where(in_band, v, neg).to(dtype)
    f = torch.full((p, wmax), neg, dtype=dtype, device=dev)
    neg_col = torch.full((p, 1), neg, dtype=dtype, device=dev)
    t_off = (opn - ext * w).to(dtype)
    e_off = (ext * w).to(dtype)
    la_min = int(la.min())
    for i in range(la_max):
        j = i + 1 + w[None, :] - band
        valid = (j >= 0) & (j <= lb[:, None]) & in_band
        fc = torch.maximum(torch.cat([f[:, 1:], neg_col], 1) + ext,
                           torch.cat([v[:, 1:], neg_col], 1) + (opn + ext))
        sub = torch.where(b_ext[:, i:i + wmax] == a_mat[:, i:i + 1],
                          hit, miss).to(dtype)
        vert = torch.maximum(fc, v + sub)
        if i < band:        # column 0 lies in the band: no diagonal there
            vert = torch.where(j >= 1, vert, fc)
        t = torch.where(valid, vert + t_off, neg)
        run = torch.cat([neg_col, torch.cummax(t, 1).values[:, :-1]], 1)
        v_new = torch.where(valid, torch.maximum(vert, run + e_off), neg)
        f_new = torch.where(valid, fc, neg)
        if i < la_min:
            v, f = v_new, f_new
        else:               # pairs past their last row keep it
            live = (i < la)[:, None]
            v = torch.where(live, v_new, v)
            f = torch.where(live, f_new, f)
    key = v[torch.arange(p, device=dev), lb - la + band].to(torch.int64)
    got = torch.where((key <= neg) | (la == 0), -1, key & (s - 1))
    return got.to(torch.int32)


def banded_matches(codes, meta, band):
    """Match counts of a batch of pairs of ``codes`` (int8 [total], on the
    device) -> int32 [P] on that device: each pair's matches on its best
    banded alignment, -1 where native returns 0.0 before dividing.
    ``meta`` (host int64 [4, P]) holds each pair's query offset, query
    length, representative offset and representative length, every pair
    taken by ``kernel_takes``.

    A CUDA ``codes`` launches ``csrc/banded_identity.cu`` (or raises), one
    warp a pair: the pairs whose band fits the register kernel in one
    launch, the wider ones in launches of the wide kernel, each with a
    scratch of at most ``_WIDE_SCRATCH_BYTES``; a CPU ``codes`` takes the
    plain version."""
    dev = codes.device
    if dev.type == "cpu":
        return banded_matches_reference(codes, meta, band)
    _cuda.check_inputs("banded_matches", dev,
                       (("codes", codes, torch.int8, 1),))
    meta = np.ascontiguousarray(meta, np.int64)
    if meta.ndim != 2 or meta.shape[0] != 4:
        raise ValueError("banded_matches: meta must be [4, P], got %s"
                         % (meta.shape,))
    if (_span(meta[1], meta[3], band) >= 1 << _SHIFT64).any():
        raise ValueError("banded_matches: a pair's keys pass native's "
                         "64-bit packing (a sequence past about 524 kb)")
    lib = _cuda.load("banded_identity")
    if dev.type != "cuda":
        raise ValueError("banded_matches: unsupported device %s" % dev)
    p = meta.shape[1]
    out = torch.empty((p,), dtype=torch.int32, device=dev)
    if p == 0:
        return out
    width = _width(meta[1], meta[3], band)
    wide = np.flatnonzero(width > _MAX_WIDTH)
    with torch.cuda.device(dev):
        if wide.size == 0:
            _launch_narrow(lib, codes, meta, band, out)
            return out
        narrow = np.flatnonzero(width <= _MAX_WIDTH)
        for idx, run in ((narrow, _launch_narrow), (wide, _launch_wide)):
            if idx.size:
                part = torch.empty((idx.size,), dtype=torch.int32,
                                   device=dev)
                run(lib, codes, np.ascontiguousarray(meta[:, idx]), band,
                    part)
                out[torch.from_numpy(idx).to(dev)] = part
    return out


def _launch_narrow(lib, codes, meta, band, out):
    """One launch of the register kernel over ``meta``'s pairs."""
    k, bits, shift = identity_plan(meta[1], meta[3], band)
    meta_d = torch.from_numpy(meta).to(codes.device)
    _cuda.launch(lib, "banded_identity", codes.data_ptr(), meta_d.data_ptr(),
                 meta.shape[1], band, shift, bits, k, out.data_ptr(),
                 torch.cuda.current_stream(codes.device).cuda_stream)


def _launch_wide(lib, codes, meta, band, out):
    """The wide kernel over ``meta``'s pairs, in launches whose scratch
    rows (V and F of each pair's band, a stride of whole chunks of the
    launch's widest band) fit ``_WIDE_SCRATCH_BYTES``."""
    dev = codes.device
    _, bits, shift = identity_plan(meta[1], meta[3], band)
    dtype = torch.int32 if bits == 32 else torch.int64
    stride = -(-int(_width(meta[1], meta[3], band).max())
               // _WIDE_CHUNK) * _WIDE_CHUNK
    step = max(_WIDE_SCRATCH_BYTES // (2 * stride * (bits // 8)), 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, meta.shape[1], step):
        part = np.ascontiguousarray(meta[:, lo:lo + step])
        n = part.shape[1]
        meta_d = torch.from_numpy(part).to(dev)
        scratch = torch.empty((n, 2, stride), dtype=dtype, device=dev)
        _cuda.launch(lib, "banded_identity_wide", codes.data_ptr(),
                     meta_d.data_ptr(), n, band, shift, bits, stride,
                     scratch.data_ptr(), out[lo:lo + n].data_ptr(), stream)


def resolve_clustering(lengths, threads, band=64, k=10, threshold=0.7,
                       word_filter_slack=1.0):
    """Where a job's greedy clustering runs, decided once: "host" (the
    serial walk, ``greedy.greedy_cluster``) or "device" (the windowed walk
    with every window on the card); MPTPU_FORCE_BACKEND overrides.

    The estimate takes a lower bound of the walk's pairs from the
    sequences' ``lengths``: each sequence but the longest aligned against
    one representative of its length, and, where the word filter cannot
    reject unrelated sequences of its length ((L - k + 1)**2 / 4**k shared
    k-mers expected against its need), against one more.  The host aligns
    a query's pairs on min(``threads``, its pairs) native threads, as the
    serial walk's waves do; the card pays its start-up once (the CUDA
    context, the kernel library), a launch per full window of pairs with
    its longest pair's rows, and the cells at its rate (utils/link.py)."""
    from ..utils import link as linkmod
    from . import greedy
    forced = linkmod.forced_backend()
    if forced is not None:
        return forced
    lens = np.sort(np.asarray(lengths, np.int64))[::-1][1:]
    if lens.size == 0:
        return "host"
    kmers = np.maximum(lens - k + 1, 1).astype(np.float64)
    need = 0.25 * threshold ** k * kmers / word_filter_slack
    pairs = 1 + (kmers * kmers / 4.0 ** k >= need)
    cells = pairs * band_cells(lens, lens, band)
    t_host = sum(linkmod.est_host_identity_s(float(cells[pairs == n].sum()),
                                             min(int(threads), n))
                 for n in (1, 2))
    launches = max(-(-int(pairs.sum()) // greedy._WINDOW_PAIRS),
                   -(-int(cells.sum()) // greedy._WINDOW_CELLS))
    t_dev = (linkmod.device_startup_s(kernels=("banded_identity",))
             + linkmod.est_device_identity_s(float(cells.sum()),
                                             int(lens[0]), launches))
    return "device" if t_dev < t_host else "host"


def identities(matches, meta):
    """Native's identities from the match counts of ``meta``'s pairs: m /
    min(la, lb) in float64, 0.0 where m is -1."""
    shorter = np.minimum(meta[1], meta[3])
    return [m / s if m >= 0 else 0.0
            for m, s in zip(np.asarray(matches).tolist(), shorter.tolist())]
