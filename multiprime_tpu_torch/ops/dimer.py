"""Batched all-vs-all primer-dimer matrix on the device.

PyTorch port of multiprime_tpu/ops/dimer.py.  The reference's finDimer /
get_Maxprimerset dimer examinations are O(N^2) host string searches: every
3'-end suffix of every primer is searched (as a reverse complement) inside
every other primer (finDimer.py:191-224, get_Maxprimerset.py:193-215).
Here the search is an exact-match correlation on the card:

1. expand primers and their 3'-end suffixes; group ends by length;
2. one match-count pass (``mismatch_scan.match_counts_kernel``, the CUDA
   kernel ``csrc/match_counts.cu``) of RC(ends) against the expanded
   primer set gives every occurrence with its offset;
3. the Loss / dG verdict depends only on (end, d2), precomputed per end as
   a trigger table over d2 = len(primer) - len(end) - offset;
4. the epilogue (first occurrence, d2, trigger gather) runs on the device,
   and only the fired (target, end) pairs reach the host, which ORs them
   into the directional matrix hit[i, j] = "some 3'-end of primer i dimers
   inside primer j".

``dimer_hit_matrix`` runs one match-count pass per end length and pattern
batch, its epilogue as torch ops; ``dimer_hit_matrix_fused`` one pass per
(target, end) bucket over all end lengths at once, ``_fused_kernel``: the
CUDA kernel ``csrc/dimer_fired.cu`` for CUDA tensors (counts, first
occurrence and verdict in one thread a pair, no [T, O, E] tensor), its
plain version ``_fused_kernel_reference`` (match counts + torch epilogue)
for CPU tensors.  Both agree verdict for verdict with the host search
``verify_against_host``.  The production path of the pipeline stays the
host index of validate/findimer.py; this module is the device formulation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..thermo import exact as thermo
from ..utils import iupac
from ..utils import link as linkmod
from . import _cuda
from . import mismatch_scan as ms


def expanded_ends(primer, min_len=5, max_len=None, include_full=True):
    """Expanded 3'-end suffixes with their source lengths.

    finDimer uses suffix lengths 5..(5+14) of the (adaptor+)primer
    (finDimer.py:162-169); get_Maxprimerset uses 5..len-1
    (get_Maxprimerset.py:149-154) — pick via include_full/max_len.
    """
    out = []
    top = len(primer) if include_full else len(primer) - 1
    if max_len is not None:
        top = min(top, max_len)
    for ln in range(min_len, top + 1):
        for e in iupac.expand(primer[-ln:]):
            out.append(e)
    return out


def _trigger_row(end, plen, threshold, linear):
    """Boolean over d2 in [0, plen]: does a hit of `end` at distance d2
    trigger the dimer verdict?"""
    gc = end.count("G") + end.count("C")
    dg = thermo.delta_g(end, both_ends=True)
    row = np.zeros(plen + 1, bool)
    for d2 in range(plen + 1):
        if linear:
            loss = thermo.penalty_points_linear(len(end), gc, 0, d2)
        else:
            loss = thermo.penalty_points(len(end), gc, 0, d2)
        row[d2] = loss >= threshold or (dg < -5 and d2 == 0)
    return row


def _trigger_rows(ends, plen, threshold, linear):
    """bool [E, plen + 1]: the trigger row of each end, each distinct end
    computed once."""
    cache = {}
    rows = []
    for e in ends:
        if e not in cache:
            cache[e] = _trigger_row(e, plen, threshold, linear)
        rows.append(cache[e])
    return np.stack(rows)


def _expanded_targets(primers):
    """Every expansion of every primer, with the index of its primer."""
    tgt_exp, tgt_owner = [], []
    for j, pr in enumerate(primers):
        for e in iupac.expand(pr):
            tgt_exp.append(e)
            tgt_owner.append(j)
    return tgt_exp, np.array(tgt_owner)


def _primer_ends(primers, min_len, end_max_len, include_full):
    """(owner, end) for each distinct expanded end of each primer, in the
    reference's order."""
    pairs = []
    for i, pr in enumerate(primers):
        seen = set()
        for e in expanded_ends(pr, min_len, end_max_len, include_full):
            if e not in seen:
                seen.add(e)
                pairs.append((i, e))
    return pairs


def _fired(ok, d2_offset, trig):
    """The verdict epilogue, on ok's device: ok bool [T, O, E] marks full
    matches of end e at window o of target t.  The reference evaluates only
    str.find's FIRST occurrence (finDimer.py:198-207), so the first window
    gives d2 = d2_offset - first (clipped to the trigger row), and the end's
    trigger row at d2 decides -> fired bool [T, E]."""
    exists = ok.any(dim=1)                                  # [T, E]
    first = ok.to(torch.uint8).argmax(dim=1)                # first True
    d2 = (d2_offset - first).clamp(0, trig.shape[1] - 1)
    e_idx = torch.arange(trig.shape[0], device=trig.device)
    return exists & trig[e_idx[None, :], d2]


def _mark(hit, fired, owners, tgt_owner):
    """OR the fired (target, end) pairs into the host matrix."""
    t_idx, e_idx = (x.cpu().numpy() for x in torch.nonzero(fired,
                                                           as_tuple=True))
    if len(t_idx):
        hit[owners[e_idx], tgt_owner[t_idx]] = True


def dimer_hit_matrix(primers, threshold=3.96, linear=False, min_len=5,
                     include_full=True, end_max_len=None, batch_patterns=512,
                     device="cuda"):
    """-> bool [P, P]: hit[i, j] = some 3'-end of primers[i] dimer-hits
    primers[j] (directional, includes i == j).  One match-count pass per
    end length and batch of ``batch_patterns`` ends."""
    dev = linkmod.resolve_device(device)
    p_count = len(primers)
    tgt_exp, tgt_owner = _expanded_targets(primers)
    max_plen = max(len(t) for t in tgt_exp)
    # the strict codes: one base bit per position, ambiguity codes 0, as
    # the one-hots of encode_targets
    codes, lengths = ms.encode_target_codes(tgt_exp)
    masks = torch.from_numpy(codes).to(dev)
    lens = torch.from_numpy(lengths).to(dev).long()

    ends_by_len = {}
    for i, e in _primer_ends(primers, min_len, end_max_len, include_full):
        ends_by_len.setdefault(len(e), []).append((i, e))

    hit = np.zeros((p_count, p_count), bool)
    for ln, pairs in sorted(ends_by_len.items()):
        if ln > max_plen:
            continue
        owners = np.array([i for i, _ in pairs])
        patterns = [iupac.rc(e) for _, e in pairs]
        triggers = torch.from_numpy(_trigger_rows(
            [e for _, e in pairs], max_plen, threshold, linear)).to(dev)
        n_out = codes.shape[1] - ln + 1
        # valid window inside each target
        valid = (torch.arange(n_out, device=dev)[None, :] + ln) \
            <= lens[:, None]                                # [T, O]
        for lo in range(0, len(patterns), batch_patterns):
            planes = ms.pattern_planes(
                ms.encode_primers(patterns[lo:lo + batch_patterns]),
                device=dev)
            counts = ms.match_counts_kernel(masks, planes, plen=ln)
            full = (counts >= ln) & valid[:, :, None]      # [T, O, E]
            fired = _fired(full, (lens - ln)[:, None],
                           triggers[lo:lo + batch_patterns])
            _mark(hit, fired, owners[lo:lo + batch_patterns], tgt_owner)
    return hit


def _fused_kernel_reference(masks, lens, planes, lp, z, ln_vec, shift_vec,
                            trig):
    """Plain PyTorch version of the dimer_fired kernel: the plain match
    counts [T, O, E] and the verdict epilogue as torch ops."""
    counts = ms.match_counts_reference(masks, planes, plen=lp)  # [T, O, E]
    o = torch.arange(counts.shape[1], device=counts.device)[None, :, None]
    real_o = o + (shift_vec - z)[None, None, :]                # [1, O, E]
    ok = counts >= ln_vec[None, None, :]
    ok &= real_o >= 0
    ok &= (real_o + ln_vec[None, None, :]) <= lens[:, None, None]
    # d2 = len - ln - (first + shift - z)
    d2_offset = lens[:, None] - (ln_vec + shift_vec - z)[None, :]
    return _fired(ok, d2_offset, trig)


def _fused_kernel(masks, lens, planes, lp, z, ln_vec, shift_vec, trig):
    """One uniform-shape pass over ALL end lengths -> fired bool [T, E].

    Patterns are left-padded with zero columns to a common length ``lp``
    (zero columns add 0 to the count, so a count equal to the end's true
    length is still a full match); targets are left-padded by ``z`` = lp -
    min_len blank positions so every real offset stays reachable for every
    pattern shift: real_offset = o + shift - z (shift = lp - len(end)).

    masks uint8 [T, L], lens int64 [T], planes int64 [E, 4], ln_vec and
    shift_vec int64 [E], trig bool [E, W].  CUDA tensors launch the CUDA
    kernel ``csrc/dimer_fired.cu`` (or raise); CPU tensors take the plain
    version.
    """
    dev = masks.device
    if dev.type == "cpu":
        return _fused_kernel_reference(masks, lens, planes, lp, z, ln_vec,
                                       shift_vec, trig)
    _cuda.check_inputs("dimer_fired", dev, (
        ("masks", masks, torch.uint8, 2), ("lens", lens, torch.int64, 1),
        ("planes", planes, torch.int64, 2),
        ("ln_vec", ln_vec, torch.int64, 1),
        ("shift_vec", shift_vec, torch.int64, 1),
        ("trig", trig, torch.bool, 2)))
    n_t, length = masks.shape
    n_e, width = trig.shape
    if tuple(lens.shape) != (n_t,) or tuple(planes.shape) != (n_e, 4) \
            or tuple(ln_vec.shape) != (n_e,) \
            or tuple(shift_vec.shape) != (n_e,):
        raise ValueError(
            "dimer_fired: lens must be [T], planes [E, 4], ln_vec and "
            "shift_vec [E] for masks [T, L] = %s and trig [E, W] = %s; got "
            "%s, %s, %s, %s" % (tuple(masks.shape), tuple(trig.shape),
                                tuple(lens.shape), tuple(planes.shape),
                                tuple(ln_vec.shape), tuple(shift_vec.shape)))
    if not 1 <= lp <= ms.MAX_COUNT_PLEN or width < 1:
        raise ValueError("dimer_fired: lp must be in 1..%d and trig have a "
                         "column, got lp %d, W %d"
                         % (ms.MAX_COUNT_PLEN, lp, width))
    lib = _cuda.load("dimer_fired")
    if dev.type != "cuda":
        raise ValueError("dimer_fired: unsupported device %s" % dev)
    fired = torch.empty((n_t, n_e), dtype=torch.bool, device=dev)
    if fired.numel() == 0:
        return fired
    with torch.cuda.device(dev):
        _cuda.launch(lib, "dimer_fired",
                     masks.data_ptr(), lens.data_ptr(), planes.data_ptr(),
                     ln_vec.data_ptr(), shift_vec.data_ptr(),
                     trig.data_ptr(), fired.data_ptr(), n_t, length, n_e,
                     width, int(lp), int(z),
                     torch.cuda.current_stream(dev).cuda_stream)
    return fired


def fused_layout(primers, threshold=3.96, linear=False, min_len=5,
                 include_full=True, end_max_len=None):
    """Host side of dimer_hit_matrix_fused, or None when no primer has an
    end: a dict of the expanded targets' masks uint8 [T, t_len] (left-padded
    by z blanks) and lengths, the ends' RC patterns as one-hots uint8
    [E, lp, 4] (left-padded with zero columns to lp, a multiple of 8), their
    lengths, shifts, owners and trigger rows, and lp, z."""
    tgt_exp, tgt_owner = _expanded_targets(primers)
    max_plen = max(len(t) for t in tgt_exp)
    pairs = _primer_ends(primers, min_len, end_max_len, include_full)
    if not pairs:
        return None
    ends = [e for _, e in pairs]
    lns = np.array([len(e) for e in ends], np.int32)
    lp = int(lns.max())
    lp += -lp % 8
    z = lp - min_len
    t_len = z + max_plen
    t_len += -t_len % 16
    codes, lengths = ms.encode_target_codes(tgt_exp)
    masks = np.zeros((len(tgt_exp), t_len), np.uint8)
    masks[:, z:z + codes.shape[1]] = codes
    # "-" encodes to the zero column
    p1h = ms.encode_primers(["-" * (lp - len(e)) + iupac.rc(e)
                             for e in ends])
    return {"masks": masks, "lengths": lengths, "tgt_owner": tgt_owner,
            "p1h": p1h, "lns": lns, "shifts": lp - lns,
            "owners": np.array([i for i, _ in pairs]),
            "trig": _trigger_rows(ends, max_plen, threshold, linear),
            "lp": lp, "z": z}


def dimer_hit_matrix_fused(primers, threshold=3.96, linear=False, min_len=5,
                           include_full=True, end_max_len=None,
                           t_bucket=1024, e_bucket=4096, device="cuda"):
    """dimer_hit_matrix with one pass per bucket of ``t_bucket`` expanded
    targets x ``e_bucket`` ends over every end length at once.  Identical
    verdicts to dimer_hit_matrix / the host scan.  The JAX package pads the
    buckets to a coarse grid to reuse compiled shapes; eager PyTorch
    compiles nothing, so the buckets here are not padded (padding rows
    never fire)."""
    dev = linkmod.resolve_device(device)
    p_count = len(primers)
    hit = np.zeros((p_count, p_count), bool)
    lay = fused_layout(primers, threshold, linear, min_len, include_full,
                       end_max_len)
    if lay is None:
        return hit
    lp, z = lay["lp"], lay["z"]
    if lp > ms.MAX_COUNT_PLEN:
        raise ValueError(
            "dimer_hit_matrix_fused: ends pad to %d nt, above the %d of the "
            "dimer_fired kernel; pass end_max_len" % (lp, ms.MAX_COUNT_PLEN))
    masks = torch.from_numpy(lay["masks"]).to(dev)
    lens = torch.from_numpy(lay["lengths"]).to(dev).long()
    planes = ms.pattern_planes(lay["p1h"], device=dev)
    ln_vec = torch.from_numpy(lay["lns"]).to(dev).long()
    shift_vec = torch.from_numpy(lay["shifts"]).to(dev).long()
    trig = torch.from_numpy(lay["trig"]).to(dev)
    owners, tgt_owner = lay["owners"], lay["tgt_owner"]
    n_t, e_total = masks.shape[0], planes.shape[0]
    tb = min(t_bucket, ms.safe_batch_size(
        t_bucket, masks.shape[1] - lp + 1, e_bucket))
    for elo in range(0, e_total, e_bucket):
        e_sl = slice(elo, min(elo + e_bucket, e_total))
        for tlo in range(0, n_t, tb):
            t_sl = slice(tlo, min(tlo + tb, n_t))
            fired = _fused_kernel(masks[t_sl], lens[t_sl], planes[e_sl], lp,
                                  z, ln_vec[e_sl], shift_vec[e_sl],
                                  trig[e_sl])
            _mark(hit, fired, owners[e_sl], tgt_owner[t_sl])
    return hit


def verify_against_host(primers, threshold=3.96, linear=False):
    """Cross-check helper: host finDimer-style directional verdicts."""
    out = np.zeros((len(primers), len(primers)), bool)
    for i, pr in enumerate(primers):
        ends = expanded_ends(pr)
        for j, other in enumerate(primers):
            found = False
            for e in ends:
                rce = iupac.rc(e)
                for pexp in iupac.expand(other):
                    idx = pexp.find(rce)
                    if idx >= 0:
                        d2 = len(pexp) - len(e) - idx
                        if linear:
                            loss = thermo.penalty_points_linear(
                                len(e), e.count("G") + e.count("C"), 0, d2)
                        else:
                            loss = thermo.penalty_points(
                                len(e), e.count("G") + e.count("C"), 0, d2)
                        dg = thermo.delta_g(e, both_ends=True)
                        if loss >= threshold or (dg < -5 and d2 == 0):
                            found = True
                            break
                if found:
                    break
            out[i, j] = found
    return out
