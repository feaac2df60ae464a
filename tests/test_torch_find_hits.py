"""The port's find_hits and fused dimer pass against the JAX package's, on
the CPU.

The CUDA kernels of ``csrc/find_hits.cu`` and ``csrc/dimer_fired.cu`` run
only on the card, so here (a) their plain versions, which CPU tensors take,
are held to JAX's jitted ``find_hits`` (its default conv backend) and
``_fused_kernel_jit`` on the kernels' edge cases, (b) NumPy models of the
kernels' algorithms (the block tiling, counts, offsets, the sorted rounds
of a block past its list, the padding; one thread a (target, end) over a
row's window planes) are held to JAX on the same cases, and (c) the wrappers
reach the kernels' libraries off the CPU, never a plain version, and
refuse what the kernels do not take.  Hit lists and verdicts are integers
and booleans and must be equal exactly.
"""

import zlib

import numpy as np
import pytest
import torch

from multiprime_tpu.ops import dimer as jd
from multiprime_tpu.ops import mismatch_scan as jms
from multiprime_tpu_torch.ops import _cuda
from multiprime_tpu_torch.ops import dimer as td
from multiprime_tpu_torch.ops import mismatch_scan as tms


def _suffix(p1h, term):
    s1h = p1h.copy()
    if term > 0:
        s1h[:, :-term, :] = 0
    else:
        s1h[:] = 0
    return s1h


def _rand_seqs(rng, n, lo, hi, letters="ACGT"):
    lut = np.array(list(letters))
    return ["".join(rng.choice(lut, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def _planted(rng, seqs, n, plen):
    """Patterns cut from the targets with 0-3 substitutions, one in four
    with an IUPAC code."""
    lut = np.array(list("ACGT"))
    out = []
    for _ in range(n):
        s = seqs[int(rng.integers(0, len(seqs)))].upper()
        if len(s) < plen:
            out.append("".join(rng.choice(lut, size=plen)))
            continue
        o = int(rng.integers(0, len(s) - plen + 1))
        pat = list(s[o:o + plen].replace("N", "A").replace("-", "C"))
        for _ in range(int(rng.integers(0, 4))):
            pat[int(rng.integers(0, plen))] = str(rng.choice(lut))
        if rng.random() < 0.25:
            pat[int(rng.integers(0, plen))] = str(rng.choice(list("RYSWN")))
        out.append("".join(pat))
    return out


def _patterns(pats, term, pad8=True):
    p1h = jms.encode_primers(pats)
    s1h = _suffix(p1h, term)
    pad = -len(pats) % 8 if pad8 else 0
    if pad:
        z = np.zeros((pad,) + p1h.shape[1:], p1h.dtype)
        p1h, s1h = np.concatenate([p1h, z]), np.concatenate([s1h, z])
    return p1h, s1h


def find_case(name):
    """(masks uint8 [N, L], lengths int32 [N], p1h, s1h, mm, term,
    max_hits) of one edge case of the find_hits kernels."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "full_blocks":
        # about 1,500 hits in 183 windows: every 64-code block of JAX's
        # compaction full
        seqs = ["A" * 200, "A" * 150 + "C" * 50]
        p1h, s1h = _patterns(["A" * 18] * 7 + ["A" * 17 + "C"], 0)
        return (*jms.encode_target_masks(seqs), p1h, s1h, 1, 0, 1 << 12)
    if name == "dense_rows":
        # every window of four poly-A rows hits 18 patterns (the suffix
        # test drops the one with its C last): a 64-window tile holds
        # 1,152 hits, past the kernel's 1,024-entry list, and max_hits
        # falls inside a block
        seqs = ["A" * 1000] * 4 + _rand_seqs(rng, 3, 300, 1000)
        pats = ["A" * 18] + ["A" * k + "C" + "A" * (17 - k)
                             for k in range(18)]
        p1h, s1h = _patterns(pats, 1)
        return (*jms.encode_target_masks(seqs), p1h, s1h, 1, 1, 40_000)
    if name == "overflow":
        seqs = ["A" * 300] * 3 + _rand_seqs(rng, 5, 100, 300)
        pats = ["A" * 18, "A" * 9 + "C" + "A" * 8] + _planted(
            rng, seqs[3:], 6, 18)
        p1h, s1h = _patterns(pats, 2)
        return (*jms.encode_target_masks(seqs), p1h, s1h, 1, 2, 100)
    if name == "padding_rows":
        # zero-length rows between the real ones and after them
        seqs = _rand_seqs(rng, 9, 30, 260, letters="ACGTACGTN")
        p1h, s1h = _patterns(_planted(rng, seqs, 13, 20), 3)
        masks, lens = jms.encode_target_masks(seqs, length=512)
        for row in (2, 6, 7):
            masks[row], lens[row] = 0, 0
        masks = np.concatenate([masks, np.zeros((5, 512), np.uint8)])
        lens = np.concatenate([lens, np.zeros(5, lens.dtype)])
        return masks, lens, p1h, s1h, 3, 3, 1 << 12
    if name == "odd_size":
        # N * O * P = 3 * 84 * 5, no multiple of 64; P unpadded
        seqs = _rand_seqs(rng, 3, 60, 101)
        masks, lens = jms.encode_target_masks(seqs, length=101)
        p1h, s1h = _patterns(_planted(rng, seqs, 5, 18), 1, pad8=False)
        return masks, lens, p1h, s1h, 3, 1, 1 << 10
    if name == "short_rows":
        # rows shorter than plen, one exactly plen, a partial last tile
        seqs = ["ACGT", "", "ACGTACGTACGTACGTAC"] + _rand_seqs(
            rng, 6, 10, 90, letters="ACGTacgtN-")
        p1h, s1h = _patterns(["ACGTACGTACGTACGTAC"] + _planted(
            rng, seqs[3:], 10, 18), 2)
        return (*jms.encode_target_masks(seqs, length=96), p1h, s1h, 4, 2,
                1 << 12)
    if name == "term0_mm_plen":
        # term 0 and mm = plen: every window of the row hits every pattern,
        # the zero padding rows of P too
        seqs = _rand_seqs(rng, 4, 20, 70, letters="ACGTN")
        p1h, s1h = _patterns(_planted(rng, seqs, 5, 13), 0)
        return (*jms.encode_target_masks(seqs), p1h, s1h, 13, 0, 1 << 12)
    if name == "term_past_plen":
        seqs = _rand_seqs(rng, 5, 30, 200)
        p1h, s1h = _patterns(_planted(rng, seqs, 9, 13), 14)
        return (*jms.encode_target_masks(seqs), p1h, s1h, 2, 14, 64)
    # "wide": a long row, a tile cut below the row, 33-base patterns
    seqs = _rand_seqs(rng, 2, 2500, 3000, letters="ACGTACGTN")
    p1h, s1h = _patterns(_planted(rng, seqs, 21, 33), 4)
    return (*jms.encode_target_masks(seqs), p1h, s1h, 3, 4, 1 << 13)


FIND_CASES = ["full_blocks", "dense_rows", "overflow", "padding_rows",
              "odd_size", "short_rows", "term0_mm_plen", "term_past_plen",
              "wide"]


def _jax_find_hits(masks, lens, p1h, s1h, mm, term, max_hits):
    return [np.asarray(x).astype(np.int64) for x in jms.find_hits(
        masks, lens, p1h, s1h, mm=mm, term=term, max_hits=max_hits)]


@pytest.mark.parametrize("lengths_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", FIND_CASES)
def test_find_hits_plain_equals_jax(case, lengths_dtype):
    """find_hits on CPU tensors (its plain version) and find_hits_packed
    equal JAX's find_hits element for element, int32 or int64 lengths."""
    masks, lens, p1h, s1h, mm, term, max_hits = find_case(case)
    plen = p1h.shape[1]
    want = _jax_find_hits(masks, lens, p1h, s1h, mm, term, max_hits)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    tm = torch.from_numpy(masks)
    tl = torch.from_numpy(lens).to(lengths_dtype)
    got = tms.find_hits(tm, tl, planes, sfx, plen=plen, mm=mm, term=term,
                        max_hits=max_hits)
    for w, g in zip(want, got):
        assert g.dtype == torch.int64 and np.array_equal(w, g.numpy())
    packed = tms.find_hits_packed(tm, tl, planes, sfx, plen=plen, mm=mm,
                                  term=term, max_hits=max_hits)
    assert np.array_equal(np.asarray(jms.find_hits_packed(
        masks, lens, p1h, s1h, mm=mm, term=term,
        max_hits=max_hits)).astype(np.int64), packed.numpy())
    n_hits = int(want[1])
    if case == "term_past_plen":
        assert n_hits == 0 and (got[0] == -1).all()
    else:
        assert n_hits > 0
    if case in ("overflow", "dense_rows"):
        assert n_hits > max_hits


@pytest.mark.parametrize("case", ["padding_rows", "short_rows", "overflow"])
def test_find_hits_batched_plain_equals_jax(case):
    masks, lens, p1h, s1h, mm, term, max_hits = find_case(case)
    n = masks.shape[0] - masks.shape[0] % 2
    tm = masks[:n].reshape(2, n // 2, -1)
    lm = lens[:n].reshape(2, n // 2)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    for want_mism in (False, True):
        want = np.asarray(jms.find_hits_batched(
            tm, lm, p1h, s1h, mm=mm, term=term, max_hits=max_hits,
            want_mism=want_mism))
        got = tms.find_hits_batched(
            torch.from_numpy(tm), torch.from_numpy(lm), planes, sfx,
            plen=p1h.shape[1], mm=mm, term=term, max_hits=max_hits,
            want_mism=want_mism)
        assert np.array_equal(want.astype(np.int64), got.numpy())


def test_find_hits_plain_without_windows():
    """Rows shorter than plen everywhere: no window, n_hits 0, all -1."""
    masks, lens = tms.encode_target_masks(["ACGT", "AC"], length=8)
    p1h, s1h = _patterns(["ACGTACGTAC"], 2)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    idx, n_hits, mism = tms.find_hits(
        torch.from_numpy(masks), torch.from_numpy(lens), planes, sfx,
        plen=10, mm=1, term=2, max_hits=5)
    assert int(n_hits) == 0
    assert idx.tolist() == [-1] * 5 and mism.tolist() == [-1] * 5


# ---------------------------------------------------------------------------
# a NumPy model of csrc/find_hits.cu's algorithm
# ---------------------------------------------------------------------------

def tile_windows(n, n_out, sms):
    """find_hits.cu tile_windows: a whole row of windows, at most 1,024,
    halved while the grid holds fewer than 8 blocks an SM."""
    tw = min(-(-n_out // 16) * 16, 1024)
    while tw > 64 and n * -(-n_out // tw) < 8 * sms:
        tw = (tw // 2 + 15) // 16 * 16
    return tw


def kernel_model(codes, lengths, plen, max_hits, cap=1024, sms=132, seed=0):
    """The three kernels of find_hits.cu on plain hit codes [N, O, P]: each
    block's hits among its windows inside the row, listed in an arbitrary
    order; the exclusive scan of the counts; the write kernel's rounds (one
    when a block's hits fit ``cap``, else key ranges of whole rows, or of
    ``cap`` patterns of one row, each holding at most ``cap`` hits), each
    sorted and written at offset + rank below max_hits; -1 past the hits.
    -> (hit_idx, n_hits, mism, rounds per block)."""
    rng = np.random.default_rng(seed)
    n, n_out, p = codes.shape
    idx = np.full(max_hits, -2, np.int64)     # -2: never written
    mism = np.full(max_hits, -2, np.int64)
    blocks = []
    if n and n_out > 0 and p:
        tw = tile_windows(n, n_out, sms)
        n_wt = -(-n_out // tw)
        for b in range(n * n_wt):
            row, o0 = b // n_wt, (b % n_wt) * tw
            tile = min(n_out - o0, tw)
            valid = max(0, min(tile, int(lengths[row]) - plen + 1 - o0))
            r, pi = np.nonzero(codes[row, o0:o0 + valid] > 0)
            keys = (r * p + pi).astype(np.int64)
            m = codes[row, o0 + r, pi].astype(np.int64) - 1
            order = rng.permutation(len(keys))   # the atomics' order
            blocks.append(((row * n_out + o0) * p, valid, keys[order],
                           m[order], r))
    counts = np.array([len(blk[2]) for blk in blocks], np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    total = int(counts.sum())
    idx[min(total, max_hits):] = -1
    mism[min(total, max_hits):] = -1
    n_rounds = []
    for (base, valid, keys, m, r), cnt, off in zip(blocks, counts, offsets):
        rounds = 0
        if cnt == 0 or off >= max_hits:
            n_rounds.append(rounds)
            continue
        many = cnt > cap
        row_cnt = np.bincount(r, minlength=valid) if many else None
        rc, pc, done = 0, 0, 0
        while done < cnt and off + done < max_hits:
            lo, hi = 0, 1 << 62
            if many:
                lo = rc * p + pc
                if pc == 0:
                    re, s = rc, 0
                    while re < valid and s + row_cnt[re] <= cap:
                        s += row_cnt[re]
                        re += 1
                    if re > rc:
                        hi, rc = re * p, re
                    else:
                        pc = min(p, cap)
                        hi = rc * p + pc
                else:
                    pc = p if p - pc < cap else pc + cap
                    hi = rc * p + pc
                if pc == p:
                    rc, pc = rc + 1, 0
                if lo >= valid * p:
                    hi = lo
            if lo >= hi:
                break
            sel = (keys >= lo) & (keys < hi)
            assert sel.sum() <= cap, "a round lists more than the list holds"
            order = np.argsort(keys[sel], kind="stable")
            ks, ms_ = keys[sel][order], m[sel][order]
            at = off + done + np.arange(len(ks))
            keep = at < max_hits
            assert (idx[at[keep]] == -2).all(), "a slot written twice"
            idx[at[keep]] = base + ks[keep]
            mism[at[keep]] = ms_[keep]
            done += len(ks)
            rounds += 1
            if not many:
                break
        n_rounds.append(rounds)
    assert (idx != -2).all() and (mism != -2).all(), "a slot never written"
    return idx, total, mism, n_rounds


@pytest.mark.parametrize("cap,sms", [(1024, 132), (5, 132), (37, 1),
                                     (1, 132)])
@pytest.mark.parametrize("case", FIND_CASES)
def test_find_hits_kernel_model_equals_jax(case, cap, sms):
    """The kernels' algorithm gives JAX's hit list: block order is flat
    order, the rounds of a block past its list (cap 5 and 1 split rows of
    8 hits into pattern slices) cover its hits once each, in order."""
    masks, lens, p1h, s1h, mm, term, max_hits = find_case(case)
    plen = p1h.shape[1]
    want = _jax_find_hits(masks, lens, p1h, s1h, mm, term, max_hits)
    codes = np.asarray(jms.hit_codes_conv(jms.expand_masks(masks), p1h, s1h,
                                          mm=mm, term=term))
    idx, n_hits, mism, rounds = kernel_model(codes, lens, plen, max_hits,
                                             cap=cap, sms=sms)
    assert np.array_equal(idx, want[0]) and n_hits == int(want[1])
    assert np.array_equal(mism, want[2])
    if case == "dense_rows" or (case == "full_blocks" and cap < 1024):
        assert max(rounds) > 1


def test_kernel_model_tiles_like_hit_codes():
    """The tile of the find_hits kernels is hit_codes.cu's: a whole row up
    to 1,024 windows, cut while fewer than 8 blocks an SM; the specificity
    batch [16, 65,519] takes 512-window tiles, 2,048 blocks."""
    assert tile_windows(16, 65519, 132) == 512
    assert tile_windows(2048, 1007, 132) == 1008
    assert tile_windows(3, 84, 132) == 48
    assert tile_windows(7, 983, 132) == 64
    assert tile_windows(1, 5, 132) == 16


# ---------------------------------------------------------------------------
# the fused dimer pass: _fused_kernel against JAX's _fused_kernel_jit
# ---------------------------------------------------------------------------

def dimer_case(name):
    """(masks uint8 [T, L], lens int64 [T], p1h uint8 [E, lp, 4], lns,
    shifts int64 [E], z, trig bool [E, W]) of one edge case: ends planted
    at the first window and at the last one inside their target, d2
    clipped at 0 and at W - 1, zero-length padding rows, lp 64."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    lp = 64 if name == "lp64" else 24
    min_len = 5
    z = lp - min_len
    n_t, n_e = 23, 41
    lns = rng.integers(min_len, lp + 1, size=n_e)
    lns[0] = min_len                      # max(shift) = z, as JAX recovers z
    width = int(rng.integers(6, 30)) if name != "narrow_trig" else 2
    tlen = z + 40
    tlen += -tlen % 16
    lut = np.array(list("ACGT"))
    seqs = [("".join(rng.choice(lut, size=int(rng.integers(5, 41))))
             if t % 7 else "") for t in range(n_t)]    # every 7th: padding
    ends = []
    for e, ln in enumerate(lns):
        s = seqs[int(rng.integers(1, n_t))]
        if len(s) >= ln and e % 4:
            # the first window of the row, its last, or one between
            at = (0, len(s) - ln, int(rng.integers(0, len(s) - ln + 1)))[
                e % 3]
            ends.append(s[at:at + ln])
        else:
            ends.append("".join(rng.choice(lut, size=int(ln))))
    masks = np.zeros((n_t, tlen), np.uint8)
    base, lens = jms.encode_target_masks(seqs)
    masks[:, z:z + base.shape[1]] = base
    p1h = np.zeros((n_e, lp, 4), np.uint8)
    for k, e in enumerate(ends):
        p1h[k, lp - len(e):] = jms.encode_primers([e])[0]
    trig = rng.random((n_e, width)) < 0.5
    trig[:, 0] = True                       # d2 clipped to 0 fires
    trig[1::2, -1] = True                   # d2 clipped to W - 1 fires
    return (masks, lens.astype(np.int64), p1h, lns.astype(np.int64),
            (lp - lns).astype(np.int64), z, trig)


DIMER_CASES = ["lp24", "lp64", "narrow_trig"]


def _jax_fired(masks, lens, p1h, lns, shifts, trig):
    t1h = np.asarray(jms.expand_masks(masks)).astype(np.float32)
    return np.asarray(jd._fused_kernel_jit(
        t1h, lens.astype(np.int32), p1h.astype(np.float32),
        lns.astype(np.int32), shifts.astype(np.int32), trig))


def dimer_model(masks, lens, p1h, lns, shifts, z, trig):
    """csrc/dimer_fired.cu: the four bit-planes of each window of a row,
    built once (a block there), then for each (t, e) the windows from the
    first with real_o >= 0, up to the first full match or the last window
    inside the target."""
    n_t, length = masks.shape
    n_e, lp, _ = p1h.shape
    q = [[sum(int(p1h[e, k, b]) << k for k in range(lp)) for b in range(4)]
         for e in range(n_e)]
    out = np.zeros((n_t, n_e), bool)
    for t in range(n_t):
        # the four planes of each window of the row
        row = [int(c) for c in masks[t]]
        wins, w = [], [sum(((row[k] >> b) & 1) << k for k in range(lp))
                       for b in range(4)]
        for o in range(length - lp + 1):
            if o:
                w = [(w[b] >> 1) | (((row[o + lp - 1] >> b) & 1) << (lp - 1))
                     for b in range(4)]
            wins.append(w)
        for e in range(n_e):
            sh = int(shifts[e]) - z
            o = max(0, -sh)
            last = min(int(lens[t]) - int(lns[e]) - sh, length - lp)
            first = -1
            while o <= last:
                c = sum(bin(wins[o][b] & q[e][b]).count("1")
                        for b in range(4))
                if c >= lns[e]:
                    first = o
                    break
                o += 1
            if first >= 0:
                d2 = int(lens[t]) - int(lns[e]) - (first + sh)
                out[t, e] = trig[e, min(max(d2, 0), trig.shape[1] - 1)]
    return out


@pytest.mark.parametrize("case", DIMER_CASES)
def test_fused_kernel_plain_and_model_equal_jax(case):
    masks, lens, p1h, lns, shifts, z, trig = dimer_case(case)
    want = _jax_fired(masks, lens, p1h, lns, shifts, trig)
    got = td._fused_kernel(
        torch.from_numpy(masks), torch.from_numpy(lens),
        tms.pattern_planes(p1h, device="cpu"), p1h.shape[1], z,
        torch.from_numpy(lns), torch.from_numpy(shifts),
        torch.from_numpy(trig))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert np.array_equal(dimer_model(masks, lens, p1h, lns, shifts, z, trig),
                          want)
    assert want.any() and not want[lens == 0].any()


# ---------------------------------------------------------------------------
# the wrappers off the CPU: the kernel's library or a refusal, never the
# plain version
# ---------------------------------------------------------------------------

class Sentinel(Exception):
    pass


@pytest.fixture
def no_plain(monkeypatch):
    """_cuda.load raises Sentinel(name) and records it; the plain versions
    fail the test if they run."""
    loaded = []

    def load(name):
        loaded.append(name)
        raise Sentinel(name)

    def plain(*a, **kw):
        raise AssertionError("a plain version ran off the CPU")

    monkeypatch.setattr(_cuda, "load", load)
    monkeypatch.setattr(tms, "find_hits_reference", plain)
    monkeypatch.setattr(td, "_fused_kernel_reference", plain)
    return loaded


def _meta_scan_inputs():
    meta = torch.device("meta")
    return (torch.zeros((4, 64), dtype=torch.uint8, device=meta),
            torch.zeros(4, dtype=torch.int32, device=meta),
            torch.zeros((8, 4), dtype=torch.int64, device=meta))


def test_find_hits_launches_or_raises_off_the_cpu(no_plain):
    masks, lens, planes = _meta_scan_inputs()
    kw = dict(plen=18, mm=1, term=1, max_hits=16)
    for call in (
            lambda: tms.find_hits(masks, lens, planes, planes, **kw),
            lambda: tms.find_hits(masks, lens.long(), planes, planes, **kw),
            lambda: tms.find_hits_packed(masks, lens, planes, planes, **kw),
            lambda: tms.find_hits_batched(masks[None], lens[None], planes,
                                          planes, **kw)):
        with pytest.raises(Sentinel):
            call()
    assert no_plain == ["find_hits"] * 4
    # without a card, the library's build raises (no nvcc) or the device
    # does: no hit list ever comes back off the CPU
    bad = [("target_masks", masks.to(torch.int32), lens, planes, planes, 18),
           ("target_masks", masks[:, ::2], lens, planes, planes, 18),
           ("target_masks", masks[0], lens, planes, planes, 18),
           ("planes", masks, lens, planes.to(torch.int32), planes, 18),
           ("planes", masks, lens, planes[:, :2].contiguous(), planes, 18),
           ("suffix_planes", masks, lens, planes, planes[:4], 18),
           ("lengths", masks, lens.float(), planes, planes, 18),
           ("lengths", masks, lens[:3], planes, planes, 18),
           ("lengths", masks, lens[None], planes, planes, 18),
           ("plen", masks, lens, planes, planes, 64),
           ("plen", masks, lens, planes, planes, 0)]
    for what, m, ln, q, s, plen in bad:
        with pytest.raises(ValueError, match=what):
            tms.find_hits(m, ln, q, s, plen=plen, mm=1, term=1, max_hits=16)
    with pytest.raises(ValueError, match="max_hits"):
        tms.find_hits(masks, lens, planes, planes, plen=18, mm=1, term=1,
                      max_hits=-1)
    assert no_plain == ["find_hits"] * 4


def test_dimer_fired_launches_or_raises_off_the_cpu(no_plain):
    meta = torch.device("meta")
    masks = torch.zeros((6, 48), dtype=torch.uint8, device=meta)
    lens = torch.zeros(6, dtype=torch.int64, device=meta)
    planes = torch.zeros((9, 4), dtype=torch.int64, device=meta)
    vec = torch.zeros(9, dtype=torch.int64, device=meta)
    trig = torch.zeros((9, 25), dtype=torch.bool, device=meta)
    with pytest.raises(Sentinel):
        td._fused_kernel(masks, lens, planes, 24, 19, vec, vec, trig)
    assert no_plain == ["dimer_fired"]
    bad = [("masks", masks.to(torch.int32), lens, planes, vec, trig, 24),
           ("lens", masks, lens.int(), planes, vec, trig, 24),
           ("planes", masks, lens, planes.float(), vec, trig, 24),
           ("ln_vec", masks, lens, planes, vec[None], trig, 24),
           ("trig", masks, lens, planes, vec, trig.to(torch.uint8), 24),
           ("lens must be", masks, lens[:5], planes, vec, trig, 24),
           ("lens must be", masks, lens, planes[:8], vec, trig, 24),
           ("lp must be", masks, lens, planes, vec, trig, 65),
           ("lp must be", masks, lens, planes, vec, trig[:, :0], 24)]
    for what, m, ln, q, v, tr, lp in bad:
        with pytest.raises(ValueError, match=what):
            td._fused_kernel(m, ln, q, lp, 19, v, v, tr)
    assert no_plain == ["dimer_fired"]
