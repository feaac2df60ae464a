"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: these skip where torch.cuda.is_available() is False.  This
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import IDENTITY, launched
from multiprime_tpu_torch.ops import _cuda
from multiprime_tpu_torch.ops import dimer
from multiprime_tpu_torch.ops import mismatch_scan as ms
from multiprime_tpu_torch.validate import scan as vscan

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _inputs(rng, n, lo, hi, n_pat, plen, term, letters="ACGTacgtNRY-"):
    lut = np.array(list(letters))
    seqs = ["".join(rng.choice(lut, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]
    pats = []
    for _ in range(n_pat):
        s = seqs[int(rng.integers(0, n))].upper()
        if len(s) < plen:
            s = "ACGT" * plen
        o = int(rng.integers(0, len(s) - plen + 1))
        pat = list(s[o:o + plen].replace("N", "A").replace("-", "G"))
        for _ in range(int(rng.integers(0, 4))):
            pat[int(rng.integers(0, plen))] = str(rng.choice(list("ACGTRS")))
        pats.append("".join(pat))
    pats[0] = "N" * plen
    p1h = ms.encode_primers(pats)
    s1h = p1h.copy()
    if term > 0:
        s1h[:, :-term, :] = 0
    else:
        s1h[:] = 0
    pad = -len(pats) % 8
    z = np.zeros((pad, plen, 4), np.uint8)
    p1h, s1h = np.concatenate([p1h, z]), np.concatenate([s1h, z])
    masks, lens = ms.encode_target_masks(seqs)
    return masks, lens, p1h, s1h


# the tile edges of the tensor-core kernels: K = 4 * plen not a multiple of
# 32 (9, 33, 63), P unpadded across the 8-pattern n-tiles and the pattern
# passes, mm at and past plen, rows shorter than a 16-window tile
EDGE_PLENS = (8, 9, 18, 20, 32, 33, 63)
EDGE_PS = (1, 8, 9, 255, 257, 745)


def edge_grid(plen):
    """(mm, term, P, row length range) cases of one plen's edge grid."""
    mms = [mm for mm in (0, 1, 2, 3, 4, plen, plen + 1) if mm < 64]
    out = []
    for i, (mm, term) in enumerate((mm, term) for mm in mms
                                   for term in (0, 1, 4, plen + 1)):
        lo, hi = (plen, plen + 12) if i % 3 == 0 else (plen - 3, 700)
        out.append((mm, term, EDGE_PS[i % len(EDGE_PS)], lo, hi))
    return out


def edge_inputs(rng, plen, term, n_pat, lo, hi):
    """Unpadded patterns (n_pat of them) against targets of lo..hi bases;
    a single pattern is a planted one, not the all-N first row."""
    masks, lens, p1h, s1h = _inputs(rng, int(rng.integers(1, 24)), lo, hi,
                                    n_pat + 1, plen, term)
    keep = slice(1, 2) if n_pat == 1 else slice(0, n_pat)
    return masks, lens, p1h[keep], s1h[keep]


@pytest.mark.parametrize("plen", EDGE_PLENS)
def test_kernel_equals_plain(cuda, plen):
    rng = np.random.default_rng(plen)
    for mm, term, n_pat, lo, hi in edge_grid(plen):
        masks, _, p1h, s1h = edge_inputs(rng, plen, term, n_pat, lo, hi)
        tm = torch.from_numpy(masks).to(cuda)
        planes, sfx = ms.pack_patterns(p1h, s1h, device=cuda)
        before = _cuda.launches()
        got = ms.hit_codes(tm, planes, sfx, plen=plen, mm=mm, term=term)
        assert launched(before, "hit_codes") == 1
        want = ms.hit_codes_reference(tm, planes, sfx, plen=plen, mm=mm,
                                      term=term)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (plen, mm, term, n_pat, masks.shape)


def test_wrapper_refuses_bad_inputs(cuda):
    masks = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    planes = torch.zeros((8, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="target_masks"):
        ms.hit_codes(masks.to(torch.int32), planes, planes, plen=18, mm=1,
                     term=1)
    with pytest.raises(ValueError, match="target_masks"):
        ms.hit_codes(masks[:, ::2], planes, planes, plen=18, mm=1, term=1)
    with pytest.raises(ValueError, match="planes"):
        ms.hit_codes(masks, planes.cpu(), planes, plen=18, mm=1, term=1)
    with pytest.raises(ValueError, match="plen"):
        ms.hit_codes(masks, planes, planes, plen=64, mm=1, term=1)


def test_find_hits_and_scan_on_card(cuda):
    rng = np.random.default_rng(3)
    masks, lens, p1h, s1h = _inputs(rng, 40, 100, 900, 130, 18, 2,
                                    letters="ACGTACGTACGTN")
    tm = torch.from_numpy(masks).to(cuda)
    tl = torch.from_numpy(lens).to(cuda)
    planes, sfx = ms.pack_patterns(p1h, s1h, device=cuda)
    got = ms.find_hits(tm, tl, planes, sfx, plen=18, mm=3, term=2,
                       max_hits=4096)
    want = ms.find_hits_from_codes(
        ms.hit_codes_reference(tm, planes, sfx, plen=18, mm=3, term=2), tl,
        plen=18, max_hits=4096)
    assert int(got[1]) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dense = ["A" * 1000] * 40
    pats = ["A" * 18] + ["A" * k + "C" + "A" * (17 - k) for k in range(7)]
    params = dict(mm=1, term=1, want_mism=True)
    dev_hits = vscan.scan_hits(dense, pats, vscan.ScanParams(
        backend="device", **params), device=cuda)
    host_hits = vscan.scan_hits(dense, pats, vscan.ScanParams(
        backend="numpy", **params), device=cuda)
    assert len(dev_hits) > 1 << 17 and dev_hits == host_hits


def find_hits_equal_plain(dev, masks, lens, p1h, s1h, mm, term, max_hits):
    """find_hits (the kernels of csrc/find_hits.cu, one launch a call)
    equal to find_hits_reference on the card, with int32 and int64
    lengths -> n_hits."""
    tm = torch.from_numpy(masks).to(dev)
    planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
    kw = dict(plen=p1h.shape[1], mm=mm, term=term, max_hits=max_hits)
    for dtype in (torch.int32, torch.int64):
        tl = torch.from_numpy(lens).to(dev, dtype)
        before = _cuda.launches()
        got = ms.find_hits(tm, tl, planes, sfx, **kw)
        assert launched(before, "find_hits") == 1
        want = ms.find_hits_reference(tm, tl, planes, sfx, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == torch.int64 and torch.equal(g, w), (
                kw, masks.shape, dtype, int(w.reshape(-1)[0]))
    return int(want[1])


@pytest.mark.parametrize("plen", EDGE_PLENS)
def test_find_hits_kernel_equals_plain_on_edge_grid(cuda, plen):
    """Phase 2's edge grid with zero-length padding rows between and after
    the real ones, and max_hits below, at and far above the hits."""
    rng = np.random.default_rng(3000 + plen)
    for i, (mm, term, n_pat, lo, hi) in enumerate(edge_grid(plen)):
        masks, lens, p1h, s1h = edge_inputs(rng, plen, term, n_pat, lo, hi)
        pad = np.zeros((3, masks.shape[1]), np.uint8)
        masks = np.concatenate([masks[:1], pad[:1], masks[1:], pad])
        lens = np.concatenate([lens[:1], [0], lens[1:], [0, 0, 0]]).astype(
            np.int32)
        find_hits_equal_plain(cuda, masks, lens, p1h, s1h, mm, term,
                              (7, 1 << 14, 1, 0)[i % 4])


@pytest.mark.parametrize("case", ["poly_a", "all_hit", "wide_rows"])
def test_find_hits_kernel_dense_blocks_equal_plain(cuda, case):
    """Blocks with more hits than the kernel's 1,024-entry list: 64-window
    tiles of poly-A rows with 1,152 hits (whole-row rounds), rows of 1,500
    hits each (pattern slices of one row), and max_hits inside a block."""
    rng = np.random.default_rng(77)
    lut = np.array(list("ACGT"))
    if case == "poly_a":
        seqs = ["A" * 1000] * 6 + ["".join(rng.choice(lut, size=900))]
        pats = ["A" * 18] + ["A" * k + "C" + "A" * (17 - k)
                             for k in range(18)]
        mm, term = 1, 1
    else:
        n_rows, n_pat = (3, 1500) if case == "all_hit" else (40, 40)
        seqs = ["".join(rng.choice(lut, size=int(rng.integers(60, 120))))
                for _ in range(n_rows)]
        pats = ["".join(rng.choice(lut, size=18)) for _ in range(n_pat)]
        mm, term = 18, 0
    p1h = ms.encode_primers(pats)
    s1h = p1h.copy()
    if term:
        s1h[:, :-term] = 0
    else:
        s1h[:] = 0
    pad = -len(pats) % 8
    z = np.zeros((pad, 18, 4), np.uint8)
    p1h, s1h = np.concatenate([p1h, z]), np.concatenate([s1h, z])
    masks, lens = ms.encode_target_masks(seqs)
    counts = [find_hits_equal_plain(cuda, masks, lens, p1h, s1h, mm, term,
                                    max_hits)
              for max_hits in (100, 5000, 1 << 16, 1 << 20)]
    assert counts[0] > 1 << 16 or case == "wide_rows"
    assert len(set(counts)) == 1 and counts[0] > 5000


def test_find_hits_wrapper_refuses_bad_inputs(cuda):
    masks = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    lens = torch.zeros(4, dtype=torch.int32, device=cuda)
    planes = torch.zeros((8, 4), dtype=torch.int64, device=cuda)
    kw = dict(plen=18, mm=1, term=1, max_hits=16)
    with pytest.raises(ValueError, match="target_masks"):
        ms.find_hits(masks.to(torch.int32), lens, planes, planes, **kw)
    with pytest.raises(ValueError, match="target_masks"):
        ms.find_hits(masks[:, ::2], lens, planes, planes, **kw)
    with pytest.raises(ValueError, match="planes"):
        ms.find_hits(masks, lens, planes.cpu(), planes, **kw)
    for bad in (lens.float(), lens.cpu(), lens[:3], lens[None]):
        with pytest.raises(ValueError, match="lengths"):
            ms.find_hits(masks, bad, planes, planes, **kw)
    with pytest.raises(ValueError, match="plen"):
        ms.find_hits(masks, lens, planes, planes, **dict(kw, plen=64))
    with pytest.raises(ValueError, match="max_hits"):
        ms.find_hits(masks, lens, planes, planes, **dict(kw, max_hits=-1))


def _multi_base_masks(rng, n, length):
    """Random 4-bit masks: pure, ambiguous (several bits) and empty."""
    return rng.integers(0, 16, size=(n, length)).astype(np.uint8)


@pytest.mark.parametrize("plen", [5, 8, 18, 24, 32, 40, 64])
def test_match_counts_kernel_equals_plain(cuda, plen):
    rng = np.random.default_rng(1000 + plen)
    for n, length, n_pat in ((1, plen, 1), (37, plen + 70, 77),
                             (5, plen + 300, 513)):
        masks = torch.from_numpy(_multi_base_masks(rng, n, length)).to(cuda)
        p1h = rng.integers(0, 2, size=(n_pat, plen, 4)).astype(np.uint8)
        p1h[0, :plen // 2] = 0                   # left-padding columns
        planes = ms.pattern_planes(p1h, device=cuda)
        before = _cuda.launches()
        got = ms.match_counts_kernel(masks, planes, plen=plen)
        assert launched(before, "match_counts") == 1
        want = ms.match_counts_reference(masks, planes, plen=plen)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and torch.equal(got, want), (
            plen, n, length, n_pat)


@pytest.mark.parametrize("plen", EDGE_PLENS)
def test_bitmap_kernel_equals_plain(cuda, plen):
    rng = np.random.default_rng(2000 + plen)
    for mm, term, n_pat, lo, hi in edge_grid(plen):
        masks, _, p1h, s1h = edge_inputs(rng, plen, term, n_pat, lo, hi)
        tm = torch.from_numpy(masks).to(cuda)
        planes, sfx = ms.pack_patterns(p1h, s1h, device=cuda)
        kw = dict(plen=plen, mm=mm, term=term)
        # the raw IUPAC masks: R, Y and N are several bases a position
        before = _cuda.launches()
        got = ms.hit_window_bitmap_kernel(tm, planes, sfx, **kw)
        assert launched(before, "hit_window_bitmap") == 1
        want = ms.hit_window_bitmap_reference(tm, planes, sfx, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (plen, mm, term, n_pat, masks.shape)
        # pure masks: the hit codes' any over the patterns
        got = ms.hit_window_bitmap_kernel(ms.pure_masks(tm), planes, sfx,
                                          **kw)
        want = ms.hit_codes_reference(tm, planes, sfx, **kw) > 0
        torch.cuda.synchronize()
        assert torch.equal(got, want.any(dim=2).to(torch.int8)), (
            plen, mm, term, n_pat, masks.shape)


def test_new_wrappers_refuse_bad_inputs(cuda):
    masks = torch.zeros((4, 80), dtype=torch.uint8, device=cuda)
    planes = torch.zeros((8, 4), dtype=torch.int64, device=cuda)
    for bad in (masks.to(torch.int32), masks[:, ::2]):
        with pytest.raises(ValueError, match="target_masks"):
            ms.match_counts_kernel(bad, planes, plen=18)
        with pytest.raises(ValueError, match="target_masks"):
            ms.hit_window_bitmap_kernel(bad, planes, planes, plen=18, mm=1,
                                        term=1)
    with pytest.raises(ValueError, match="planes"):
        ms.match_counts_kernel(masks, planes.cpu(), plen=18)
    with pytest.raises(ValueError, match="planes"):
        ms.match_counts_kernel(masks, planes[:, :2].contiguous(), plen=18)
    with pytest.raises(ValueError, match="suffix_planes"):
        ms.hit_window_bitmap_kernel(masks, planes, planes.to(torch.int32),
                                    plen=18, mm=1, term=1)
    with pytest.raises(ValueError, match="plen"):
        ms.match_counts_kernel(masks, planes, plen=65)
    with pytest.raises(ValueError, match="plen"):
        ms.hit_window_bitmap_kernel(masks, planes, planes, plen=64, mm=1,
                                    term=1)


def test_find_hits_bitmap_on_card(cuda):
    rng = np.random.default_rng(4)
    masks, lens, p1h, s1h = _inputs(rng, 40, 100, 900, 130, 18, 2,
                                    letters="ACGTACGTACGTN")
    seqs_1h = ((masks[..., None] >> np.arange(4)) & 1).astype(np.uint8)
    seqs_1h *= np.isin(masks, [1, 2, 4, 8])[..., None]
    before = _cuda.launches()
    got = ms.find_hits_bitmap(seqs_1h, lens, p1h, s1h, mm=3, term=2,
                              device=cuda)
    assert launched(before, "hit_window_bitmap") == 1
    planes, sfx = ms.pack_patterns(p1h, s1h, device=cuda)
    idx, n_hits, mism = ms.find_hits(
        torch.from_numpy(masks).to(cuda), torch.from_numpy(lens).to(cuda),
        planes, sfx, plen=18, mm=3, term=2, max_hits=1 << 16)
    want = ms.decode_hits(idx.cpu().numpy(), mism.cpu().numpy(),
                          masks.shape[1] - 17, p1h.shape[0])
    assert 0 < int(n_hits) == len(got[0])
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_find_hits_bitmap_multi_base_onehot_on_card(cuda):
    """One-hots with several bases at a position count each shared base;
    the hits are those of the NumPy scan."""
    rng = np.random.default_rng(5)
    masks, lens, p1h, s1h = _inputs(rng, 30, 100, 600, 60, 13, 2,
                                    letters="ACGTACGTNRYSWKM")
    raw_1h = ((masks[..., None] >> np.arange(4)) & 1).astype(np.uint8)
    before = _cuda.launches()
    got = ms.find_hits_bitmap(raw_1h, lens, p1h, s1h, mm=2, term=2,
                              device=cuda)
    assert launched(before, "hit_window_bitmap") == 1
    want = ms.find_hits_numpy(raw_1h, lens, p1h, s1h, mm=2, term=2)
    assert len(want) > 0 and (want[:, 3] < 0).any()   # counts above plen
    for k, g in enumerate(got):
        assert np.array_equal(g, want[:, k])


def test_dimer_matrices_on_card(cuda):
    rng = np.random.default_rng(9)
    lut = np.array(list("ACGT"))
    primers = ["".join(rng.choice(lut, size=int(rng.integers(15, 24))))
               for _ in range(40)]
    primers[2] = primers[2][:6] + "".join(
        {"A": "T", "C": "G", "G": "C", "T": "A"}[c]
        for c in reversed(primers[1][-12:]))
    primers[5] = primers[5][:8] + "R" + primers[5][9:]
    primers[7] = primers[7][:4] + "N" + primers[7][5:]
    host = dimer.verify_against_host(primers)
    before = _cuda.launches()
    fused = dimer.dimer_hit_matrix_fused(primers, device=cuda)
    assert launched(before, "dimer_fired") == 1
    assert launched(before, "match_counts") == 0
    unfused = dimer.dimer_hit_matrix(primers, device=cuda)
    assert launched(before, "match_counts") > 0
    assert fused[1, 2]
    assert np.array_equal(fused, host) and np.array_equal(unfused, host)


def dimer_edge_inputs(rng, lp, n_t=37, n_e=300, width=None):
    """Fused-pass inputs on the card: targets of 0-40 bases left-padded by
    z = lp - 5 (every 7th a zero-length padding row), ends of 5..lp bases
    cut from the first window of a target, its last, or between (a few
    random), trigger rows of W columns with 0 and W - 1 set, so that d2
    clips at both ends."""
    z = lp - 5
    lut = np.array(list("ACGT"))
    seqs = [("".join(rng.choice(lut, size=int(rng.integers(5, 41))))
             if t % 7 else "") for t in range(n_t)]
    lns = rng.integers(5, min(lp, 40) + 1, size=n_e)
    lns[0] = 5
    ends = []
    for e, ln in enumerate(lns):
        s = seqs[int(rng.integers(0, n_t))]
        if len(s) >= ln and e % 4:
            at = (0, len(s) - ln, int(rng.integers(0, len(s) - ln + 1)))[
                e % 3]
            ends.append(s[at:at + ln])
        else:
            ends.append("".join(rng.choice(lut, size=int(ln))))
    t_len = z + 40
    t_len += -t_len % 16
    masks = np.zeros((n_t, t_len), np.uint8)
    codes, lens = ms.encode_target_codes(seqs)
    masks[:, z:z + codes.shape[1]] = codes
    p1h = np.zeros((n_e, lp, 4), np.uint8)
    for k, e in enumerate(ends):
        p1h[k, lp - len(e):] = ms.encode_primers([e])[0]
    width = width or int(rng.integers(3, 30))
    trig = rng.random((n_e, width)) < 0.5
    trig[:, 0] = True
    trig[1::2, -1] = True
    return (masks, lens.astype(np.int64), p1h, lns.astype(np.int64),
            (lp - lns).astype(np.int64), z, trig)


def dimer_fired_equal_plain(dev, masks, lens, p1h, lns, shifts, z, trig):
    """_fused_kernel (the dimer_fired kernel, one launch) equal to
    _fused_kernel_reference on the card -> fired pairs."""
    args = [torch.from_numpy(masks).to(dev), torch.from_numpy(lens).to(dev),
            ms.pattern_planes(p1h, device=dev), p1h.shape[1], z,
            torch.from_numpy(lns).to(dev), torch.from_numpy(shifts).to(dev),
            torch.from_numpy(trig).to(dev)]
    before = _cuda.launches()
    got = dimer._fused_kernel(*args)
    assert launched(before, "dimer_fired") == 1
    want = dimer._fused_kernel_reference(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and torch.equal(got, want), (
        masks.shape, p1h.shape, trig.shape)
    return int(want.sum())


@pytest.mark.parametrize("lp", [8, 24, 40, 64])
def test_dimer_fired_kernel_equals_plain(cuda, lp):
    rng = np.random.default_rng(4000 + lp)
    fired = [dimer_fired_equal_plain(cuda, *dimer_edge_inputs(rng, lp,
                                                              width=w))
             for w in (None, 1, 2, 65)]
    assert min(fired) > 0


def test_dimer_fired_wrapper_refuses_bad_inputs(cuda):
    masks = torch.zeros((6, 48), dtype=torch.uint8, device=cuda)
    lens = torch.zeros(6, dtype=torch.int64, device=cuda)
    planes = torch.zeros((9, 4), dtype=torch.int64, device=cuda)
    vec = torch.zeros(9, dtype=torch.int64, device=cuda)
    trig = torch.zeros((9, 25), dtype=torch.bool, device=cuda)
    for what, args in (
            ("masks", (masks.to(torch.int32), lens, planes, vec, trig, 24)),
            ("lens", (masks, lens.cpu(), planes, vec, trig, 24)),
            ("trig", (masks, lens, planes, vec, trig.to(torch.uint8), 24)),
            ("lens must be", (masks, lens[:5], planes, vec, trig, 24)),
            ("lp must be", (masks, lens, planes, vec, trig, 65))):
        m, ln, q, v, tr, lp = args
        with pytest.raises(ValueError, match=what):
            dimer._fused_kernel(m, ln, q, lp, 19, v, v, tr)


# ---------------------------------------------------------------------------
# the CUDA kernels of design Stage A and the center-star/refine DPs: the
# card's results equal the plain versions' (integers, op codes, rows)
# ---------------------------------------------------------------------------

def _stage_a_masks(rng, n, length):
    """A conserved family of IUPAC masks with gap runs, an all-gap row and
    a block of planted Viterbi ties (half the rows A, half C)."""
    base = rng.choice(np.array([1, 2, 4, 8], np.int32), size=length)
    masks = np.tile(base, (n, 1))
    mut = rng.random((n, length)) < 0.05
    masks[mut] = rng.choice(np.array([1, 2, 4, 8, 5, 10, 7, 15, 0], np.int32),
                            size=int(mut.sum()))
    masks[0, :25] = 0
    masks[1, -30:] = 0
    masks[2] = 0
    half = n // 2
    masks[:half, 60:90] = np.where(np.arange(30) % 2, 1, 2)
    masks[half:2 * half, 60:90] = np.where(np.arange(30) % 2, 2, 1)
    return masks


# the Stage-A kernels' edge grid (tests/test_torch_design_scan.py holds its
# NumPy model to JAX on it, chip_smoke.py phase 10 the kernels to their
# plain versions): seed, N, L, plen, variation
STAGE_A_EDGE_CASES = [
    (0, 24, 160, 8, 0), (1, 1, 120, 18, 1), (2, 30, 200, 25, 2),
    (3, 12, 150, 40, 3), (4, 40, 180, 32, 1), (5, 7, 90, 18, 0)]


def stage_a_edge_masks(seed, n, length, plen):
    """Seeded int32 masks with the windows kernel's edge cases: gap runs
    longer than plen at the rows' ends and inside them, an all-gap row,
    rows of a few residues then a long run (fewer residues before a window
    than its lead), a run of N in some rows, IUPAC codes."""
    from multiprime_tpu_torch.utils import iupac
    rng = np.random.default_rng(seed)
    chars = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, length))]
    dege = rng.random((n, length)) < 0.04
    chars[dege] = np.frombuffer(b"RYMKSWHBVD", np.uint8)[
        rng.integers(0, 10, size=int(dege.sum()))]
    chars[rng.random((n, length)) < 0.1] = ord("-")
    masks = iupac.bytes_to_masks(chars).astype(np.int32)
    if n == 1:
        masks[0, :plen + 3] = 0
        masks[0, length // 2:length // 2 + plen + 2] = 0
        return masks
    masks[2] = 0                                    # an all-gap row
    masks[1, -(plen + 5):] = 0
    masks[0, :plen + 7] = 0
    masks[3 % n, 3:3 + 2 * plen] = 0               # 3 residues, then a run
    masks[4 % n, length - 3 - 2 * plen:length - 3] = 0
    for r in rng.choice(n, size=max(1, n // 4), replace=False):
        at = int(rng.integers(0, length - 2 * plen))
        masks[r, at:at + int(rng.integers(plen + 1, 2 * plen))] = 0
    heavy = rng.choice(n, size=max(1, n // 5), replace=False)
    at = int(rng.integers(0, length - 6))
    masks[heavy, at:at + 6] = 15                    # N-heavy windows
    return masks


def stage_a_wrap_masks(plen):
    """(masks, positions) whose sums pass 2**31 (plen 18), whose all-N
    windows' 4**32 expansions wrap to 0 (plen 32) and whose three-base
    windows' 3**40 wraps to a negative int64 (plen 40): 12 rows of
    three-base codes, 4 of them N across plen columns, 21 windows."""
    rng = np.random.default_rng(plen)
    three = np.array([7, 11, 13, 14], np.int32)        # V D B H
    masks = three[rng.integers(0, 4, size=(12, plen + 20))]
    masks[8:, 4:4 + plen] = 15
    masks[0, :3] = 0
    return masks, np.arange(0, 21)


def stage_a_equal_plain(dev, masks, positions, plen, variation):
    """design_stats_full on the card (the three kernels, one launch each)
    equal, key for key, dtype and value, to its plain version on the card
    and on the CPU -> the number of windows."""
    from multiprime_tpu_torch.ops import design_scan as ds
    before = _cuda.launches()
    got = ds.design_stats_full(masks, positions, plen=plen,
                               variation=variation, device=dev)
    assert [launched(before, k) for k in (
        "stage_a_rows", "stage_a_windows", "stage_a_viterbi")] == [1, 1, 1]
    on_card = ds.design_stats_full_reference(masks, positions, plen=plen,
                                             variation=variation, device=dev)
    on_cpu = ds.design_stats_full_reference(masks, positions, plen=plen,
                                            variation=variation)
    assert list(got) == list(on_cpu)
    for key in on_cpu:
        g = got[key].cpu()
        for want in (on_card[key].cpu(), on_cpu[key]):
            assert g.dtype == want.dtype and torch.equal(g, want), key
    return len(positions)


@pytest.mark.parametrize("case", STAGE_A_EDGE_CASES)
def test_stage_a_kernels_equal_plain_on_edge_grid(cuda, case):
    """Every window of the edge grid: gap runs longer than plen, all-gap
    rows, fewer residues before a window than its lead run, N-heavy
    windows, windows at both ends of the rows, N = 1, plen 8-40."""
    seed, n, length, plen, variation = case
    stage_a_equal_plain(cuda, stage_a_edge_masks(seed, n, length, plen),
                        np.arange(0, length - plen + 1), plen, variation)


@pytest.mark.parametrize("plen", [18, 31, 32, 40])
def test_stage_a_kernels_wrap_as_plain(cuda, plen):
    """Sums past 2**31 and expansion counts that wrap past 2**63: the
    kernel's unsigned sums and floor divisions equal torch's int64."""
    masks, positions = stage_a_wrap_masks(plen)
    stage_a_equal_plain(cuda, masks, positions, plen, 1)


def test_stage_a_kernels_long_plen_and_short_blocks(cuda):
    """A plen too long for the shared sums (they go to the outputs), one
    window, one member, plen 1, and a block of no windows."""
    from multiprime_tpu_torch.ops import design_scan as ds
    rng = np.random.default_rng(5)
    masks = rng.choice(np.array([0, 1, 2, 4, 8, 5, 15], np.int32),
                       size=(3, 1400))
    stage_a_equal_plain(cuda, masks, np.array([0, 7, 99]), 1300, 1300)
    stage_a_equal_plain(cuda, masks[:1, :30], np.array([12]), 18, 5)
    stage_a_equal_plain(cuda, masks[:, :30], np.array([0, 29]), 1, 0)
    out = ds.design_stats_full(masks[:, :30], np.array([], np.int64),
                               device=cuda)
    assert tuple(out["freq"].shape) == (0, 18, 4)
    assert tuple(out["win"].shape) == (3, 0, 18)


def test_stage_a_viterbi_kernel_ties(cuda):
    """Planted ties (equal scores at every step and at the end) take the
    first maximum, over `from` and at the last position, as the plain
    version's torch.argmax does; and scores past 2**63 wrap alike."""
    from multiprime_tpu_torch.ops import design_scan as ds
    rng = np.random.default_rng(8)
    freq = rng.integers(0, 3, size=(300, 18, 4))
    nn = rng.integers(0, 3, size=(300, 17, 4, 4))
    freq[:8] = 5
    nn[:8] = 0
    nn[8:16, :, 1:, :] = nn[8:16, :, :1, :]
    freq[16:24] = rng.integers(2 ** 61, 2 ** 62, size=(8, 18, 4))
    before = _cuda.launches()
    got = ds.viterbi_batch(freq, nn, device=cuda)
    assert launched(before, "stage_a_viterbi") == 1
    want = ds.viterbi_batch_reference(freq, nn)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, ds.viterbi_batch_reference(freq, nn, device=cuda))
    assert (want[:8] == 0).all()


def test_stage_a_wrappers_refuse_bad_inputs(cuda):
    """Masks outside 0..15, windows past the row's end, wrong types and
    shapes raise before any launch."""
    from multiprime_tpu_torch.ops import design_scan as ds
    masks = torch.ones((4, 50), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="0..15"):
        ds.stage_a_rows(masks * 16)
    with pytest.raises(ValueError, match="window starts"):
        ds.window_stats_from_masks(masks, np.array([0, 33]))
    with pytest.raises(ValueError, match="window starts"):
        ds.window_stats_from_masks(masks, torch.tensor([-1], device=cuda))
    with pytest.raises(ValueError, match="int32"):
        ds.window_stats_from_masks(masks.to(torch.int64), np.array([0]))
    with pytest.raises(ValueError, match=r"nn \[W, plen - 1, 4, 4\]"):
        ds.viterbi_batch(torch.zeros((2, 18, 4), dtype=torch.int64,
                                     device=cuda),
                         torch.zeros((2, 18, 4, 4), dtype=torch.int64,
                                     device=cuda), device=cuda)


def test_stage_a_sharded_on_a_mesh_of_one_card(cuda):
    """design_stats_blocks_sharded over a 2 x 2 Mesh of cuda:0 (rows padded
    with an all-gap row, a short last block) equals design_stats_blocks,
    every shard through the windows kernel and each column's Viterbi
    through the Viterbi kernel."""
    from multiprime_tpu_torch.ops import design_scan as ds
    from multiprime_tpu_torch.parallel import mesh as pmesh
    masks = stage_a_edge_masks(2, 31, 300, 18)
    positions = np.arange(0, 300 - 18 + 1)
    want = list(ds.design_stats_blocks(masks, positions, block=128,
                                       device="cpu"))
    mesh = pmesh.Mesh([["cuda:0"] * 2] * 2)
    before = _cuda.launches()
    got = list(pmesh.design_stats_blocks_sharded(mesh, masks, positions,
                                                 block=128))
    assert len(got) == len(want) == 3
    assert (launched(before, "stage_a_windows"),
            launched(before, "stage_a_viterbi")) == (4 * 3, 2 * 3)
    for (gp, gs), (wp, ws) in zip(got, want):
        assert np.array_equal(gp, wp) and sorted(gs) == sorted(ws)
        for key in ws:
            assert gs[key].dtype == ws[key].dtype, key
            assert np.array_equal(gs[key], ws[key]), key


@pytest.mark.parametrize("plen,variation", [(18, 1), (25, 2)])
def test_design_stats_blocks_card_equals_cpu(cuda, plen, variation):
    from multiprime_tpu_torch.ops import design_scan
    rng = np.random.default_rng(plen)
    masks = _stage_a_masks(rng, 120, 400)
    positions = np.arange(3, 400 - plen)
    kw = dict(plen=plen, variation=variation, block=128)
    want = list(design_scan.design_stats_blocks(masks, positions,
                                                device="cpu", **kw))
    before = _cuda.launches()
    got = list(design_scan.design_stats_blocks(masks, positions,
                                               device=cuda, **kw))
    assert len(got) == len(want) == 3
    assert launched(before, "stage_a_windows") == 3
    for (wp, ws), (gp, gs) in zip(want, got):
        assert np.array_equal(wp, gp)
        for key in ws:
            assert gs[key].dtype == ws[key].dtype, key
            assert np.array_equal(gs[key], ws[key]), key


def _gotoh_members(rng, la, n):
    c = rng.integers(0, 5, size=la).astype(np.int8)
    members = []
    for _ in range(n):
        b = c.copy()
        k = rng.random(la) < 0.06
        b[k] = rng.integers(0, 4, size=int(k.sum()))
        b = np.delete(b, rng.integers(0, la, size=int(rng.integers(0, 25))))
        members.append(np.insert(b, rng.integers(0, len(b), size=int(
            rng.integers(0, 25))), 2).astype(np.int8))
    members += [np.empty(0, np.int8), c[:1], np.tile(c, 2)]
    return c, members


def test_align_ops_batch_device_card_equals_cpu(cuda):
    from multiprime_tpu_torch.align import device as adev
    rng = np.random.default_rng(31)
    c, members = _gotoh_members(rng, 300, 70)
    for as_codes in (False, True):
        want = adev.align_ops_batch_device(c, members, member_block=32,
                                           as_codes=as_codes, device="cpu")
        got = adev.align_ops_batch_device(c, members, member_block=32,
                                          as_codes=as_codes, device=cuda)
        if as_codes:
            assert np.array_equal(got, want)
        else:
            assert got == want


def test_refine_pass_device_card_equals_cpu(cuda):
    from multiprime_tpu_torch.align import centerstar, refine
    rng = np.random.default_rng(41)
    c, members = _gotoh_members(rng, 240, 60)
    seqs = ["".join("ACGTN"[x] for x in m) for m in members[:-3]]
    ids = [str(i) for i in range(len(seqs))]
    _, rows = centerstar.center_star_msa(ids, seqs, backend="numpy",
                                         device="cpu")
    want = refine.refine_pass(rows, backend="device", device="cpu")
    got = refine.refine_pass(rows, backend="device", device=cuda)
    assert got == want and got != rows


def _dp_codes(rng, n, hi=4):
    return rng.integers(0, hi, size=n).astype(np.int8)


def dp_case(name, scale=1):
    """A tie-heavy input of the two DPs -> (center codes int8, member code
    arrays, member block), its lengths ``scale`` times the base ones.
    Homopolymers, tandem repeats and members equal to the center tie many
    cells; codes of 4 and more never match; an empty member (an all-gap row
    of the MSA), a one-base center and a single member are the edges;
    member_block + 1 members split into two blocks."""
    rng = np.random.default_rng(sum(map(ord, name)))
    rnd = lambda n, hi=4: _dp_codes(rng, n, hi)  # noqa: E731
    unit = np.array([0, 1, 2], np.int8)
    s = scale
    if name == "homopolymer":
        c = np.zeros(40 * s, np.int8)
        return c, [np.zeros(n, np.int8)
                   for n in (0, 1, 17 * s, 40 * s, 40 * s + 1, 63 * s)] + [
            np.insert(c, 20 * s, [1, 1, 1]), np.full(30 * s, 3, np.int8)], 512
    if name == "tandem_repeat":
        c = np.tile(unit, 15 * s)
        return c, [np.tile(unit, k) for k in (3 * s, 15 * s - 1, 15 * s,
                                              15 * s + 1, 22 * s)] + [
            np.tile(unit[:2], 20 * s), np.roll(c, 1),
            np.tile([0, 1, 2, 2], 11 * s).astype(np.int8)], 512
    if name == "equal_to_center":
        c = rnd(60 * s)
        one = c.copy()
        one[30 * s] = (one[30 * s] + 1) % 4
        return c, [c.copy(), c.copy(), c[:-1].copy(), c[1:].copy(), one], 512
    if name == "codes_4_and_up":
        c = rnd(50 * s, 7)
        return c, [rnd(n, 7) for n in (10 * s, 50 * s - 1, 50 * s, 70 * s)] \
            + [c.copy()], 512
    if name == "empty_member":
        c = rnd(30 * s)
        return c, [np.empty(0, np.int8), rnd(5 * s), np.empty(0, np.int8),
                   c.copy()], 512
    if name == "center_of_one":
        return np.array([2], np.int8), [np.array([2], np.int8),
                                        np.array([1], np.int8), rnd(7 * s),
                                        np.empty(0, np.int8)], 512
    if name == "one_member":
        return rnd(35 * s), [rnd(40 * s)], 512
    if name == "block_plus_one":
        c = rnd(45 * s)
        members = []
        for _ in range(4 * s + 1):
            b = c.copy()
            b[rng.random(len(c)) < 0.1] = 0
            members.append(np.delete(b, rng.integers(0, len(c), size=3)))
        return c, members, 4 * s
    raise KeyError(name)


DP_CASES = ("homopolymer", "tandem_repeat", "equal_to_center",
            "codes_4_and_up", "empty_member", "center_of_one", "one_member",
            "block_plus_one")


def dp_case_rows(c, members):
    """The host center-star MSA of a DP case's sequences (center first,
    codes of 4 and up as N): the rows a refine pass takes."""
    from multiprime_tpu_torch.align import centerstar
    seqs = ["".join("ACGTN"[min(int(x), 4)] for x in s) for s in [c, *members]]
    _, rows = centerstar.center_star_msa(
        [str(i) for i in range(len(seqs))], seqs, backend="numpy",
        device="cpu")
    return rows


def gotoh_blocks_equal_plain(dev, c, members, block, gotoh="warp"):
    """Each Gotoh block of a case: the kernel on ``dev`` equals its plain
    version on ``dev``, one launch a block, of the kernel named by
    ``gotoh`` ("warp": gotoh_dp_warp_kernel, "cta": gotoh_dp_kernel)."""
    from multiprime_tpu_torch.align import device as adev
    c_dev = torch.from_numpy(c.astype(np.int32)).to(dev)
    for lo in range(0, len(members), block):
        bmat, lbs = adev.gotoh_block_inputs(members[lo:lo + block], device=dev)
        before = _cuda.launches()
        got = adev.gotoh_block(c_dev, bmat, lbs)
        assert launched(before, "gotoh_dp", "gotoh_dp_warp") == 1
        assert launched(before, "gotoh_dp_warp") == (gotoh == "warp")
        want = adev.gotoh_block_reference(c, bmat, lbs, dev)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), \
            "gotoh block at %d (%s kernel)" % (lo, gotoh)
    return -(-len(members) // block)


def refine_block_equal_plain(dev, blk, refine="warp", what="refine block"):
    """One refine block's inputs ``blk``: the kernel on ``dev`` equals its
    plain version on ``dev``, one launch, of the kernel named by ``refine``
    ("warp": refine_dp_warp_kernel, "cta": refine_dp_kernel)."""
    from multiprime_tpu_torch.align import device as adev
    before = _cuda.launches()
    got = adev.refine_block(*blk)
    assert launched(before, "refine_dp", "refine_dp_warp") == 1
    assert launched(before, "refine_dp_warp") == (refine == "warp")
    want = adev.refine_block_reference(*blk, dev)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want), \
        "%s (%s kernel)" % (what, refine)


def refine_blocks_equal_plain(dev, rows, block, refine="warp"):
    """Each refine block of a pass over ``rows``: the kernel named by
    ``refine`` equals the plain version -> blocks checked."""
    from multiprime_tpu_torch.align import device as adev
    from multiprime_tpu_torch.align import refine as rmod
    res_chars, res_codes, lens, f6, occ, _ = rmod.device_pass_inputs(rows)
    for lo in range(0, len(rows), block):
        blk = adev.refine_block_inputs(res_codes, lens, f6, occ,
                                       slice(lo, lo + block), device=dev)
        refine_block_equal_plain(dev, blk, refine, "refine block at %d" % lo)
    return -(-len(rows) // block)


def dp_blocks_equal_plain(dev, c, members, block, rows, gotoh="warp",
                          refine="warp"):
    """Each Gotoh and refine block of a case: the kernel on ``dev`` equals
    its plain version on ``dev``, one launch a block (the Gotoh and refine
    blocks on the kernels named by ``gotoh`` and ``refine``) -> blocks
    checked."""
    gotoh_blocks_equal_plain(dev, c, members, block, gotoh)
    return -(-len(members) // block) + refine_blocks_equal_plain(
        dev, rows, block, refine)


@pytest.mark.parametrize("case", DP_CASES)
def test_dp_kernels_equal_plain_on_tie_grid(cuda, case):
    """csrc/gotoh_dp.cu and csrc/refine_dp.cu against their plain versions
    on the card, element for element, on the tie-heavy cases."""
    c, members, block = dp_case(case)
    dp_blocks_equal_plain(cuda, c, members, block, dp_case_rows(c, members))


@pytest.mark.parametrize("case", DP_CASES)
def test_refine_cta_kernel_equal_plain_on_tie_grid(cuda, case, monkeypatch):
    """The tie-heavy cases with the refine dispatch forced to the CTA kernel
    (refine_dp_kernel, the one for blocks too wide for a warp), against
    the plain version; test_dp_kernels_equal_plain_on_tie_grid takes the
    warp kernel on the same blocks."""
    from multiprime_tpu_torch.align import device as adev
    monkeypatch.setattr(adev, "_REFINE_WARP_MAX_POS", 0)
    c, members, block = dp_case(case)
    refine_blocks_equal_plain(cuda, dp_case_rows(c, members), block, "cta")


@pytest.mark.parametrize("case", DP_CASES)
def test_gotoh_cta_kernel_equal_plain_on_tie_grid(cuda, case, monkeypatch):
    """The tie-heavy cases with the Gotoh dispatch forced to the CTA kernel
    (gotoh_dp_kernel, the one for blocks too wide for a warp), against the
    plain version; the test above takes the warp kernel on the same
    blocks."""
    from multiprime_tpu_torch.align import device as adev
    monkeypatch.setattr(adev, "_GOTOH_WARP_MAX_COLS", 0)
    c, members, block = dp_case(case)
    gotoh_blocks_equal_plain(cuda, c, members, block, "cta")


# block widths lb + 1 at each boundary of the warp kernel's columns a lane
# (32K - 1, 32K, 32K + 1 for K = 8, 16, ..., 40: 1281 is one past its
# limit, where the CTA kernel takes over)
WARP_EDGE_COLS = sorted({n for k in range(8, 41, 8)
                         for n in (32 * k - 1, 32 * k, 32 * k + 1)})


@pytest.mark.parametrize("cols", WARP_EDGE_COLS)
def test_gotoh_kernels_at_column_boundaries(cuda, cols):
    """Blocks whose lb + 1 sits at each K boundary of the warp kernel and
    one past its limit (1280 columns), where the CTA kernel takes over;
    members that end inside lane 0, on a lane's last or first column, at
    the block's width, and an empty one: equal to the plain version."""
    from multiprime_tpu_torch.align import device as adev
    rng = np.random.default_rng(cols)
    k = -(-cols // 256) * 8
    lb = cols - 1
    c = _dp_codes(rng, 48, 5)
    long_member = _dp_codes(rng, lb)
    long_member[:40] = np.where(c[:40] < 4, c[:40], 0)
    lens = {0, 5, k - 1, k, 2 * k - 1, 2 * k, lb - 1, min(lb, 60)}
    members = [long_member] + [_dp_codes(rng, n) for n in sorted(lens)
                               if 0 <= n < lb]
    gotoh = "warp" if cols <= 1280 else "cta"
    assert adev.gotoh_kernel_plan(lb)[0] == \
        {"warp": "gotoh_dp_warp", "cta": "gotoh_dp"}[gotoh]
    gotoh_blocks_equal_plain(cuda, c, members, len(members), gotoh)


@pytest.mark.parametrize("state", ["shared", "global"])
def test_dp_kernels_long_member_equal_plain(cuda, state, monkeypatch):
    """Members of about 5,000 bases against a 5,000-base center: the row
    state in shared memory, and (budget 0) in the global scratch."""
    from multiprime_tpu_torch.align import centerstar
    from multiprime_tpu_torch.align import device as adev
    if state == "global":
        monkeypatch.setattr(adev, "_DP_SMEM_BYTES", 0)
    rng = np.random.default_rng(83)
    c = _dp_codes(rng, 5000)
    b = c.copy()
    b[rng.random(5000) < 0.05] = 1
    b = np.insert(np.delete(b, rng.integers(0, 5000, size=40)),
                  rng.integers(0, 4900, size=35), 3)
    members = [b, _dp_codes(rng, 4900), np.tile(c[:100], 52)]
    seqs = ["".join("ACGT"[x] for x in s) for s in [c, *members]]
    _, rows = centerstar.center_star_msa(
        [str(i) for i in range(4)], seqs, backend="device", device=cuda)
    dp_blocks_equal_plain(cuda, c, members, 2, rows, gotoh="cta",
                          refine="cta")


def test_refine_warp_kernel_long_member_equal_plain(cuda):
    """The refine warp kernel's widest members: rows of up to 1,279
    residues (K = 40 positions a lane) in an MSA of about 1,300 columns,
    members with substitutions, indels and a tandem copy; the CTA kernel
    takes the 5,000-base rows of the test above."""
    from multiprime_tpu_torch.align import centerstar, refine
    from multiprime_tpu_torch.align import device as adev
    rng = np.random.default_rng(89)
    c = _dp_codes(rng, 1250)
    b = c.copy()
    b[rng.random(1250) < 0.05] = 1
    b = np.insert(np.delete(b, rng.integers(0, 1250, size=12)),
                  rng.integers(0, 1200, size=30), 3)
    members = [b, _dp_codes(rng, 1200), np.tile(c[:100], 12)[:1279],
               c[40:1000].copy()]
    seqs = ["".join("ACGT"[x] for x in s) for s in [c, *members]]
    _, rows = centerstar.center_star_msa(
        [str(i) for i in range(len(seqs))], seqs, backend="device",
        device=cuda)
    lmax = refine.device_pass_inputs(rows)[1].shape[1]
    assert 1248 < lmax + 1 <= 1280
    assert adev.refine_kernel_plan(lmax)[:2] == ("refine_dp_warp", 40)
    refine_blocks_equal_plain(cuda, rows, 3, "warp")


def _refine_inputs(rng, dev, lens, lmax, n_cols):
    """A seeded refine block: residue codes 0..5 [M, lmax], the given
    lengths, and a profile of n_cols columns whose frequencies and
    occupancies are multiples of 1/8 (so that many cells tie)."""
    from multiprime_tpu_torch.align import device as adev
    m = len(lens)
    res = rng.integers(0, 6, size=(m, max(lmax, 0))).astype(np.int64)
    f6 = (rng.integers(0, 9, size=(m, n_cols, 6)) / 8).astype(np.float32)
    occ = (rng.integers(0, 9, size=(m, n_cols)) / 8).astype(np.float32)
    return adev.refine_block_inputs(res, np.asarray(lens, np.int64), f6, occ,
                                    slice(0, m), device=dev)


@pytest.mark.parametrize("cols", WARP_EDGE_COLS)
def test_refine_kernels_at_position_boundaries(cuda, cols):
    """Blocks whose lmax + 1 sits at each K boundary of the refine warp
    kernel and one past its limit (1280 positions), where the CTA kernel
    takes over; members that end in lane 0, on a lane's last or first
    position, at the block's width, and an empty one: equal to the plain
    version, over a profile of lmax + 37 columns (not a multiple of 32)."""
    from multiprime_tpu_torch.align import device as adev
    rng = np.random.default_rng(cols)
    k = -(-cols // 256) * 8
    lmax = cols - 1
    lens = sorted({n for n in (0, 5, k - 1, k, 2 * k - 1, 2 * k, lmax - 1,
                               lmax) if 0 <= n <= lmax})
    refine = "warp" if cols <= 1280 else "cta"
    assert adev.refine_kernel_plan(lmax)[0] == \
        {"warp": "refine_dp_warp", "cta": "refine_dp"}[refine]
    blk = _refine_inputs(rng, cuda, lens, lmax, lmax + 37)
    refine_block_equal_plain(cuda, blk, refine, "lmax + 1 = %d" % cols)


@pytest.mark.parametrize("n_cols", [1, 7, 31, 32, 33, 45, 100])
@pytest.mark.parametrize("refine", ["warp", "cta"])
def test_refine_kernels_short_profiles(cuda, n_cols, refine, monkeypatch):
    """C = 1, C < 32, C at and past one chunk and not a multiple of 32:
    the warp kernel's staged profile ends inside its first or a later
    chunk; members longer than C (no end column beats -1e30, so the trace
    starts from column 0) and an empty one; both kernels equal the plain
    version."""
    from multiprime_tpu_torch.align import device as adev
    if refine == "cta":
        monkeypatch.setattr(adev, "_REFINE_WARP_MAX_POS", 0)
    rng = np.random.default_rng(n_cols)
    lmax = 70
    lens = [0, 1, min(n_cols, lmax), min(n_cols - 1, lmax), 33, lmax]
    blk = _refine_inputs(rng, cuda, lens, lmax, n_cols)
    refine_block_equal_plain(cuda, blk, refine, "C = %d" % n_cols)


def test_dp_wrappers_refuse_bad_inputs(cuda):
    from multiprime_tpu_torch.align import device as adev
    c = torch.zeros(10, dtype=torch.int32, device=cuda)
    bmat = torch.zeros((4, 12), dtype=torch.int32, device=cuda)
    lbs = torch.full((4,), 12, dtype=torch.int32, device=cuda)
    for bad in (bmat.to(torch.int64), bmat[:, ::2]):
        with pytest.raises(ValueError, match="bmat"):
            adev.gotoh_block(c, bad, lbs)
    for bad in (c.to(torch.int8), torch.zeros(20, dtype=torch.int32,
                                              device=cuda)[::2]):
        with pytest.raises(ValueError, match="c must"):
            adev.gotoh_block(bad, bmat, lbs)
    with pytest.raises(ValueError, match="lbs"):
        adev.gotoh_block(c, bmat, lbs.cpu())
    with pytest.raises(ValueError, match="lbs"):
        adev.gotoh_block(c, bmat, lbs + 1)
    codes = torch.zeros((3, 8), dtype=torch.int64, device=cuda)
    lens = torch.full((3,), 8, dtype=torch.int64, device=cuda)
    s4 = torch.zeros((5, 3, 6), dtype=torch.float32, device=cuda)
    occ = torch.zeros((5, 3), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="res_codes"):
        adev.refine_block(codes.to(torch.int32), lens, s4, occ, occ, occ)
    with pytest.raises(ValueError, match="res_codes"):
        adev.refine_block(torch.zeros((3, 16), dtype=torch.int64,
                                      device=cuda)[:, ::2], lens, s4, occ,
                          occ, occ)
    with pytest.raises(ValueError, match="s4"):
        adev.refine_block(codes, lens, s4.double(), occ, occ, occ)
    with pytest.raises(ValueError, match="go_c"):
        adev.refine_block(codes, lens, s4, torch.zeros(
            (3, 5), dtype=torch.float32, device=cuda).t(), occ, occ)
    with pytest.raises(ValueError, match="occ2"):
        adev.refine_block(codes, lens, s4, occ, occ, occ[:4])
    with pytest.raises(ValueError, match="lens"):
        adev.refine_block(codes, lens + 1, s4, occ, occ, occ)
    with pytest.raises(ValueError, match="codes"):
        adev.refine_block(codes + 6, lens, s4, occ, occ, occ)


def test_refine_positive_gap_terms_take_cta_kernel(cuda):
    """A positive go_c or ge_c (never GAP_OPEN * occ or GAP_EXT * occ): the
    block takes the CTA kernel (the warp kernel's position 0 needs G <= 0)
    and equals the plain version; the block without it keeps the warp
    kernel.  refine_pass_device with a positive gap open or extension
    equals its plain version on the CPU."""
    from multiprime_tpu_torch.align import device as adev
    from multiprime_tpu_torch.align import refine as rmod
    rng = np.random.default_rng(97)
    blk = _refine_inputs(rng, cuda, [0, 3, 40], 40, 50)
    refine_block_equal_plain(cuda, blk, "warp", "gap terms <= 0")
    for at in (3, 4):
        bad = list(blk)
        bad[at] = bad[at].clone()
        bad[at][7, 1] = 0.5
        refine_block_equal_plain(cuda, bad, "cta", "positive gap term")
    c, members, block = dp_case("homopolymer")
    args = rmod.device_pass_inputs(dp_case_rows(c, members))
    for go, ge in ((1.0, -1.0), (-4.0, 0.5)):
        before = _cuda.launches()
        got = adev.refine_pass_device(*args, go=go, ge=ge,
                                      member_block=block, device=cuda)
        assert launched(before, "refine_dp_warp") == 0
        assert got == adev.refine_pass_device(*args, go=go, ge=ge,
                                              member_block=block,
                                              device="cpu")


_FORK_AFTER_PROBE = r"""
import multiprocessing, torch
def work(_):
    return float(torch.ones(4, device="cuda").sum())
assert torch.cuda.is_available() and not torch.cuda.is_initialized()
with multiprocessing.get_context("fork").Pool(1) as pool:
    try:
        pool.map(work, [0])
    except RuntimeError as e:
        print("refused:", e)
"""


def test_forked_worker_cannot_reinit_cuda(cuda):
    """Why the driver forks its cluster pool from a forkserver, not from
    itself, when the workers run torch ops: once a process asked
    torch.cuda.is_available() (as Pipeline does), a forked child's first
    CUDA call raises, though is_initialized() is still False in the
    parent."""
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _FORK_AFTER_PROBE],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "refused:" in out.stdout and "forked subprocess" in out.stdout


_FORKSERVER_PROBE = """
import os, time
from multiprime_tpu_torch.pipeline import driver


class StartProbe(driver.Pipeline):
    # a worker reports when its first task began in place of a cluster
    def _pooled_cluster(self, name):
        return os.getpid(), time.perf_counter_ns()
"""

_FORKSERVER_JOBS = r"""
import json, os, sys, time
import numpy as np
from torch.profiler import ProfilerActivity, profile
from multiprime_tpu_torch.pipeline import driver
from multiprime_tpu_torch.utils import trace
work = sys.argv[1]
sys.path.insert(0, work)
import fanout_probe
res = os.path.join(work, "res")


def pool_start():
    # the longest time from a fan-out's pool to a worker's first task
    pipe = fanout_probe.StartProbe(driver.PipelineConfig(
        results_dir=res, device="cuda", stage_a="device"))
    t0 = time.perf_counter_ns()
    first = {}
    for pid, t in pipe._fan_out(["c_%d" % i for i in range(8)], 8):
        first[pid] = min(t, first.get(pid, t))
    return max(first.values()) - t0, pipe.pool


probes = [pool_start(), pool_start()]
rng = np.random.default_rng(43)
lut = np.array(list("ACGT"))
fa = os.path.join(work, "ten.fa")
with open(fa, "w") as f:
    for b in range(10):
        base = rng.choice(lut, size=480)
        for i in range(8):
            s = base.copy()
            s[rng.integers(0, len(s), size=6)] = rng.choice(lut, size=6)
            f.write(">F%d_%d\n%s\n" % (b, i, "".join(s)))
jobs = []
for job in range(2):
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.request("run"):
            pipe, _ = driver.run_pipeline(
                None, input_fa=fa, results_dir=res, virus_name="ten",
                coverage=0.5, min_seq_length=100, product_size=(100, 400),
                algo="v20", device="cuda", stage_a="device",
                align_backend="centerstar-device", nproc=8)
    spans = trace.take()
    tree = {}
    for root, _, files in os.walk(res):
        for name in files:
            if name != "pipeline_metrics.json":
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    tree[os.path.relpath(path, res)] = f.read().hex()
    os.rename(res, res + str(job))
    starts = [(s["end"] - s["start"]) / 1e9 for s in spans
              if s["name"] == "worker.start"]
    jobs.append({"tree": tree, "starts": starts,
                 "fanout": next(s["counts"] for s in spans
                                if s["name"] == "fanout"),
                 "backends": pipe._backends()})
print(json.dumps({"probes": probes, "jobs": jobs}))
"""


def test_forkserver_workers_run_stage_a_and_gotoh_on_card(cuda, tmp_path):
    """In one fresh process: a pool of 8 whose forkserver starts cold
    (the server imports torch and the port), then a pool from the warm
    server, whose workers reach their first task in under a third of
    the cold pool's time; then two `run --nproc 8 --stage-a device`
    jobs with the device Gotoh, every cluster's Stage A and Gotoh DP on
    the card in workers forked from the warm server (each makes its own
    context), the two trees identical."""
    import json
    import os
    import subprocess
    import sys
    (tmp_path / "fanout_probe.py").write_text(_FORKSERVER_PROBE)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FORKSERVER_JOBS,
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=900, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    (cold, cold_pool), (warm, warm_pool) = got["probes"]
    assert cold_pool == {"pool_start": "forkserver", "pool_server_warm": 0}
    assert warm_pool == {"pool_start": "forkserver", "pool_server_warm": 1}
    assert warm < cold / 3, (cold / 1e9, warm / 1e9)
    first, second = got["jobs"]
    assert first["tree"] == second["tree"]
    for job in (first, second):
        assert job["fanout"]["workers"] == 8
        assert job["fanout"]["pool.forkserver"] == 1
        assert job["fanout"]["pool.server_warm"] == 1
        assert len(job["starts"]) == 8
        b = job["backends"]
        assert b["pool_start"] == "forkserver"
        assert b["pool_server_warm"] == 1
        n = job["fanout"]["clusters"]
        assert n >= 8
        assert b["stage_a_served"] == b["align_served"] == {"device": n}
        assert b["launches"]["stage_a_windows"] > 0
        assert b["launches"]["gotoh_dp_warp"] + b["launches"]["gotoh_dp"] > 0


def _planted_background(rng, lengths, pats, near):
    """Random targets of the given lengths with the patterns (and their
    reverse complements) planted at random positions and straddling each
    offset of `near` (segment boundaries), 0-1 substitutions outside the
    last 4 bases."""
    from multiprime_tpu_torch.utils import iupac
    seqs = []
    for n in lengths:
        s = list(rng.choice(np.array(list("ACGT")), size=n))
        spots = [b - int(rng.integers(1, 17)) for b in near if b < n - 40]
        spots += [int(rng.integers(0, n - 40)) for _ in range(30)]
        for i, at in enumerate(spots):
            p = iupac.expand(pats[i % len(pats)])[0]
            if i % 2:
                p = iupac.rc(p)
            p = list(p)
            if i % 3 == 0:
                k = int(rng.integers(0, len(p) - 4))
                p[k] = "A" if p[k] != "A" else "C"
            s[at:at + len(p)] = p
        seqs.append("".join(s))
    return seqs


def test_scan_hits_long_on_card_equals_cpu(cuda):
    """Targets of 3-4 segments of 65,536 bases (stride 65,519 for 18-mers),
    hits planted across the segment boundaries: the card's scan equals the
    host scan and the plain version on the CPU, hit for hit."""
    rng = np.random.default_rng(7)
    pats = ["".join(rng.choice(list("ACGTRY"), size=18)) for _ in range(12)]
    stride = (1 << 16) - 17
    seqs = _planted_background(rng, [150000, 200000, 260000], pats,
                               [stride * k for k in range(1, 4)])
    from multiprime_tpu_torch.utils import iupac
    for patterns in (pats, [iupac.rc(p) for p in pats]):
        got = vscan.scan_hits_long(seqs, patterns, vscan.ScanParams(
            mm=1, term=4, backend="device", want_mism=True), device=cuda)
        host = vscan.scan_hits_long(seqs, patterns, vscan.ScanParams(
            mm=1, term=4, backend="numpy"), device=cuda)
        plain = vscan.scan_hits_long(seqs, patterns, vscan.ScanParams(
            mm=1, term=4, backend="device", want_mism=True,
            device_batch_seqs=4), device="cpu")
        assert got == plain == host
        crossing = [h for h in got if h[1] % stride > stride - 18]
        assert len(got) > 40 and crossing


def test_specificity_on_card_equals_cpu(cuda, tmp_path):
    """A small `specificity` run (with and without --exhaustive-join) on the
    card writes the files that --device cpu writes, byte for byte."""
    from multiprime_tpu_torch.cli import main as cli
    rng = np.random.default_rng(9)
    pats = ["".join(rng.choice(list("ACGTRYKM"), size=20)) for _ in range(8)]
    seqs = _planted_background(rng, [int(rng.integers(3000, 9000))
                                     for _ in range(30)], pats, [])
    bg = tmp_path / "bg.fa"
    bg.write_text("".join(">b%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))
    prim = "".join(">P%d_%s\n%s\n" % (i // 2, "FR"[i % 2], p)
                   for i, p in enumerate(pats))
    for extra in ([], ["--exhaustive-join"]):
        outs = {}
        for device in ("cuda", "cpu"):
            d = tmp_path / (device + "".join(extra))
            d.mkdir()
            (d / "p.fa").write_text(prim)
            assert cli.main(["specificity", "-i", str(d / "p.fa"), "-r",
                             str(bg), "-l", "18", "-t", "4", "-m", "1", "-s",
                             "100,1500", "-o", str(d / "s.out"), "--device",
                             device] + extra) == 0
            outs[device] = {p.name: p.read_bytes() for p in d.iterdir()}
        assert outs["cuda"] == outs["cpu"]
        assert outs["cuda"]["s.out"].count(b"\n") > 5


def test_find_hits_sharded_on_a_mesh_of_one_card(cuda):
    """A 2-shard Mesh of cuda:0 (one card twice): find_hits_sharded's
    blocks, decoded with their row offsets, equal find_hits_packed of the
    whole batch on the card and the plain version's compaction on the CPU,
    each shard one launch of the find_hits kernels; the two-level
    compaction of more hits than max_hits on the card equals the plain
    one on the CPU; asking make_mesh for more GPUs than are present
    raises."""
    from multiprime_tpu_torch.parallel import mesh as pmesh
    rng = np.random.default_rng(61)
    masks, lens, p1h, s1h = _inputs(rng, 24, 200, 900, 40, 18, 2,
                                    letters="ACGTACGTACGTN")
    plen, n_out, p = 18, masks.shape[1] - 17, p1h.shape[0]
    mesh = pmesh.Mesh([["cuda:0", "cuda:0"]])
    before = _cuda.launches()
    blocks = pmesh.find_hits_sharded(mesh, masks, lens, p1h, s1h, mm=3,
                                     term=2, max_hits_per_shard=8192,
                                     want_mism=True)
    assert launched(before, "find_hits") == 2
    got = []
    for si, blk in enumerate(blocks):
        seq, pos, pat, mism, n = ms.decode_packed(blk, n_out, p, 8192)
        assert n <= 8192
        got += list(zip((seq + si * 12).tolist(), pos.tolist(),
                        pat.tolist(), mism.tolist()))
    planes, sfx = ms.pack_patterns(p1h, s1h, device=cuda)
    whole = ms.find_hits_packed(torch.from_numpy(masks).to(cuda),
                                torch.from_numpy(lens).to(cuda), planes,
                                sfx, plen=plen, mm=3, term=2, max_hits=1 << 14)
    seq, pos, pat, mism, n_hits = ms.decode_packed(whole.cpu().numpy(),
                                                   n_out, p, 1 << 14)
    assert 8 < n_hits <= 1 << 14 and got == list(zip(seq.tolist(), pos.tolist(),
                                          pat.tolist(), mism.tolist()))
    for max_hits in (1 << 14, 7):
        codes = ms.hit_codes(torch.from_numpy(masks).to(cuda), planes, sfx,
                             plen=plen, mm=3, term=2)
        dev_out = ms.find_hits_from_codes(
            codes, torch.from_numpy(lens).to(cuda), plen=plen,
            max_hits=max_hits)
        cpu_out = ms.find_hits_from_codes(
            codes.cpu(), torch.from_numpy(lens), plen=plen,
            max_hits=max_hits)
        for a, b in zip(dev_out, cpu_out):
            assert torch.equal(a.cpu(), b)
    with pytest.raises(RuntimeError, match="are present"):
        pmesh.make_mesh(torch.cuda.device_count() + 1, device="cuda")


def _genome_family(seed, n, length, div, indel_rate):
    """A family of ``n`` genomes of about ``length`` bases: substitutions at
    ``div``, indels of 1-12 bases at ``indel_rate`` a base (insertions and
    deletions with equal odds), every tenth member the base itself."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=length)
    seqs = []
    for k in range(n):
        s = base.copy()
        if k % 10:
            hit = rng.random(length) < div
            s[hit] = rng.integers(0, 4, size=int(hit.sum()))
            pieces, prev = [], 0
            for at in np.flatnonzero(rng.random(length) < indel_rate):
                if at < prev:
                    continue
                m = int(min(rng.geometric(0.5), 12))
                pieces.append(s[prev:at])
                if rng.random() < 0.5:
                    pieces.append(rng.integers(0, 4, size=m))
                    prev = at
                else:
                    prev = at + m
            s = np.concatenate(pieces + [s[prev:]])
        seqs.append("".join("ACGT"[v] for v in s))
    return seqs


@pytest.fixture(scope="module")
def genome_family():
    """500 genomes of about 8.3 kb at 3% divergence with indels (a family
    of the run.genome cell), its center's codes and members' codes, and
    the center-star MSA of the device DP."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from multiprime_tpu_torch.align import centerstar
    seqs = _genome_family(97, 500, 8300, 0.03, 0.001)
    ids = [str(i) for i in range(len(seqs))]
    _, rows = centerstar.center_star_msa(ids, seqs, backend="device",
                                         device="cuda")
    center = centerstar.pick_center(seqs)
    codes = [centerstar._encode(s) for s in seqs]
    return (codes[center], [codes[k] for k in range(len(seqs))
                            if k != center], rows)


def test_gotoh_genome_family_blocks_by_bytes_equal_native(cuda,
                                                          genome_family):
    """A 500-genome family of 8.3 kb through align_ops_batch_device under
    the byte budget (several CTA-kernel blocks, not one of 512) equals the
    native DP, and the card's peak stays under the budget and the inputs."""
    from multiprime_tpu_torch import native
    from multiprime_tpu_torch.align import device as adev
    c, members, _ = genome_family
    lb = max(len(b) for b in members)
    per = adev.gotoh_member_bytes(len(c), lb)
    assert adev.gotoh_kernel_plan(lb)[0] == "gotoh_dp"
    assert 1 < adev.block_members(per, 512) < len(members)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _cuda.launches()
    got = adev.align_ops_batch_device(c, members, as_codes=True,
                                      device=cuda)
    peak = torch.cuda.max_memory_allocated() - base
    blocks = -(-len(members) // adev.block_members(per, 512))
    assert launched(before, "gotoh_dp", "gotoh_dp_warp") == blocks
    # one block's bytes and the center's codes, each allocation rounded
    # up to whole 2 MiB pages
    assert peak <= adev._DP_BLOCK_BYTES + 4 * len(c) + (32 << 20), peak
    if not native.available():
        pytest.skip("native toolchain unavailable")
    nat = native.gotoh_ops_batch(c, members)
    s = min(nat.shape[1], got.shape[1])
    assert np.array_equal(got[:, :s], nat[:, :s])
    assert (got[:, s:] == 3).all() and (nat[:, s:] == 3).all()


def test_refine_msa_card_equals_host_at_genome_width(cuda, genome_family):
    """refine_msa on the card (CTA-kernel blocks under the byte budget)
    equals the host passes on the family's MSA of more than 10,000
    columns, and the card's peak stays under the budget and the inputs."""
    from multiprime_tpu_torch.align import device as adev
    from multiprime_tpu_torch.align import refine
    _, _, rows = genome_family
    c = len(rows[0])
    lmax = max(len(r) - r.count("-") for r in rows)
    assert c > 10000
    assert adev.refine_kernel_plan(lmax)[0] == "refine_dp"
    per = adev.refine_member_bytes(c, lmax)
    assert 1 < adev.block_members(per, 256) < len(rows)
    want = refine.refine_msa(rows, 2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _cuda.launches()
    got = refine.refine_msa(rows, 2, backend="device", device=cuda)
    peak = torch.cuda.max_memory_allocated() - base
    assert launched(before, "refine_dp", "refine_dp_warp") >= 2
    assert got == want
    assert peak <= adev._DP_BLOCK_BYTES + (32 << 20), peak


def _identity_pairs(rng, n, lo, hi):
    """n (query, representative) code pairs of lo..hi bases: two in three
    related (2-40% substitutions, indels, Ns), the rest unrelated."""
    codes, meta, at = [], [], 0
    for k in range(n):
        b = rng.integers(0, 4, size=int(rng.integers(lo, hi + 1)))
        if k % 3 == 2:
            a = rng.integers(0, 4, size=int(rng.integers(lo, len(b) + 1)))
        else:
            a = b.copy()
            hit = rng.random(len(a)) < rng.uniform(0.02, 0.4)
            a[hit] = rng.integers(0, 5, size=int(hit.sum()))
            a = np.delete(a, rng.integers(0, len(a), size=int(
                rng.integers(0, 30))))[:len(b)]
        codes += [a.astype(np.int8), b.astype(np.int8)]
        meta.append((at, len(a), at + len(a), len(b)))
        at += len(a) + len(b)
    return np.concatenate(codes), np.array(meta, np.int64).T


def _native_identities(codes, meta):
    from multiprime_tpu_torch import native
    return [native.banded_identity(codes[q:q + lq], codes[r:r + lr], 64)
            for q, lq, r, lr in meta.T.tolist()]


@pytest.mark.parametrize("lo,hi", [(8200, 8400), (850, 950)])
def test_banded_identity_kernel_equals_native(cuda, lo, hi):
    """32 pairs at genome and at CDS length: the kernel's match counts
    equal the plain version's on the card and its identities native's,
    to the bit; some pairs reach the threshold and some do not."""
    from multiprime_tpu_torch.cluster import identity
    codes, meta = _identity_pairs(np.random.default_rng(lo), 32, lo, hi)
    cd = torch.from_numpy(codes).to(cuda)
    before = _cuda.launches()
    got = identity.banded_matches(cd, meta, 64).cpu().numpy()
    assert launched(before, *IDENTITY) == 1
    plain = identity.banded_matches_reference(cd, meta, 64).cpu().numpy()
    assert np.array_equal(got, plain)
    want = _native_identities(codes, meta)
    assert identity.identities(got, meta) == want
    assert 0 < sum(w >= 0.7 for w in want) < 32


@pytest.mark.parametrize("la,bits", [(16383, 32), (16384, 64)])
def test_banded_identity_kernel_at_the_32bit_key_limit(cuda, la, bits):
    """Pairs on both sides of the 32-bit key's limit (S = 2**14 while la <
    2**14) equal native; the plan takes the key width the lengths give."""
    from multiprime_tpu_torch.cluster import identity
    rng = np.random.default_rng(la)
    a = rng.integers(0, 4, size=la).astype(np.int8)
    b = a.copy()
    hit = rng.random(la) < 0.1
    b[hit] = rng.integers(0, 5, size=int(hit.sum()))
    b = np.concatenate([b[:la // 2], b[la // 2 + 20:],
                        rng.integers(0, 4, size=50).astype(np.int8)])
    c = rng.integers(0, 4, size=la - 7).astype(np.int8)
    codes = np.concatenate([a, b, c])
    meta = np.array([[0, 0, la + len(b)], [la, la, la - 7],
                     [la, la + len(b), la], [len(b), la - 7, len(b)]],
                    np.int64)
    assert identity.identity_plan(meta[1], meta[3], 64)[1] == bits
    got = identity.banded_matches(torch.from_numpy(codes).to(cuda), meta, 64)
    assert identity.identities(got.cpu().numpy(), meta) \
        == _native_identities(codes, meta)


def test_banded_identity_kernel_edge_grid(cuda):
    """Empty sequences, swapped pairs (the query longer), bands at each
    cells-a-lane step (widths 128-1,024) and past it into the wide kernel
    (1,025, 1,026 and past its first chunks), all-N and all-equal pairs:
    the kernels equal the plain version and native."""
    from multiprime_tpu_torch.cluster import identity
    rng = np.random.default_rng(7)
    seqs = [np.zeros(0, np.int8), np.full(40, 4, np.int8),
            rng.integers(0, 4, size=300).astype(np.int8)]
    for diff in (0, 1, 127, 128, 129, 255, 256, 383, 384, 511, 512, 767,
                 768, 895, 896, 897, 1151, 1700):
        seqs.append(np.concatenate([seqs[2], rng.integers(
            0, 5, size=diff).astype(np.int8)]))
    offs = np.cumsum([0] + [len(s) for s in seqs])[:-1]
    pairs = [(q, r) for q in range(len(seqs)) for r in range(len(seqs))
             if identity.kernel_takes(len(seqs[q]), len(seqs[r]), 64)]
    meta = np.array([[offs[q] for q, _ in pairs],
                     [len(seqs[q]) for q, _ in pairs],
                     [offs[r] for _, r in pairs],
                     [len(seqs[r]) for _, r in pairs]], np.int64)
    codes = np.concatenate(seqs)
    cd = torch.from_numpy(codes).to(cuda)
    for cut in (meta, meta[:, :5], meta[:, -3:]):
        got = identity.banded_matches(cd, cut, 64).cpu().numpy()
        plain = identity.banded_matches_reference(cd, cut, 64).cpu().numpy()
        assert np.array_equal(got, plain)
        assert identity.identities(got, cut) == _native_identities(codes, cut)


@pytest.mark.parametrize("key_la", [2000, 16500])
def test_banded_identity_wide_kernel_equals_native(cuda, key_la):
    """Bands past the register kernel's 1,024 cells (a partial genome
    beside a complete one, |lb - la| > 895) in 32- and 64-bit keys, in one
    call with pairs the register kernel takes: every match count equals
    the plain version's and every identity native's; the wide pairs take
    a launch of their own."""
    from multiprime_tpu_torch.cluster import identity
    rng = np.random.default_rng(key_la)
    full = rng.integers(0, 4, size=key_la + 1300).astype(np.int8)
    seqs = [full]
    for cut, div in ((900, 0.02), (1000, 0.1), (1300, 0.3), (0, 0.05)):
        s = full[cut // 2:len(full) - cut + cut // 2].copy()
        hit = rng.random(len(s)) < div
        s[hit] = rng.integers(0, 5, size=int(hit.sum()))
        seqs.append(np.delete(s, rng.integers(0, len(s), size=8)))
    seqs.append(rng.integers(0, 4, size=key_la).astype(np.int8))
    offs = np.cumsum([0] + [len(s) for s in seqs])[:-1]
    pairs = [(q, 0) for q in range(1, len(seqs))] + [(0, 2), (5, 1)]
    meta = np.array([[offs[q] for q, _ in pairs],
                     [len(seqs[q]) for q, _ in pairs],
                     [offs[r] for _, r in pairs],
                     [len(seqs[r]) for _, r in pairs]], np.int64)
    width = identity._width(meta[1], meta[3], 64)
    assert (width > identity._MAX_WIDTH).sum() >= 4
    assert (width <= identity._MAX_WIDTH).sum() >= 2
    assert identity.identity_plan(meta[1], meta[3], 64)[1] == (
        32 if key_la < 1 << 14 else 64)
    codes = np.concatenate(seqs)
    cd = torch.from_numpy(codes).to(cuda)
    before = _cuda.launches()
    got = identity.banded_matches(cd, meta, 64).cpu().numpy()
    assert launched(before, *IDENTITY) == 2
    plain = identity.banded_matches_reference(cd, meta, 64).cpu().numpy()
    assert np.array_equal(got, plain)
    want = _native_identities(codes, meta)
    assert identity.identities(got, meta) == want
    assert max(want) >= 0.7


def _cluster_corpus(seed, length, families, members, singletons,
                    partial=0.0):
    """Families of mutated copies of ``length``-ish bases and random
    singletons; a ``partial`` share of the members cut to 86% of their
    length (a partial genome beside complete ones)."""
    rng = np.random.default_rng(seed)
    lut = np.array(list("ACGT"))
    seqs = []
    for _ in range(families):
        base = rng.integers(0, 4, size=length + int(rng.integers(0, 100)))
        for _ in range(members):
            s = base.copy()
            hit = rng.random(len(s)) < 0.03
            s[hit] = rng.integers(0, 4, size=int(hit.sum()))
            s = np.delete(s, rng.integers(0, len(s), size=int(
                rng.integers(0, 12))))
            if rng.random() < partial:
                s = s[:int(0.86 * len(s))]
            seqs.append("".join(lut[s]))
    for _ in range(singletons):
        seqs.append("".join(lut[rng.integers(0, 4, size=length + int(
            rng.integers(0, 100)))]))
    return [str(i) for i in range(len(seqs))], seqs


@pytest.mark.parametrize("length,window,partial", [
    (8300, 2112, 0.0), (8300, 5, 0.0), (900, 2112, 0.0), (900, 1, 0.0),
    (8300, 2112, 0.3)])
def test_windowed_clusters_on_card_equal_host(cuda, length, window, partial,
                                              monkeypatch):
    """The windowed walk with every window on the card gives the serial
    host walk's clusters, identities included, at genome length (the word
    filter passes unrelated representatives) and at CDS length, with
    windows cut short and whole, and with partial genomes of 7.1 kb beside
    complete ones (bands past the register kernel: the wide kernel)."""
    from multiprime_tpu_torch.cluster import greedy
    monkeypatch.setattr(greedy, "_WINDOW_PAIRS", window)
    ids, seqs = _cluster_corpus(length, length, 3, 12, 4, partial)
    if partial:
        lens = [len(x) for x in seqs]
        assert max(lens) - min(lens) > 895
    want_order, want = greedy.greedy_cluster(ids, seqs, threads=4)
    before = _cuda.launches()
    order, got = greedy.greedy_cluster_windows(ids, seqs, threads=4,
                                               device=cuda)
    assert order == want_order
    assert [(c.rep_index, c.members) for c in got] \
        == [(c.rep_index, c.members) for c in want]
    assert launched(before, *IDENTITY) > 0


_CLUSTER_RUN = r"""
import json, os, sys
from multiprime_tpu_torch.cli import main as cli
fa, res = sys.argv[1], sys.argv[2]
rc = cli.main(["run", "-i", fa, "-r", res, "--nproc", "2", "--device",
               "cuda"])
assert rc == 0, rc
with open(os.path.join(res, "pipeline_metrics.json")) as f:
    print(json.dumps(json.load(f)["backends"]))
"""


def test_run_clusters_on_card_equal_host_and_fork_from_server(cuda,
                                                              tmp_path):
    """`run --nproc 2` with the host policies (Stage A on the host, the
    native center-star) in fresh processes: with MPTPU_FORCE_BACKEND=device
    the parent clusters on the card, so its CUDA context makes the fan-out
    take the forkserver, and the .clstr equals the host run's byte for
    byte."""
    import json
    import os
    import subprocess
    import sys
    ids, seqs = _cluster_corpus(5, 900, 3, 15, 4)
    fa = tmp_path / "in.fa"
    fa.write_text("".join(">%s\n%s\n" % p for p in zip(ids, seqs)))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = {}
    for side in ("host", "device"):
        res = tmp_path / side
        env = dict(os.environ, MPTPU_FORCE_BACKEND=side)
        out = subprocess.run([sys.executable, "-c", _CLUSTER_RUN, str(fa),
                              str(res)], capture_output=True, text=True,
                             timeout=600, cwd=root, env=env)
        assert out.returncode == 0, out.stderr[-4000:]
        clstr = res / "Total_fa" / "in.format.rmdup.cluster.uniq.fa.clstr"
        got[side] = (json.loads(out.stdout.strip().splitlines()[-1]),
                     clstr.read_bytes())
    (host, host_clstr), (dev, dev_clstr) = got["host"], got["device"]
    assert dev_clstr == host_clstr
    assert sum(host["launches"][k] for k in IDENTITY) == 0
    assert sum(dev["launches"][k] for k in IDENTITY) > 0
    assert dev["pool_start"] == "forkserver"


def test_two_runs_in_one_process_report_their_own_launches(cuda, tmp_path,
                                                           monkeypatch):
    """Two device `run`s in one process, as the benchmark runs its jobs:
    each reports its own launches in ``backends["launches"]`` (clustering
    and the coverage scan on the card), so the second reports what the
    first did, not the sum of both."""
    from multiprime_tpu_torch.pipeline import driver
    monkeypatch.setenv("MPTPU_FORCE_BACKEND", "device")
    ids, seqs = _cluster_corpus(5, 900, 3, 15, 4)
    fa = tmp_path / "in.fa"
    fa.write_text("".join(">%s\n%s\n" % p for p in zip(ids, seqs)))
    got = []
    for k in range(2):
        pipe, _ = driver.run_pipeline(
            None, input_fa=str(fa), results_dir=str(tmp_path / str(k)),
            device="cuda", nproc=1)
        got.append(pipe._backends()["launches"])
    assert got[0]["find_hits"] > 0
    assert sum(got[0][k] for k in IDENTITY) > 0
    assert got[1] == got[0]
