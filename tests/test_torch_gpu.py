"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: these skip where torch.cuda.is_available() is False.  This
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

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
        before = ms.HIT_CODES_LAUNCHES
        got = ms.hit_codes(tm, planes, sfx, plen=plen, mm=mm, term=term)
        assert ms.HIT_CODES_LAUNCHES == before + 1
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
        before = ms.MATCH_COUNTS_LAUNCHES
        got = ms.match_counts_kernel(masks, planes, plen=plen)
        assert ms.MATCH_COUNTS_LAUNCHES == before + 1
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
        before = ms.HIT_WINDOW_BITMAP_LAUNCHES
        got = ms.hit_window_bitmap_kernel(tm, planes, sfx, **kw)
        assert ms.HIT_WINDOW_BITMAP_LAUNCHES == before + 1
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
    before = ms.HIT_WINDOW_BITMAP_LAUNCHES
    got = ms.find_hits_bitmap(seqs_1h, lens, p1h, s1h, mm=3, term=2,
                              device=cuda)
    assert ms.HIT_WINDOW_BITMAP_LAUNCHES == before + 1
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
    before = ms.HIT_WINDOW_BITMAP_LAUNCHES
    got = ms.find_hits_bitmap(raw_1h, lens, p1h, s1h, mm=2, term=2,
                              device=cuda)
    assert ms.HIT_WINDOW_BITMAP_LAUNCHES == before + 1
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
    before = ms.MATCH_COUNTS_LAUNCHES
    fused = dimer.dimer_hit_matrix_fused(primers, device=cuda)
    assert ms.MATCH_COUNTS_LAUNCHES == before + 1
    unfused = dimer.dimer_hit_matrix(primers, device=cuda)
    assert ms.MATCH_COUNTS_LAUNCHES > before + 1
    assert fused[1, 2]
    assert np.array_equal(fused, host) and np.array_equal(unfused, host)


# ---------------------------------------------------------------------------
# the device torch ops of design Stage A and the center-star/refine DPs:
# the card's results equal the CPU's (integers, op codes, refined rows)
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


@pytest.mark.parametrize("plen,variation", [(18, 1), (25, 2)])
def test_design_stats_blocks_card_equals_cpu(cuda, plen, variation):
    from multiprime_tpu_torch.ops import design_scan
    rng = np.random.default_rng(plen)
    masks = _stage_a_masks(rng, 120, 400)
    positions = np.arange(3, 400 - plen)
    kw = dict(plen=plen, variation=variation, block=128)
    want = list(design_scan.design_stats_blocks(masks, positions,
                                                device="cpu", **kw))
    got = list(design_scan.design_stats_blocks(masks, positions,
                                               device=cuda, **kw))
    assert len(got) == len(want) == 3
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
    """Why the driver spawns its cluster pool when the workers run torch
    ops: once a process asked torch.cuda.is_available() (as Pipeline does),
    a forked child's first CUDA call raises, though is_initialized() is
    still False in the parent."""
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _FORK_AFTER_PROBE],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "refused:" in out.stdout and "forked subprocess" in out.stdout


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
