"""The port's match counts and two-phase bitmap scan against the JAX
package's, on the CPU.

Same NumPy inputs through both: the JAX functions run on the CPU (the
Pallas kernels in interpret mode), the port with CPU tensors, which take
the plain PyTorch versions of the CUDA kernels ``csrc/match_counts.cu`` and
``csrc/hit_window_bitmap.cu``.  Counts are small integers in float32, bitmaps
and hit tuples integers: all must be equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiprime_tpu.ops import mismatch_scan as jms
from multiprime_tpu_torch.ops import mismatch_scan as tms

from .test_torch_scan import _pad8, _planted, _rand_seqs, _suffix


def _raw_onehot(seqs, length=None):
    """Target one-hots WITHOUT the purity rule: an IUPAC code sets every
    member base, so positions hold 0-4 bases (what match_counts_conv
    accepts and encode_targets never makes)."""
    masks, lens = jms.encode_target_masks(seqs, length)
    return ((masks[..., None] >> np.arange(4)) & 1).astype(np.uint8), lens


def _degenerate_patterns(rng, n, plen):
    lut = np.array(list("ACGTACGTACGTRYSWKMBDHVN"))
    return ["".join(rng.choice(lut, size=plen)) for _ in range(n)]


# ---------------------------------------------------------------------------
# match counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plen", [5, 8, 12, 18, 25, 32, 64])
def test_match_counts_equal_conv_and_pallas(plen):
    """Degenerate patterns against ambiguous, multi-base, gapped and
    lowercase targets: float32 counts equal bit for bit."""
    rng = np.random.default_rng(plen)
    seqs = _rand_seqs(rng, 11, plen, plen + 70,
                      letters="ACGTACGTacgtNRYSWKMBDHV-")
    t1h, _ = _raw_onehot(seqs)
    p1h = jms.encode_primers(_degenerate_patterns(rng, 5, plen))
    conv = np.asarray(jms.match_counts_conv(t1h, p1h))
    pallas = np.asarray(jms.match_counts_pallas(t1h, p1h, interpret=True))
    got = tms.match_counts(t1h, p1h, device="cpu")
    assert got.dtype == torch.float32 and got.is_contiguous()
    got = got.numpy()
    assert got.shape == conv.shape == (11, t1h.shape[1] - plen + 1, 5)
    assert np.array_equal(got, conv) and np.array_equal(got, pallas)
    assert got.max() > 0


def test_match_counts_kernel_plain_on_masks():
    """The wrapper on CPU masks and planes equals match_counts on the
    one-hots, including zero (left-padding) pattern columns."""
    rng = np.random.default_rng(5)
    seqs = _rand_seqs(rng, 7, 30, 60, letters="ACGTNRY-")
    t1h, _ = _raw_onehot(seqs)
    pats = ["-" * 6 + p for p in _degenerate_patterns(rng, 9, 10)]
    p1h = jms.encode_primers(pats)
    masks = tms.onehot_masks(t1h)
    assert masks.dtype == torch.uint8 and tuple(masks.shape) == t1h.shape[:2]
    planes = tms.pattern_planes(p1h, device="cpu")
    got = tms.match_counts_kernel(masks, planes, plen=16)
    want = np.asarray(jms.match_counts_conv(t1h, p1h))
    assert np.array_equal(got.numpy(), want)
    short = tms.match_counts_kernel(masks[:, :10], planes, plen=16)
    assert tuple(short.shape) == (7, 0, 9)


def test_pattern_planes_use_bit_63():
    p1h = np.zeros((2, 64, 4), np.uint8)
    p1h[0, 63, 2] = 1
    p1h[1, :, 0] = 1
    planes = tms.pattern_planes(p1h, device="cpu")
    assert int(planes[0, 2]) == -(1 << 63)       # bit 63: the sign bit
    assert int(planes[1, 0]) == -1               # all 64 bits
    unpacked = tms._unpack_planes(planes, 64)
    assert np.array_equal(unpacked.permute(0, 2, 1).numpy(), p1h)
    with pytest.raises(ValueError, match="exceeds 64"):
        tms.pattern_planes(np.zeros((1, 65, 4), np.uint8), device="cpu")


@pytest.mark.parametrize("fn", ["match_counts_kernel",
                                "hit_window_bitmap_kernel"])
def test_new_wrappers_check_device(fn):
    planes = torch.zeros((8, 4), dtype=torch.int64)
    masks = torch.zeros((2, 16), dtype=torch.uint8, device="meta")
    kwargs = {"plen": 8}
    args = (masks, planes)
    if fn == "hit_window_bitmap_kernel":
        args += (planes,)
        kwargs.update(mm=1, term=2)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tms, fn)(*args, **kwargs)


# ---------------------------------------------------------------------------
# hit_window_bitmap
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bitmap_inputs():
    rng = np.random.default_rng(21)
    plen = 18
    seqs = _rand_seqs(rng, 13, 10, 260, letters="ACGTACGTACGTacgtNRY-")
    seqs[0] += "ACGT" * plen
    pats = _planted(rng, seqs, 21, plen)
    pats[-1] = "N" * plen
    return seqs, pats, plen


@pytest.mark.parametrize("mm", range(5))
@pytest.mark.parametrize("term", [0, 1, 4, 19])
def test_hit_window_bitmap_equals_conv_and_pallas(bitmap_inputs, mm, term):
    """mm 0-4, term 0/1/4/plen+1, zero pattern rows: the port's bitmap
    (mask and one-hot input) equals the conv reduction and the Pallas
    kernel after the window-length mask."""
    seqs, pats, plen = bitmap_inputs
    p1h = jms.encode_primers(pats)
    p1h, s1h = _pad8(p1h, _suffix(p1h, term))
    t1h, lens = jms.encode_targets(seqs)
    masks, _ = jms.encode_target_masks(seqs)
    conv = np.asarray(jms.hit_window_bitmap(
        jnp.asarray(masks), jnp.asarray(lens), jnp.asarray(p1h),
        jnp.asarray(s1h), mm=mm, term=term, backend="conv"))
    pallas = np.asarray(jms.hit_window_bitmap_pallas(
        jnp.asarray(t1h, jnp.int8), jnp.asarray(p1h), jnp.asarray(s1h),
        mm=mm, term=term, interpret=True))
    o_idx = np.arange(pallas.shape[1])[None, :]
    pallas = np.where((o_idx + plen) <= lens[:, None], pallas, 0)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    tl = torch.from_numpy(lens)
    got = tms.hit_window_bitmap(torch.from_numpy(masks), tl, planes, sfx,
                                plen=plen, mm=mm, term=term)
    got_1h = tms.hit_window_bitmap(torch.from_numpy(t1h), tl, planes, sfx,
                                   plen=plen, mm=mm, term=term)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), conv)
    assert np.array_equal(got.numpy(), pallas)
    assert torch.equal(got, got_1h)
    # on pure masks the kernel's plain version is the plain hit codes, any
    # over P
    pure = tms.pure_masks(torch.from_numpy(masks))
    assert pure.dtype == torch.uint8
    assert np.array_equal(pure.numpy(), tms.encode_target_codes(seqs)[0])
    codes = tms.hit_codes(torch.from_numpy(masks), planes, sfx, plen=plen,
                          mm=mm, term=term)
    bm = tms.hit_window_bitmap_kernel(pure, planes, sfx, plen=plen, mm=mm,
                                      term=term)
    assert torch.equal(bm, (codes > 0).any(dim=2).to(torch.int8))


@pytest.fixture(scope="module")
def multi_base_inputs():
    """One-hots with 0-4 bases a position against strongly degenerate
    patterns: counts and suffix counts can exceed plen and term."""
    rng = np.random.default_rng(23)
    plen = 13
    seqs = _rand_seqs(rng, 9, 10, 150, letters="ACGTACGTacgtNRYSWKMBDHV-")
    pats = _planted(rng, seqs, 19, plen, degenerate=0.8)
    pats[-1] = "N" * plen
    return _raw_onehot(seqs) + (jms.encode_primers(pats), plen)


@pytest.mark.parametrize("mm", range(5))
@pytest.mark.parametrize("term", [0, 1, 4, 14])
def test_hit_window_bitmap_multi_base_onehot_equals_pallas(multi_base_inputs,
                                                           mm, term):
    """A one-hot with several bases at a position is taken as it is: each
    shared base counts, as in the Pallas kernel, and the bitmap is not that
    of the purified targets."""
    t1h, lens, p1h, plen = multi_base_inputs
    p1h, s1h = _pad8(p1h, _suffix(p1h, term))
    pallas = np.asarray(jms.hit_window_bitmap_pallas(
        jnp.asarray(t1h, jnp.int8), jnp.asarray(p1h), jnp.asarray(s1h),
        mm=mm, term=term, interpret=True))
    o_idx = np.arange(pallas.shape[1])[None, :]
    pallas = np.where((o_idx + plen) <= lens[:, None], pallas, 0)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    got = tms.hit_window_bitmap(torch.from_numpy(t1h), torch.from_numpy(lens),
                                planes, sfx, plen=plen, mm=mm, term=term)
    assert np.array_equal(got.numpy(), pallas)
    masks = tms.onehot_masks(t1h)
    purified = tms.hit_window_bitmap(masks, torch.from_numpy(lens), planes,
                                     sfx, plen=plen, mm=mm, term=term)
    assert not torch.equal(got, purified)


@pytest.mark.parametrize("kind", ["pure", "multi_base"])
@pytest.mark.parametrize("plen,mm", [(33, 1), (33, 33), (63, 2), (63, 63)])
def test_bitmap_plain_long_patterns_equals_pallas(plen, mm, kind):
    """The tile edges of the tensor-core kernel: plen 33 and 63 (K off its
    32-byte k-steps) and mm at plen, on pure one-hots and on one-hots with
    several bases a position (counts above plen): the plain version on the
    base sets equals the Pallas kernel, term 0 and 3."""
    rng = np.random.default_rng(700 + plen + mm)
    seqs = _rand_seqs(rng, 4, plen - 2, plen + 80,
                      letters="ACGTacgtNRYSWKM-")
    seqs[0] += "ACGT" * plen
    if kind == "pure":
        t1h, _ = jms.encode_targets(seqs)
    else:
        t1h, _ = _raw_onehot(seqs)
    pats = _planted(rng, seqs, 9, plen, degenerate=0.6)
    for term in (0, 3):
        p1h = jms.encode_primers(pats)
        p1h, s1h = _pad8(p1h, _suffix(p1h, term))
        pallas = np.asarray(jms.hit_window_bitmap_pallas(
            jnp.asarray(t1h, jnp.int8), jnp.asarray(p1h), jnp.asarray(s1h),
            mm=mm, term=term, interpret=True))
        planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
        got = tms.hit_window_bitmap_reference(tms.onehot_masks(t1h), planes,
                                              sfx, plen=plen, mm=mm,
                                              term=term)
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), pallas), term
        assert got.numpy().any()


# ---------------------------------------------------------------------------
# find_hits_bitmap
# ---------------------------------------------------------------------------

def _scan_fixture():
    """The fixture of tests/test_scan.py: 24 targets, 8 primers, plants."""
    rng = np.random.default_rng(7)
    lut = np.array(list("ACGT"))
    seqs = ["".join(rng.choice(lut, size=rng.integers(80, 200)))
            for _ in range(24)]
    primers = ["".join(rng.choice(lut, size=18)) for _ in range(8)]
    seqs[0] = seqs[0][:10] + primers[0] + seqs[0][28:]
    p1 = list(primers[1]); p1[9] = "A" if p1[9] != "A" else "C"
    seqs[1] = seqs[1][:20] + "".join(p1) + seqs[1][38:]
    p2 = list(primers[2]); p2[17] = "A" if p2[17] != "A" else "C"
    seqs[2] = seqs[2][:30] + "".join(p2) + seqs[2][48:]
    p1h = jms.encode_primers(primers)
    return seqs, p1h, _suffix(p1h, 4), 1, 4


def _fuzz(seed):
    rng = np.random.default_rng(300 + seed)
    plen = int(rng.choice([8, 13, 18, 22]))
    mm = int(rng.integers(0, 5))
    term = int(rng.choice([0, 1, 2, 4, plen + 1]))
    seqs = _rand_seqs(rng, int(rng.integers(2, 30)), 1, 400,
                      letters="ACGTACGTACGTacgtNRY-")
    seqs[0] += "ACGT" * plen
    pats = _planted(rng, seqs, int(rng.integers(1, 40)), plen)
    p1h = jms.encode_primers(pats)
    p1h, s1h = _pad8(p1h, _suffix(p1h, term))
    return seqs, p1h, s1h, mm, term


def _multi_base_case():
    """Targets as one-hots with 0-4 bases a position, where counts can
    exceed plen."""
    rng = np.random.default_rng(400)
    plen, mm, term = 13, 2, 2
    seqs = _rand_seqs(rng, 17, 5, 200, letters="ACGTACGTacgtNRYSWKMBDHV-")
    p1h = jms.encode_primers(_planted(rng, seqs, 23, plen, degenerate=0.8))
    p1h, s1h = _pad8(p1h, _suffix(p1h, term))
    return seqs, p1h, s1h, mm, term


@pytest.mark.parametrize("case", ["scan_fixture", "multi_base"]
                         + ["fuzz%d" % i for i in range(6)])
def test_find_hits_bitmap_equals_jax(case, monkeypatch):
    seqs, p1h, s1h, mm, term = (
        _scan_fixture() if case == "scan_fixture" else
        _multi_base_case() if case == "multi_base" else _fuzz(int(case[4:])))
    t1h, lens = jms.encode_targets(seqs)
    want = jms.find_hits_bitmap(t1h, lens, p1h, s1h, mm=mm, term=term,
                                backend="conv")
    if case == "multi_base":
        pure_hits = want
        t1h, lens = _raw_onehot(seqs)
        # the exact oracle here: JAX's conv bitmap decodes its combined
        # weight wrongly once counts exceed plen, its NumPy scan does not
        rows = jms.find_hits_numpy(t1h, lens, p1h, s1h, mm=mm, term=term)
        want = (rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3].astype(np.int32))
    got = tms.find_hits_bitmap(t1h, lens, p1h, s1h, mm=mm, term=term,
                               device="cpu")
    # the re-match in chunks of 3 flagged windows: the same tuples
    monkeypatch.setattr(tms, "_REMATCH_CHUNK", 3)
    small = tms.find_hits_bitmap(t1h, lens, p1h, s1h, mm=mm, term=term,
                                 device="cpu")
    for w, g, s in zip(want, got, small):
        assert g.dtype == np.asarray(w).dtype
        assert np.array_equal(g, w) and np.array_equal(s, w)
    if case == "multi_base":
        # find_hits takes IUPAC masks, whose ambiguity codes match nothing
        assert len(got[0]) > len(pure_hits[0])
        return
    # the same tuples, in the same order, as the dense find_hits
    masks, _ = tms.encode_target_masks(seqs)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    idx, _, mism = tms.find_hits(torch.from_numpy(masks),
                                 torch.from_numpy(lens), planes, sfx,
                                 plen=p1h.shape[1], mm=mm, term=term,
                                 max_hits=1 << 16)
    dense = tms.decode_hits(idx.numpy(), mism.numpy(),
                            masks.shape[1] - p1h.shape[1] + 1, p1h.shape[0])
    for d, g in zip(dense, got):
        assert np.array_equal(d, g)
    if case == "scan_fixture":
        assert len(got[0]) > 0
