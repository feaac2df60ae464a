"""The PyTorch port's mismatch scan against the JAX package's, on the CPU.

Same NumPy inputs through both: the JAX functions run on the CPU (the Pallas
kernel in interpret mode), the port with CPU tensors, which take the plain
PyTorch version of the CUDA hit-code kernel.  Hit codes, hit indices and
counts are integers and must be equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiprime_tpu.ops import mismatch_scan as jms
from multiprime_tpu_torch.ops import mismatch_scan as tms


def _suffix(p1h, term):
    s1h = p1h.copy()
    if term > 0:
        s1h[:, :-term, :] = 0
    else:
        s1h[:] = 0
    return s1h


def _pad8(p1h, s1h):
    """Zero pattern rows up to a multiple of 8, as validate.scan does."""
    pad = -p1h.shape[0] % 8
    if pad:
        z = np.zeros((pad,) + p1h.shape[1:], p1h.dtype)
        p1h, s1h = np.concatenate([p1h, z]), np.concatenate([s1h, z])
    return p1h, s1h


def _rand_seqs(rng, n, lo, hi, letters="ACGT"):
    lut = np.array(list(letters))
    return ["".join(rng.choice(lut, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def _planted(rng, seqs, n, plen, degenerate=0.3):
    """Patterns cut from the targets with 0-3 substitutions, some with IUPAC
    codes, so that the scans find hits at every mismatch count."""
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
        if rng.random() < degenerate:
            pat[int(rng.integers(0, plen))] = str(rng.choice(list("RYSWKMN")))
        out.append("".join(pat))
    return out


@pytest.fixture(scope="module")
def data():
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
    return seqs, primers


def _port_codes(seqs, p1h, s1h, mm, term, length=None):
    masks, _ = tms.encode_target_masks(seqs, length)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    return tms.hit_codes(torch.from_numpy(masks), planes, sfx,
                         plen=p1h.shape[1], mm=mm, term=term).numpy()


# ---------------------------------------------------------------------------
# (a) encoders and decoders
# ---------------------------------------------------------------------------

def test_encoders_equal_jax():
    rng = np.random.default_rng(1)
    seqs = _rand_seqs(rng, 17, 0, 90, letters="ACGTacgtNRYSWKMBDHV-.X")
    for length in (None, 64, 128):
        for fn in ("encode_targets", "encode_target_masks",
                   "encode_target_codes"):
            a = getattr(jms, fn)(seqs, length)
            b = getattr(tms, fn)(seqs, length)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), fn
    pats = _rand_seqs(rng, 9, 20, 20, letters="ACGTRYSWKMBDHVNacgt-X")
    assert np.array_equal(jms.encode_pattern_masks(pats),
                          tms.encode_pattern_masks(pats))
    assert np.array_equal(jms.encode_primers(pats), tms.encode_primers(pats))
    masks, _ = tms.encode_target_masks(seqs)
    assert np.array_equal(np.asarray(jms.expand_masks(masks)),
                          tms.expand_masks(torch.from_numpy(masks)).numpy())


@pytest.mark.parametrize("args", [(2048, 1007, 2000), (5, 10, 10),
                                  (4096, 4000, 70000), (1, 0, 0)])
def test_safe_batch_size_equals_jax(args):
    assert tms.safe_batch_size(*args) == jms.safe_batch_size(*args)


def test_decoders_and_numpy_scan_equal_jax():
    rng = np.random.default_rng(2)
    n_out, p, max_hits = 37, 6, 16
    idx = np.sort(rng.choice(5 * n_out * p, size=11, replace=False))
    idx = np.concatenate([idx, -np.ones(max_hits - 11, np.int64)])
    mism = rng.integers(0, 4, size=max_hits)
    packed = np.concatenate([[11], idx, mism]).astype(np.int32)
    for x, y in zip(jms.decode_packed(packed, n_out, p, max_hits),
                    tms.decode_packed(packed, n_out, p, max_hits)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    no_mism = packed[:max_hits + 1]
    for x, y in zip(jms.decode_packed(no_mism, n_out, p, max_hits),
                    tms.decode_packed(no_mism, n_out, p, max_hits)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(jms.decode_hits(idx, mism, n_out, p),
                    tms.decode_hits(idx, mism, n_out, p)):
        assert np.array_equal(x, y)
    seqs = _rand_seqs(rng, 12, 30, 120, letters="ACGTN")
    pats = _planted(rng, seqs, 10, 15)
    t1h, lens = tms.encode_targets(seqs)
    p1h = tms.encode_primers(pats)
    s1h = _suffix(p1h, 3)
    assert np.array_equal(
        jms.find_hits_numpy(t1h, lens, p1h, s1h, mm=2, term=3),
        tms.find_hits_numpy(t1h, lens, p1h, s1h, mm=2, term=3))


# ---------------------------------------------------------------------------
# (b) the hit-code kernel's plain version against hit_codes_conv / Pallas
# ---------------------------------------------------------------------------

def test_pack_patterns_bits():
    p1h = tms.encode_primers(["ACGTRN", "TTTTTT"])
    planes, sfx = tms.pack_patterns(p1h, _suffix(p1h, 2), device="cpu")
    assert planes.dtype == torch.int64 and tuple(planes.shape) == (2, 4)
    # plane b, bit k <=> one-hot [p, k, b]
    for p in range(2):
        for b in range(4):
            want = sum(int(p1h[p, k, b]) << k for k in range(6))
            assert int(planes[p, b]) == want
    assert int(sfx[0, 0]) == (1 << 4) | (1 << 5)      # R and N admit A
    assert int(sfx[1, 3]) == (1 << 4) | (1 << 5)
    with pytest.raises(ValueError, match="exceeds"):
        tms.pack_patterns(np.zeros((1, 64, 4), np.uint8),
                          np.zeros((1, 64, 4), np.uint8), device="cpu")
    with pytest.raises(TypeError, match="device"):
        tms.pack_patterns(p1h, p1h)


def test_hit_codes_plain_equals_conv_and_pallas(data):
    seqs, primers = data
    t1h, _ = jms.encode_targets(seqs)
    p1h = jms.encode_primers(primers)
    s1h = _suffix(p1h, 4)
    conv = np.asarray(jms.hit_codes_conv(t1h, p1h, s1h, mm=1, term=4))
    pallas = np.asarray(jms.hit_codes_pallas(t1h, p1h, s1h, mm=1, term=4,
                                             interpret=True))
    got = _port_codes(seqs, p1h, s1h, 1, 4)
    assert got.dtype == np.int8 and got.shape == conv.shape
    assert np.array_equal(got, conv) and np.array_equal(got, pallas)
    assert (got > 0).sum() > 0


@pytest.mark.parametrize("seed", range(6))
def test_hit_codes_fuzz_equals_conv(seed):
    """Seeded fuzz: mm 0-4, term 0-4 and beyond plen, degenerate and
    all-N patterns, zero (padding) pattern rows, ambiguous and lowercase
    target bases, gaps and rows shorter than the pattern."""
    rng = np.random.default_rng(100 + seed)
    plen = int(rng.choice([6, 8, 13, 18, 20, 25]))
    seqs = _rand_seqs(rng, int(rng.integers(1, 14)), 1, 160,
                      letters="ACGTACGTacgtNRY-")
    seqs[0] = seqs[0] + "ACGT" * plen          # at least one full window
    pats = _planted(rng, seqs, int(rng.integers(1, 30)), plen)
    pats[-1] = "N" * plen
    for mm in range(5):
        for term in (0, 1, 2, 3, 4, plen + 1):
            p1h, s1h = _pad8(jms.encode_primers(pats),
                             _suffix(jms.encode_primers(pats), term))
            t1h, _ = jms.encode_targets(seqs)
            want = np.asarray(jms.hit_codes_conv(t1h, p1h, s1h, mm=mm,
                                                 term=term))
            got = _port_codes(seqs, p1h, s1h, mm, term)
            assert np.array_equal(got, want), (plen, mm, term)


@pytest.mark.parametrize("mm,term", [(0, 0), (2, 3), (4, 19)])
def test_hit_codes_fuzz_equals_pallas(mm, term):
    rng = np.random.default_rng(mm * 10 + term)
    plen = 18
    seqs = _rand_seqs(rng, 9, 10, 300, letters="ACGTacgtNRYSW")
    pats = _planted(rng, seqs, 13, plen)
    p1h, s1h = _pad8(jms.encode_primers(pats),
                     _suffix(jms.encode_primers(pats), term))
    t1h, _ = jms.encode_targets(seqs)
    want = np.asarray(jms.hit_codes_pallas(t1h, p1h, s1h, mm=mm, term=term,
                                           interpret=True))
    assert np.array_equal(_port_codes(seqs, p1h, s1h, mm, term), want)


@pytest.mark.parametrize("plen,mm", [(33, 2), (33, 33), (33, 34), (63, 1),
                                     (63, 63)])
def test_hit_codes_long_patterns_and_large_mm(plen, mm):
    """The tile edges of the tensor-core kernel: K = 4 * plen off its
    32-byte k-steps (plen 33 and 63) and mm at or past plen, where every
    pair is a candidate and zero (padding) pattern rows hit when term is 0:
    the plain version equals hit_codes_conv and the Pallas kernel."""
    rng = np.random.default_rng(500 + plen + mm)
    seqs = _rand_seqs(rng, 5, plen - 2, plen + 90, letters="ACGTacgtNRY-")
    seqs[0] += "ACGT" * plen
    pats = _planted(rng, seqs, 11, plen)
    pats[-1] = "N" * plen
    t1h, _ = jms.encode_targets(seqs)
    for term in (0, 3, plen + 1):
        p1h = jms.encode_primers(pats)
        p1h, s1h = _pad8(p1h, _suffix(p1h, term))
        conv = np.asarray(jms.hit_codes_conv(t1h, p1h, s1h, mm=mm,
                                             term=term))
        pallas = np.asarray(jms.hit_codes_pallas(t1h, p1h, s1h, mm=mm,
                                                 term=term, interpret=True))
        got = _port_codes(seqs, p1h, s1h, mm, term)
        assert np.array_equal(got, conv), term
        assert np.array_equal(got, pallas), term
        if mm >= plen and term == 0:
            assert (got[:, :, -1] == plen + 1).any()   # zero rows hit


def test_hit_codes_rows_shorter_than_pattern():
    p1h = tms.encode_primers(["ACGTACGTAC"])
    got = _port_codes(["ACGT", "AC"], p1h, _suffix(p1h, 2), 1, 2)
    assert got.shape == (2, 0, 1)


def test_hit_codes_wrapper_checks_device():
    p1h = tms.encode_primers(["ACGTACGT"])
    planes, sfx = tms.pack_patterns(p1h, _suffix(p1h, 2), device="cpu")
    masks = torch.zeros((2, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tms.hit_codes(masks, planes, sfx, plen=8, mm=1, term=2)


# ---------------------------------------------------------------------------
# (c) find_hits / find_hits_packed / find_hits_batched
# ---------------------------------------------------------------------------

def _find_inputs(seed, n=20, plen=18, term=2):
    rng = np.random.default_rng(seed)
    seqs = _rand_seqs(rng, n, 40, 400, letters="ACGTACGTACGTACGTACNa")
    pats = _planted(rng, seqs, 40, plen)
    p1h, s1h = _pad8(jms.encode_primers(pats),
                     _suffix(jms.encode_primers(pats), term))
    masks, lens = jms.encode_target_masks(seqs)
    return masks, lens, p1h, s1h


@pytest.mark.parametrize("max_hits", [1 << 12, 7])
def test_find_hits_equals_jax(max_hits):
    masks, lens, p1h, s1h = _find_inputs(3)
    want = jms.find_hits(masks, lens, p1h, s1h, mm=3, term=2,
                         max_hits=max_hits)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    got = tms.find_hits(torch.from_numpy(masks), torch.from_numpy(lens),
                        planes, sfx, plen=18, mm=3, term=2, max_hits=max_hits)
    n_hits = int(want[1])
    assert n_hits > 7 and int(got[1]) == n_hits
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).astype(np.int64), g.numpy())
    packed_w = np.asarray(jms.find_hits_packed(
        masks, lens, p1h, s1h, mm=3, term=2, max_hits=max_hits))
    packed_g = tms.find_hits_packed(
        torch.from_numpy(masks), torch.from_numpy(lens), planes, sfx,
        plen=18, mm=3, term=2, max_hits=max_hits)
    assert np.array_equal(packed_w.astype(np.int64), packed_g.numpy())


def _compaction_case(case):
    """(masks, lengths, p1h, s1h, mm, term, max_hits) of one compaction
    case: more hits than max_hits; zero-length padding rows between and
    after real ones; a flat size N * O * P that is no multiple of 64;
    blocks of 64 codes that are all hits."""
    rng = np.random.default_rng(31)
    if case == "full_blocks":
        seqs = ["A" * 200, "A" * 150 + "C" * 50]
        pats = ["A" * 18] * 7 + ["A" * 17 + "C"]
        return (*jms.encode_target_masks(seqs), *_pad8(
            jms.encode_primers(pats), _suffix(jms.encode_primers(pats), 0)),
            1, 0, 1 << 12)
    if case == "overflow":
        seqs = ["A" * 300] * 3 + _rand_seqs(rng, 5, 100, 300)
        pats = ["A" * 18] + ["A" * 9 + "C" + "A" * 8] + _planted(
            rng, seqs[3:], 6, 18)
        return (*jms.encode_target_masks(seqs), *_pad8(
            jms.encode_primers(pats), _suffix(jms.encode_primers(pats), 2)),
            1, 2, 100)
    if case == "padding_rows":
        seqs = _rand_seqs(rng, 9, 30, 260, letters="ACGTACGTN")
        pats = _planted(rng, seqs, 13, 20)
        masks, lens = jms.encode_target_masks(seqs, length=512)
        for row in (2, 6, 7):
            masks[row], lens[row] = 0, 0
        pad = np.zeros((5, 512), np.uint8)
        masks = np.concatenate([masks, pad])
        lens = np.concatenate([lens, np.zeros(5, lens.dtype)])
        return (masks, lens, *_pad8(jms.encode_primers(pats), _suffix(
            jms.encode_primers(pats), 3)), 3, 3, 1 << 12)
    seqs = _rand_seqs(rng, 3, 60, 101)
    pats = _planted(rng, seqs, 5, 18)
    masks, lens = jms.encode_target_masks(seqs, length=101)
    p1h = jms.encode_primers(pats)
    return masks, lens, p1h, _suffix(p1h, 1), 3, 1, 1 << 10


@pytest.mark.parametrize("case", ["overflow", "padding_rows", "odd_size",
                                  "full_blocks"])
def test_find_hits_from_codes_two_level_equals_jax(case, monkeypatch):
    """The two-level compaction gives JAX's find_hits element for element
    (idx, n_hits, mismatches), and its nonzero runs over the block counts
    and the max_hits x 64 candidates only, never over the flat codes."""
    masks, lens, p1h, s1h, mm, term, max_hits = _compaction_case(case)
    plen = p1h.shape[1]
    want = jms.find_hits(masks, lens, p1h, s1h, mm=mm, term=term,
                         max_hits=max_hits)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    codes = tms.hit_codes(torch.from_numpy(masks), planes, sfx, plen=plen,
                          mm=mm, term=term)
    total = codes.numel()
    sizes = []
    nonzero_static = torch.nonzero_static

    def spy(x, **kw):
        sizes.append(x.numel())
        return nonzero_static(x, **kw)
    monkeypatch.setattr(torch, "nonzero_static", spy)
    got = tms.find_hits_from_codes(codes, torch.from_numpy(lens), plen=plen,
                                   max_hits=max_hits)
    for w, g in zip(want, got):
        assert g.dtype == torch.int64
        assert np.array_equal(np.asarray(w).astype(np.int64), g.numpy())
    n_hits = int(got[1])
    assert n_hits > 0
    assert sizes == [-(-total // 64), max_hits * 64]
    if case == "overflow":
        assert n_hits > max_hits and int((got[0] >= 0).sum()) == max_hits
    elif case == "odd_size":
        assert total % 64
    else:
        assert int((got[0] >= 0).sum()) == n_hits < max_hits


def test_find_hits_batched_equals_jax():
    masks, lens, p1h, s1h = _find_inputs(4, n=24, term=1)
    b, bs = 3, 8
    tm = masks.reshape(b, bs, -1)
    lm = lens.reshape(b, bs)
    for want_mism in (False, True):
        want = np.asarray(jms.find_hits_batched(
            jnp.asarray(tm), jnp.asarray(lm), p1h, s1h, mm=2, term=1,
            max_hits=64, want_mism=want_mism))
        planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
        got = tms.find_hits_batched(
            torch.from_numpy(tm), torch.from_numpy(lm), planes, sfx,
            plen=18, mm=2, term=1, max_hits=64, want_mism=want_mism)
        assert np.array_equal(want.astype(np.int64), got.numpy())
    assert want[:, 0].sum() > 0
