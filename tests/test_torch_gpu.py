"""The CUDA hit-code kernel on the card, against its plain PyTorch version.

Marked ``gpu``: these skip where torch.cuda.is_available() is False.  This
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("plen", [8, 18, 20, 32, 63])
def test_kernel_equals_plain(cuda, plen):
    rng = np.random.default_rng(plen)
    for mm in range(5):
        for term in (0, 1, 4, plen + 1):
            masks, _, p1h, s1h = _inputs(rng, 23, plen - 3, 400, 77, plen,
                                         term)
            tm = torch.from_numpy(masks).to(cuda)
            planes, sfx = ms.pack_patterns(p1h, s1h, device=cuda)
            before = ms.HIT_CODES_LAUNCHES
            got = ms.hit_codes(tm, planes, sfx, plen=plen, mm=mm, term=term)
            assert ms.HIT_CODES_LAUNCHES == before + 1
            want = ms.hit_codes_reference(tm, planes, sfx, plen=plen, mm=mm,
                                          term=term)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (plen, mm, term)


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
