"""The port's device DPs (multiprime_tpu_torch/align/device.py) against the
JAX package's and the host DPs, on the CPU: equal op strings, equal
``as_codes`` matrices, equal MSAs and refined rows.  On the CPU the
wrappers gotoh_block and refine_block run their plain versions; their CUDA
kernels are held to those on the card by tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from multiprime_tpu.align import centerstar as jcs
from multiprime_tpu.align import device as jdev
from multiprime_tpu.align import refine as jrefine
from multiprime_tpu.align.device import align_ops_batch_device as jalign
from multiprime_tpu_torch import native as tnative
from multiprime_tpu_torch.align import centerstar as tcs
from multiprime_tpu_torch.align import device as tdev
from multiprime_tpu_torch.align import refine as trefine

from .test_align_device import _rand_members
from .test_torch_gpu import DP_CASES, dp_case, dp_case_rows


def _random_case():
    """The inputs of tests/test_align_device.py::test_device_ops_match_
    numpy_random: a 180-base center, 40 edited members, a one-base member
    and a member longer than the center."""
    rng = np.random.default_rng(11)
    c = rng.integers(0, 4, size=180).astype(np.int8)
    members = _rand_members(rng, c, 40, 50)
    members.append(rng.integers(0, 4, size=1).astype(np.int8))
    members.append(rng.integers(0, 4, size=400).astype(np.int8))
    return c, members


def _gap_heavy_case():
    """The inputs of tests/test_align_device.py::test_device_ops_gap_heavy:
    long leading and internal deletions, a long insertion."""
    rng = np.random.default_rng(3)
    c = rng.integers(0, 4, size=90).astype(np.int8)
    members = [
        c[30:],
        np.concatenate([c[:40], c[60:]]),
        np.concatenate([c[:50], rng.integers(0, 4, 35).astype(np.int8),
                        c[50:]]),
        np.repeat(c, 2)[:150].astype(np.int8),
    ]
    return c, members


def _other_codes_case():
    """A center with code 4 (never matches), an empty member and the
    native test's shapes."""
    rng = np.random.default_rng(17)
    c = rng.integers(0, 5, size=210).astype(np.int8)
    members = _rand_members(rng, c, 30, 60)
    members += [np.empty(0, np.int8),
                rng.integers(0, 4, size=460).astype(np.int8), c[80:]]
    return c, members


CASES = {"random": (_random_case, 24), "gap_heavy": (_gap_heavy_case, 512),
         "other_codes": (_other_codes_case, 7)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_ops_batch_device_equals_jax_and_numpy(case):
    """Member blocks smaller than M (24 and 7 of 43 and 33 members): op
    strings equal JAX's device DP and the NumPy row loop; as_codes
    matrices equal JAX's, width included."""
    make, block = CASES[case]
    c, members = make()
    want = jcs.align_ops_batch(c, members)
    assert jalign(c, members, member_block=block) == want
    got = tdev.align_ops_batch_device(c, members, member_block=block,
                                      device="cpu")
    assert got == want
    jcodes = jalign(c, members, member_block=block, as_codes=True)
    tcodes = tdev.align_ops_batch_device(c, members, member_block=block,
                                         as_codes=True, device="cpu")
    assert tcodes.dtype == jcodes.dtype and tcodes.shape == jcodes.shape
    assert np.array_equal(tcodes, jcodes)


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_ops_batch_device_equals_native(case):
    """The native C++ Gotoh (the port's auto default) gives the same code
    matrix, up to its own pad width."""
    if not tnative.available():
        pytest.skip("native toolchain unavailable")
    c, members = CASES[case][0]()
    nat = tnative.gotoh_ops_batch(c, members)
    got = tdev.align_ops_batch_device(c, members, as_codes=True,
                                      device="cpu")
    s = min(nat.shape[1], got.shape[1])
    assert np.array_equal(got[:, :s], nat[:, :s])
    assert (got[:, s:] == 3).all() and (nat[:, s:] == 3).all()


def _family(seed, n, length, edits):
    rng = np.random.default_rng(seed)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, size=length))
    seqs = []
    for _ in range(n):
        b = list(base)
        for _ in range(int(rng.integers(*edits))):
            k = int(rng.integers(0, max(len(b), 1)))
            r = rng.integers(0, 3)
            if r == 0:
                b[k % len(b)] = "ACGT"[int(rng.integers(0, 4))]
            elif r == 1 and len(b) > 5:
                del b[k % len(b)]
            else:
                b.insert(k % (len(b) + 1), "ACGT"[int(rng.integers(0, 4))])
        seqs.append("".join(b))
    return [str(i) for i in range(n)], seqs


def test_center_star_msa_device_invariance():
    """The inputs of tests/test_align_device.py::test_center_star_backend_
    invariance: the device backend's MSA equals NumPy's, native's and the
    JAX package's device MSA, and LAST_BACKEND names the DP that served."""
    ids, seqs = _family(5, 9, 150, (0, 25))
    _, want = jcs.center_star_msa(ids, seqs, backend="device")
    for backend in ("device", "numpy", "native"):
        _, rows = tcs.center_star_msa(ids, seqs, backend=backend,
                                      device="cpu")
        assert rows == want, backend
        assert tcs.LAST_BACKEND == backend
    tcs.center_star_msa(ids[:1], seqs[:1], device="cpu")
    assert tcs.LAST_BACKEND == "none"


def test_refine_pass_device_equals_jax():
    """The inputs of tests/test_align_device.py::test_refine_device_
    matches_numpy: the port's device pass equals JAX's device pass, the
    NumPy and the native pass, and moves residues."""
    ids, seqs = _family(13, 14, 160, (5, 30))
    _, rows = jcs.center_star_msa(ids, seqs, backend="numpy")
    want = jrefine.refine_pass(rows, backend="device")
    got = trefine.refine_pass(rows, backend="device", device="cpu")
    assert got == want
    assert got == trefine.refine_pass(rows, backend="numpy")
    assert got == trefine.refine_pass(rows, backend="auto")
    assert got != rows


def test_refine_pass_device_blocks_and_ragged_rows():
    """More members than one block (member_block 256 -> 300 members in two
    blocks), rows of very different residue counts."""
    ids, seqs = _family(29, 300, 90, (0, 40))
    seqs[7] = seqs[7][:20]
    _, rows = tcs.center_star_msa(ids, seqs, backend="native", device="cpu")
    want = jrefine.refine_pass(rows, backend="numpy")
    assert trefine.refine_pass(rows, backend="device", device="cpu") == want


@pytest.mark.parametrize("case", DP_CASES)
def test_tie_heavy_dps_equal_jax(case):
    """The plain versions behind gotoh_block and refine_block, through
    align_ops_batch_device and refine_pass_device, against JAX's device
    programs on the tie-heavy cases of the GPU tests: equal op strings and
    as_codes matrices (and equal to the NumPy row loop), equal refined rows
    (and equal to the NumPy and native passes), member blocks included."""
    c, members, block = dp_case(case)
    want = jcs.align_ops_batch(c, members)
    assert jalign(c, members, member_block=block) == want
    got = tdev.align_ops_batch_device(c, members, member_block=block,
                                      device="cpu")
    assert got == want
    jcodes = jalign(c, members, member_block=block, as_codes=True)
    tcodes = tdev.align_ops_batch_device(c, members, member_block=block,
                                         as_codes=True, device="cpu")
    assert tcodes.shape == jcodes.shape and np.array_equal(tcodes, jcodes)
    rows = dp_case_rows(c, members)
    args = trefine.device_pass_inputs(rows)
    want_rows = jdev.refine_pass_device(*args, go=-4.0, ge=-1.0,
                                        member_block=block)
    got_rows = tdev.refine_pass_device(*args, go=-4.0, ge=-1.0,
                                       member_block=block, device="cpu")
    assert got_rows == want_rows
    want_pass = jrefine.refine_pass(rows, backend="device")
    assert trefine.refine_pass(rows, backend="device", device="cpu") \
        == want_pass == trefine.refine_pass(rows, backend="numpy")
    if case == "empty_member":
        assert (args[2] == 0).sum() == 2      # two all-gap rows


def test_dp_wrappers_launch_or_raise_off_the_cpu(monkeypatch):
    """On a meta tensor (any non-CPU device) gotoh_block and refine_block
    reach _cuda.load, and never the plain version: without a card there is
    no fallback."""
    from multiprime_tpu_torch.ops import _cuda

    class Sentinel(Exception):
        pass

    loaded = []

    def load(name):
        loaded.append(name)
        raise Sentinel(name)

    def plain(*a, **kw):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(_cuda, "load", load)
    monkeypatch.setattr(tdev, "gotoh_block_reference", plain)
    monkeypatch.setattr(tdev, "refine_block_reference", plain)
    meta = torch.device("meta")
    # blocks on each side of the warp kernel's limit (lb + 1 = 10, 1281)
    for lb in (9, tdev._GOTOH_WARP_MAX_COLS):
        with pytest.raises(Sentinel):
            tdev.gotoh_block(torch.zeros(7, dtype=torch.int32, device=meta),
                             torch.zeros((3, lb), dtype=torch.int32,
                                         device=meta),
                             torch.zeros(3, dtype=torch.int32, device=meta))
    f = torch.zeros((5, 3), dtype=torch.float32, device=meta)
    with pytest.raises(Sentinel):
        tdev.refine_block(torch.zeros((3, 4), dtype=torch.int64, device=meta),
                          torch.zeros(3, dtype=torch.int64, device=meta),
                          torch.zeros((5, 3, 6), dtype=torch.float32,
                                      device=meta), f, f, f)
    assert loaded == ["gotoh_dp", "gotoh_dp", "refine_dp"]


@pytest.mark.parametrize("lb", [0, 1, 30, 31, 32, 254, 255, 256, 511, 512,
                                767, 1023, 1278, 1279, 1280, 2047, 5000])
def test_gotoh_kernel_plan_by_width(lb):
    """The Gotoh dispatch by the block's width alone: the warp kernel with
    the smallest K of 8, 16, ..., 40 columns a lane such that 32K >= lb + 1
    (and a 32K pitch) up to 1280 columns, the CTA kernel (256 threads,
    pitch lb + 1) past them."""
    if lb + 1 <= 1280:
        k = -(-(lb + 1) // 256) * 8
        assert 32 * k >= lb + 1 and (k == 8 or 32 * (k - 8) < lb + 1)
        assert tdev.gotoh_kernel_plan(lb) == ("gotoh_dp_warp", k, 32 * k)
    else:
        assert tdev.gotoh_kernel_plan(lb) == ("gotoh_dp", 256, lb + 1)


def test_gotoh_kernel_plan_follows_the_limit(monkeypatch):
    """The limit the GPU tests and the smoke check lower to force the CTA
    kernel: at 0 every width takes it, at 256 only blocks of up to 256
    columns keep the warp kernel."""
    monkeypatch.setattr(tdev, "_GOTOH_WARP_MAX_COLS", 0)
    assert tdev.gotoh_kernel_plan(0) == ("gotoh_dp", 256, 1)
    assert tdev.gotoh_kernel_plan(900) == ("gotoh_dp", 256, 901)
    monkeypatch.setattr(tdev, "_GOTOH_WARP_MAX_COLS", 256)
    assert tdev.gotoh_kernel_plan(255) == ("gotoh_dp_warp", 8, 256)
    assert tdev.gotoh_kernel_plan(256) == ("gotoh_dp", 256, 257)
