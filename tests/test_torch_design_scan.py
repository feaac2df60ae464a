"""The port's device Stage A (multiprime_tpu_torch/ops/design_scan.py) and
the design engine's device path against the JAX package, on the CPU: the
same NumPy-seeded inputs give equal integers, Viterbi paths and rows."""

import numpy as np
import pytest

from multiprime_tpu.models import mcdpd as jmcdpd
from multiprime_tpu.ops import design_scan as jds
from multiprime_tpu.utils import iupac
from multiprime_tpu_torch.models import mcdpd as tmcdpd
from multiprime_tpu_torch.ops import design_scan as tds

from .test_design_device import _random_msa, _rows

KEYS = ("freq", "nn", "cover_number", "gap_number", "viterbi", "win")


def _masks(chars):
    return iupac.bytes_to_masks(chars).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 3])
def test_patch_windows_equals_jax(seed):
    """The inputs of tests/test_design_device.py::test_patch_windows_
    matches_host: gap runs at both edges and an all-gap row."""
    _, chars = _random_msa(seed=seed)
    positions = np.arange(0, chars.shape[1] - 18, 3).astype(np.int32)
    want = np.asarray(jds.patch_windows(_masks(chars), positions, 18))
    got = tds.patch_windows(_masks(chars), positions, 18, device="cpu")
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,dege_p,step", [(1, 0.1, 5), (0, 0.05, 1),
                                              (3, 0.05, 1)])
def test_design_stats_full_equals_jax(seed, dege_p, step):
    """freq, nn, cover/gap counts, Viterbi paths and patched windows equal
    JAX's (its int32 sums stay below 2**31 on these inputs)."""
    _, chars = _random_msa(seed=seed, dege_p=dege_p)
    positions = np.arange(0, chars.shape[1] - 18, step).astype(np.int32)
    want = jds.design_stats_full(_masks(chars), positions, plen=18,
                                 variation=1)
    got = tds.design_stats_full(_masks(chars), positions, plen=18,
                                variation=1, device="cpu")
    for key in KEYS:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape and np.array_equal(g, w), key
    assert got["freq"].dtype == got["nn"].dtype == tds.torch.int64


def test_design_stats_blocks_equals_jax():
    """Blocks smaller than W, the last one short: the same block stream as
    JAX's padded blocks, padding dropped."""
    _, chars = _random_msa(seed=2, dege_p=0.08)
    positions = np.arange(4, chars.shape[1] - 20)
    want = list(jds.design_stats_blocks(_masks(chars), positions, plen=20,
                                        variation=2, block=32))
    got = list(tds.design_stats_blocks(_masks(chars), positions, plen=20,
                                       variation=2, block=32, device="cpu"))
    assert len(got) == len(want) == 5
    for (wp, ws), (gp, gs) in zip(want, got):
        assert np.array_equal(wp, gp)
        for key in KEYS:
            assert np.array_equal(gs[key], ws[key]), key


def test_viterbi_ties_take_the_first_maximum():
    """Planted ties (equal scores at every step and at the end) resolve to
    the first maximum, as JAX's argmax and np.argmax do."""
    rng = np.random.default_rng(8)
    freq = rng.integers(0, 3, size=(64, 18, 4))
    nn = rng.integers(0, 3, size=(64, 17, 4, 4))
    freq[:8] = 5
    nn[:8] = 0
    nn[8:16, :, 1:, :] = nn[8:16, :, :1, :]
    want = np.asarray(jds.viterbi_batch(freq.astype(np.int32),
                                        nn.astype(np.int32)))
    got = tds.viterbi_batch(freq, nn, device="cpu").numpy()
    assert np.array_equal(got, want)
    assert (got[:8] == 0).all()
    for wi in range(64):
        assert np.array_equal(got[wi], jmcdpd._viterbi(freq[wi].T, nn[wi]))


def _oracle_stats(win, variation):
    """The window_stats formula in NumPy int64."""
    win = win.astype(np.int64)
    pop = np.array([bin(i).count("1") for i in range(16)], np.int64)
    mc = np.maximum(pop, 1)[win]
    alive = (win == 0).sum(axis=2) <= variation
    total = mc.prod(axis=2)
    member = (win[..., None] >> np.arange(4)) & 1
    w_pos = np.where(alive[..., None], total[..., None] // mc, 0)
    w_pair = np.where(alive[..., None],
                      total[..., None] // (mc[..., :-1] * mc[..., 1:]), 0)
    freq = np.einsum("nwj,nwjb->wjb", w_pos, member)
    nn = np.einsum("nwj,nwja,nwjb->wjab", w_pair, member[:, :, :-1],
                   member[:, :, 1:])
    return freq, nn


def test_int64_window_past_2_31_equals_numpy_oracle():
    """Windows whose expansion-weighted sums pass 2**31: 40 rows of
    three-base codes (3**17 copies a member base, 5.2e9 in all) and rows of
    N (4**18 expansions, which wraps to 0 in int32).  The port counts in
    int64 like the host and equals the NumPy oracle; the JAX package,
    without x64, returns int32 sums that differ (ROADMAP.md, section 3)."""
    rng = np.random.default_rng(21)
    three = np.array([7, 11, 13, 14], np.int32)        # V D B H
    masks = three[rng.integers(0, 4, size=(40, 30))]
    masks[30:, 5:25] = 15                                # N rows
    masks[0, :3] = 0
    positions = np.arange(0, 12).astype(np.int32)
    got = tds.design_stats_full(masks, positions, plen=18, variation=1,
                                device="cpu")
    freq, nn = _oracle_stats(got["win"].numpy(), 1)
    assert freq.max() > 2 ** 31 and nn.max() > 2 ** 31
    assert np.array_equal(got["freq"].numpy(), freq)
    assert np.array_equal(got["nn"].numpy(), nn)
    for wi in range(len(positions)):
        assert np.array_equal(got["viterbi"][wi].numpy(),
                              jmcdpd._viterbi(freq[wi].T, nn[wi]))
    jax_freq = np.asarray(jds.design_stats_full(
        masks, positions, plen=18, variation=1)["freq"])
    assert jax_freq.dtype == np.int32
    assert not np.array_equal(jax_freq.astype(np.int64), freq)


def _synthetic_family(seed=7, n=30, length=260):
    """The conserved family of tests/test_design_device.py::test_design_
    device_end_to_end_synthetic."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    base = lut[rng.integers(0, 4, size=length)]
    chars = np.tile(base, (n, 1))
    mut = rng.random(chars.shape) < 0.03
    chars[mut] = lut[rng.integers(0, 4, size=int(mut.sum()))]
    gaps = rng.random(chars.shape) < 0.02
    chars[gaps] = ord("-")
    chars[0, :6] = ord("-")
    chars[1, -5:] = ord("-")
    return [">s%d" % i for i in range(n)], chars


@pytest.mark.parametrize("stage_a", ["device", "auto"])
def test_design_engine_device_equals_jax(stage_a, monkeypatch):
    """DesignEngine.design on the port's device Stage A (torch on the CPU)
    gives the rows of JAX's device and host Stage A, every WindowResult
    field included; "auto" takes the side of the measured crossover (the
    host at this size, whose estimate is under the device's start-up)."""
    monkeypatch.delenv("MPTPU_FORCE_BACKEND", raising=False)
    ids, chars = _synthetic_family()
    params = dict(coverage=0.5, min_product=100, coordinate="2,3,-1",
                  algo="v20")
    host = jmcdpd.DesignEngine(
        jmcdpd.DesignParams(stage_a="host", **params)).design(ids, chars)
    jdev = jmcdpd.DesignEngine(
        jmcdpd.DesignParams(stage_a="device", **params)).design(ids, chars)
    eng = tmcdpd.DesignEngine(
        tmcdpd.DesignParams(stage_a=stage_a, device="cpu", **params))
    got = eng.design(ids, chars)
    assert eng.stage_a_used == ("device" if stage_a == "device" else "host")
    assert len(host) > 0
    assert _rows(got) == _rows(host) == _rows(jdev)


def test_design_engine_device_degenerate_msa_equals_host():
    """A family with IUPAC codes, gap runs and an all-gap row, v16 rules:
    the port's device rows equal JAX's host rows."""
    ids, chars = _synthetic_family(seed=11, n=26, length=300)
    rng = np.random.default_rng(12)
    dege = rng.random(chars.shape) < 0.01
    chars[dege] = np.frombuffer(b"RYMKSWHBVD", np.uint8)[
        rng.integers(0, 10, size=int(dege.sum()))]
    chars[2, 40:55] = ord("-")
    chars[3, :] = ord("-")
    params = dict(coverage=0.5, min_product=100, coordinate="2,3,-1",
                  algo="v16")
    host = jmcdpd.DesignEngine(
        jmcdpd.DesignParams(stage_a="host", **params)).design(ids, chars)
    got = tmcdpd.DesignEngine(tmcdpd.DesignParams(
        stage_a="device", device="cpu", **params)).design(ids, chars)
    assert len(host) > 0
    assert _rows(got) == _rows(host)
