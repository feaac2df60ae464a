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
from .test_torch_gpu import (STAGE_A_EDGE_CASES, stage_a_edge_masks,
                             stage_a_wrap_masks)

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
    got = tds.patch_windows_reference(_masks(chars), positions, 18)
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


# ---------------------------------------------------------------------------
# a NumPy model of csrc/design_stage_a.cu's algorithm: the rows kernel's
# before [N, L + 1] and packed residues, the windows kernel's lead and
# trail from the window itself, its floor divisions of a wrapping int64
# product and its sums in one window's shared layout, the Viterbi kernel's
# back pointers packed into the path slots
# ---------------------------------------------------------------------------

_MC_U64 = np.maximum(np.array([bin(i).count("1") for i in range(16)]),
                     1).astype(np.uint64)


def _model_rows(masks):
    n, length = masks.shape
    before = np.zeros((n, length + 1), np.int64)
    before[:, 1:] = np.cumsum(masks != 0, axis=1)
    packed = np.zeros((n, length), np.uint8)
    for r in range(n):
        res = masks[r][masks[r] != 0]
        packed[r, :len(res)] = res
    return before, packed


def _model_window(masks, before, packed, pos, plen, variation):
    """One window, as one CTA of the windows kernel computes it: -> (win
    [N, plen], sums [4 plen + 16 (plen - 1)] uint64 in the kernel's shared
    layout, alive rows, gap rows)."""
    n, length = masks.shape
    seg = masks[:, pos:pos + plen].astype(np.int64)
    nzw = seg != 0
    some = nzw.any(axis=1)
    lead = np.where(some, nzw.argmax(axis=1), plen)
    trail = np.where(some, nzw[:, ::-1].argmax(axis=1), plen)
    c_start, c_end = before[:, pos], before[:, pos + plen]
    total = before[:, length]
    lead_end = np.where(some & (lead > 0) & (c_start >= lead), lead, 0)
    trail_start = np.where(some & (trail > 0) & (total - c_end >= trail),
                           plen - trail, plen)
    j = np.arange(plen)
    take_lead = j[None, :] < lead_end[:, None]
    take_trail = j[None, :] >= trail_start[:, None]
    idx = np.where(take_lead, (c_start - lead)[:, None] + j,
                   np.where(take_trail, (c_end - trail_start)[:, None] + j,
                            -1))
    # every read of the packed residues lies in the row's residues
    used = take_lead | take_trail
    assert (idx[used] >= 0).all() and (idx[used] < np.broadcast_to(
        total[:, None], idx.shape)[used]).all()
    win = np.where(used, np.take_along_axis(packed, np.maximum(idx, 0),
                                            axis=1), seg)
    alive = (seg == 0).sum(axis=1) - lead_end - (plen - trail_start) \
        <= variation
    mc = _MC_U64[win]
    total_exp = np.multiply.reduce(mc, axis=1).view(np.int64)  # wraps
    w_pos = total_exp[:, None] // mc.astype(np.int64)            # floor
    w_pair = total_exp[:, None] // (mc[:, :-1] * mc[:, 1:]).astype(np.int64)
    sums = np.zeros(4 * plen + 16 * (plen - 1), np.uint64)
    bits = (win[:, :, None] >> np.arange(4)) & 1                # [N, plen, 4]
    for r in np.flatnonzero(alive):
        jj, bb = np.nonzero(bits[r])
        np.add.at(sums, 4 * jj + bb, w_pos[r, jj].view(np.uint64))
        pair = bits[r, :-1, :, None] & bits[r, 1:, None, :]     # [plen-1,4,4]
        jj, aa, bb = np.nonzero(pair)
        np.add.at(sums, 4 * plen + 16 * jj + 4 * aa + bb,
                  w_pair[r, jj].view(np.uint64))
    return win, sums, int(alive.sum()), int((~alive).sum())


def _model_viterbi(freq, nn):
    """One window's path, as a thread of the Viterbi kernel walks it."""
    plen = freq.shape[0]
    out = np.zeros(plen, np.int64)
    scores = freq[0].copy()
    for t in range(plen - 1):
        m = scores[:, None] + nn[t] + freq[t + 1][None, :]      # wraps
        back = m.argmax(axis=0)                                  # first max
        out[t] = sum(int(b) << (2 * to) for to, b in enumerate(back))
        scores = m.max(axis=0)
    state = int(scores.argmax())
    out[plen - 1] = state
    for t in range(plen - 2, -1, -1):
        state = (int(out[t]) >> (2 * state)) & 3
        out[t] = state
    return out.astype(np.int32)


def _kernel_model(masks, positions, plen, variation):
    masks = np.asarray(masks, np.int64)
    before, packed = _model_rows(masks)
    n, w = masks.shape[0], len(positions)
    out = {"freq": np.zeros((w, plen, 4), np.int64),
           "nn": np.zeros((w, plen - 1, 4, 4), np.int64),
           "cover_number": np.zeros(w, np.int64),
           "gap_number": np.zeros(w, np.int64),
           "viterbi": np.zeros((w, plen), np.int32),
           "win": np.zeros((n, w, plen), np.int8)}
    for k, pos in enumerate(positions):
        win, sums, alive, dead = _model_window(masks, before, packed,
                                               int(pos), plen, variation)
        sums = sums.view(np.int64)
        out["freq"][k] = sums[:4 * plen].reshape(plen, 4)
        out["nn"][k] = sums[4 * plen:].reshape(plen - 1, 4, 4)
        out["cover_number"][k], out["gap_number"][k] = alive, dead
        out["win"][:, k] = win
        out["viterbi"][k] = _model_viterbi(out["freq"][k], out["nn"][k])
    return out


@pytest.mark.parametrize("seed,n,length,plen,variation",
                         STAGE_A_EDGE_CASES)
def test_kernel_model_equals_jax(seed, n, length, plen, variation):
    """The NumPy model of the three kernels equals JAX's design_stats_full
    and the port's plain versions exactly, on every window of seeded MSAs
    with long gap runs, all-gap rows, N-heavy windows, N = 1, plen 8-40
    and variation 0-3 (the sums stay below 2**31, where JAX's int32 counts
    are exact)."""
    masks = stage_a_edge_masks(seed, n, length, plen)
    positions = np.arange(0, length - plen + 1)
    model = _kernel_model(masks, positions, plen, variation)
    assert model["freq"].max() < 2 ** 31 and model["nn"].max() < 2 ** 31
    assert model["cover_number"].min() < n or n == 1
    want = jds.design_stats_full(masks, positions.astype(np.int32),
                                 plen=plen, variation=variation)
    plain = tds.design_stats_full_reference(masks, positions, plen=plen,
                                            variation=variation)
    for key in KEYS:
        assert np.array_equal(model[key], np.asarray(want[key])), key
        assert model[key].dtype == plain[key].numpy().dtype, key
        assert np.array_equal(model[key], plain[key].numpy()), key


def test_kernel_model_rows_equal_plain():
    """The rows kernel's plain version equals the model's before and
    packed residues (an all-gap row, a row without gaps, N = 1 rows)."""
    for seed, n, length, plen, _ in STAGE_A_EDGE_CASES:
        masks = stage_a_edge_masks(seed, n, length, plen)
        masks[-1] = np.where(masks[-1] == 0, 1, masks[-1])
        before, packed = tds.stage_a_rows_reference(
            tds.torch.from_numpy(masks))
        want_before, want_packed = _model_rows(masks)
        assert before.dtype == tds.torch.int32
        assert np.array_equal(before.numpy(), want_before)
        assert np.array_equal(packed.numpy(), want_packed)


@pytest.mark.parametrize("plen", [18, 31, 32, 40])
def test_kernel_model_wraps_as_torch_past_2_63(plen):
    """Rows of three-base codes and of N: at plen 18 the sums pass 2**31,
    at 32 an all-N window's 4**32 expansions wrap to 0, at 40 a
    three-base window's 3**40 wraps to a negative int64, whose floor
    division steps below C's truncation.  The model (floor division,
    unsigned sums) equals the port's plain version, which equals the NumPy
    oracle's formula."""
    masks, positions = stage_a_wrap_masks(plen)
    model = _kernel_model(masks, positions, plen, 1)
    got = tds.design_stats_full(masks, positions, plen=plen, variation=1,
                                device="cpu")
    for key in KEYS:
        assert np.array_equal(model[key], got[key].numpy()), key
    freq, nn = _oracle_stats(model["win"], 1)
    assert np.array_equal(model["freq"], freq)
    assert np.array_equal(model["nn"], nn)
    total = np.multiply.reduce(_MC_U64[masks[1, :plen]]).view(np.int64)
    if plen == 40:
        assert total < 0 and total % 3 != 0
        assert total // 3 != int(total / 3)            # floor, not truncation


def test_stage_a_wrappers_launch_or_raise_off_the_cpu(monkeypatch):
    """On a meta tensor (any non-CPU device) stage_a_rows,
    window_stats_from_masks, viterbi_batch, design_stats_full,
    design_stats_blocks and the mesh's Stage A reach
    _cuda.load("design_stage_a"), and never a plain version: without a
    card there is no fallback."""
    from multiprime_tpu_torch.ops import _cuda
    from multiprime_tpu_torch.parallel import mesh as tmesh
    torch = tds.torch

    class Sentinel(Exception):
        pass

    loaded = []

    def load(name):
        loaded.append(name)
        raise Sentinel(name)

    def plain(*a, **kw):
        raise AssertionError("a plain version ran off the CPU")

    monkeypatch.setattr(_cuda, "load", load)
    for name in ("patch_windows_reference", "window_stats_reference",
                 "viterbi_batch_reference", "design_stats_full_reference",
                 "stage_a_rows_reference"):
        monkeypatch.setattr(tds, name, plain)
    # the entry points that take a device name resolve it first: let
    # "meta" through
    monkeypatch.setattr(tds.linkmod, "resolve_device", torch.device)
    meta = torch.device("meta")
    masks = torch.zeros((5, 40), dtype=torch.int32, device=meta)
    positions = np.arange(0, 10)
    placed = np.empty((1, 1), dtype=object)
    placed[0, 0] = (masks, None)                 # a shard and no rows yet
    calls = [
        lambda: tds.stage_a_rows(masks),
        lambda: tds.window_stats_from_masks(masks, positions, with_win=True),
        lambda: tds.viterbi_batch(
            torch.zeros((4, 18, 4), dtype=torch.int64, device=meta),
            torch.zeros((4, 17, 4, 4), dtype=torch.int64, device=meta),
            device=meta),
        lambda: tds.design_stats_full(masks, positions, device=meta),
        lambda: tds.design_stats(masks, positions, device=meta),
        lambda: list(tds.design_stats_blocks(np.ones((5, 40), np.int32),
                                             positions, device=meta)),
        lambda: tmesh.design_stats_sharded(
            tmesh.Mesh([["meta", "meta"]]), np.ones((4, 40), np.int32),
            positions),
        lambda: list(tmesh.design_stats_blocks_sharded(
            tmesh.Mesh([["meta"], ["meta"]]), np.ones((5, 40), np.int32),
            positions, block=4)),
        lambda: tmesh._stage_a(tmesh.Mesh([["meta"]]), placed,
                               [positions], 18, 1, with_win=True)]
    for call in calls:
        with pytest.raises(Sentinel):
            call()
    assert loaded == ["design_stage_a"] * len(calls)
