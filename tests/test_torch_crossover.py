"""The port's host/device crossover (utils/link.py) on the CPU: each
estimator's formula against the JAX package's, and "auto" resolving to the
host or the device as its constants say, on both sides of each crossover;
MPTPU_FORCE_BACKEND wins over them."""

import pytest

from multiprime_tpu.utils import link as jlink
from multiprime_tpu_torch import native as tnative
from multiprime_tpu_torch.models import mcdpd as tmcdpd
from multiprime_tpu_torch.ops import _cuda
from multiprime_tpu_torch.utils import link as tlink
from multiprime_tpu_torch.validate import scan as tscan


@pytest.fixture
def pinned(monkeypatch):
    """Start-up pinned to 0.5 s, the native library present, no override,
    the device not warm yet."""
    monkeypatch.delenv("MPTPU_FORCE_BACKEND", raising=False)
    monkeypatch.setattr(tlink, "device_startup_s", lambda **kw: 0.5)
    monkeypatch.setattr(tnative, "available", lambda: True)
    monkeypatch.setattr(tlink, "_DEVICE_WARM", False)
    return monkeypatch


@pytest.mark.parametrize("args", [(2e7, 744, 1, True), (2e7, 24, 1, True),
                                  (2e7, 744, 4, True), (3e6, 64, 1, False)])
def test_host_estimators_equal_jax_formulae(args, monkeypatch):
    """With the JAX package's constants the host estimates are JAX's."""
    for key in ("host_seed_bases_per_s", "host_mask_basepatterns_per_s",
                "numpy_basepatterns_per_s", "host_stagea_cells_per_s"):
        monkeypatch.setitem(tlink.RATES, key, jlink.RATES[key])
    assert tlink.est_host_scan_s(*args) == jlink.est_host_scan_s(*args)
    assert tlink.est_host_stagea_s(500, 880, 18) == \
        jlink.est_host_stagea_s(500, 880, 18)


def _scan_workload(n_targets, length, n_patterns, resident=False):
    seqs = ["A" * length] * n_targets
    pats = ["ACGTACGTACGTACGTAC"] * n_patterns
    pad_len = max(-length % 512 + length, 512)
    params = tscan.ScanParams(mm=1, term=1)
    if resident:
        params.corpus_cache = {"resident": True}
    return seqs, pats, 18, pad_len, -(-n_patterns // 8) * 8, params


@pytest.mark.parametrize("side", ["host", "device"])
def test_scan_auto_follows_the_constants(pinned, side):
    """A 64 Mb x 744-pattern scan: the device wins at a scan rate of 1e14,
    the host at 1e9."""
    work = _scan_workload(1000, 65536, 744)
    pinned.setitem(tlink.RATES, "device_macs_per_s",
                   1e9 if side == "host" else 1e14)
    pinned.setitem(tlink.RATES, "host_encode_bases_per_s", 1e9)
    pinned.setitem(tlink.RATES, "host_seed_bases_per_s", 4e7)
    t_host = tlink.est_host_scan_s(65536000, 744, 1, True)
    t_dev = 0.5 + tlink.est_device_scan_s(
        65536000, 744, 18, 63, 63 * 16 * 65536)
    assert (t_dev < t_host) == (side == "device")
    want = "device" if side == "device" else "numpy"
    assert tscan._auto_backend(*work) == want
    assert tscan._resolve_backend("auto", work) == want
    # small scans stay on the host: their estimate is under the start-up
    assert tscan._auto_backend(*_scan_workload(10, 900, 744)) == "numpy"


def test_scan_resident_corpus_moves_the_crossover(pinned):
    """Upload-bound: a slow host encode gives the host the scan that has
    to upload its corpus, and the device the one whose corpus is already
    on the card."""
    pinned.setitem(tlink.RATES, "host_encode_bases_per_s", 1e6)
    pinned.setitem(tlink.RATES, "host_seed_bases_per_s", 2e7)
    pinned.setitem(tlink.RATES, "device_macs_per_s", 1e14)
    assert tscan._auto_backend(*_scan_workload(1000, 65536, 744)) == "numpy"
    assert tscan._auto_backend(*_scan_workload(
        1000, 65536, 744, resident=True)) == "device"


@pytest.mark.parametrize("side", ["host", "device"])
def test_stage_a_auto_follows_the_constants(pinned, side):
    """A 1000-member x 880-window cluster: each side wins when its per-cell
    rate is the faster one; a 100 x 100 cluster is always the host's."""
    fast, slow = 1e8, 1e6
    pinned.setitem(tlink.RATES, "device_stagea_block_s", 0.01)
    pinned.setitem(tlink.RATES, "host_stagea_cells_per_s",
                   fast if side == "host" else slow)
    pinned.setitem(tlink.RATES, "device_stagea_cells_per_s",
                   slow if side == "host" else fast)
    t_host = tlink.est_host_stagea_s(1000, 880, 18)
    t_dev = 0.5 + tlink.est_device_stagea_s(1000, 880, 18)
    assert (t_dev < t_host) == (side == "device")
    assert tmcdpd.resolve_stage_a(1000, 880, 18) == side
    assert tmcdpd.resolve_stage_a(100, 100, 18) == "host"


@pytest.mark.parametrize("forced", ["host", "device"])
def test_force_backend_wins(pinned, forced):
    """MPTPU_FORCE_BACKEND overrides every estimate, both ways."""
    pinned.setenv("MPTPU_FORCE_BACKEND", forced)
    big = _scan_workload(1000, 65536, 744)
    small = _scan_workload(10, 900, 8)
    for work in (big, small):
        assert tscan._auto_backend(*work) == (
            "numpy" if forced == "host" else "device")
    for cells in ((100, 100, 18), (5000, 2000, 18)):
        assert tmcdpd.resolve_stage_a(*cells) == forced


def test_device_startup_charges_the_card(monkeypatch):
    """A cold CUDA context and each kernel library not loaded (built first
    when stale) are charged until a device path marks the process warm."""
    monkeypatch.setattr(tlink, "_DEVICE_WARM", False)
    monkeypatch.setattr(tlink.torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(_cuda, "_libs", {})
    monkeypatch.setattr(_cuda, "_stale", lambda name: True)
    r = tlink.RATES
    assert tlink.device_startup_s() == r["cuda_init_s"] + r["kernel_build_s"]
    assert tlink.device_startup_s(kernels=()) == r["cuda_init_s"]
    monkeypatch.setattr(_cuda, "_stale", lambda name: False)
    assert tlink.device_startup_s() == r["cuda_init_s"] + r["kernel_load_s"]
    monkeypatch.setattr(tlink.torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(_cuda, "_libs", {"find_hits": object()})
    assert tlink.device_startup_s() == 0.0
    monkeypatch.setattr(tlink.torch.cuda, "is_initialized", lambda: False)
    tlink.mark_device_warm()
    assert tlink.device_startup_s() == 0.0
