"""Device selection, backend overrides and the host/device crossover.

Port of multiprime_tpu/utils/link.py.  The JAX package measured its
host<->TPU link at run time and weighed it against TPU rate constants; the
port keeps the four estimators and their formulae, with constants measured
on an NVIDIA H100 by ``chip_smoke.py``'s crossover phase, and no link
probe: the host<->card link is part of the machine, so ``LINK`` is a fixed
set of measured rates.

* ``resolve_device`` turns a caller's ``device`` into a ``torch.device``
  and raises when CUDA is asked for and absent: no silent CPU fallback.
* the ``auto`` policies (validate/scan.py, models/mcdpd.py) compare
  ``est_host_*`` with ``device_startup_s() + est_device_*``; the cheaper
  side wins.
* ``MPTPU_FORCE_BACKEND=host|device`` overrides every auto policy
  (host = native/NumPy paths, device = the torch/CUDA kernels).
"""

from __future__ import annotations

import os

import torch

# Measured rates: each fitted by chip_smoke.py phase 16 ("crossover"); the
# host rates on the 8-core host of the card's machine.
RATES = {
    # native seed-indexed scan (mm <= 3, >= 32 patterns), bases/s
    # (host of NVIDIA H100 80GB HBM3, 700.00 W; phase 16)
    "host_seed_bases_per_s": 3.39e7,
    # native mask walk (few patterns or mm > 3), base x pattern/s
    # (host of NVIDIA H100 80GB HBM3, 700.00 W; phase 16)
    "host_mask_basepatterns_per_s": 5.41e8,
    # pure-NumPy scan (no native library), base x pattern/s
    # (host of NVIDIA H100 80GB HBM3, 700.00 W; phase 16)
    "numpy_basepatterns_per_s": 3.80e7,
    # corpus preparation before a first device scan, bases/s
    # (host of NVIDIA H100 80GB HBM3, 700.00 W; phase 16)
    "host_encode_bases_per_s": 4.90e7,
    # resident device scan: 2 * bases * patterns * plen * 4 per s
    # (NVIDIA H100 80GB HBM3, 700.00 W; phase 16)
    "device_macs_per_s": 2.00e13,
    # design call with host Stage A, cells (N x W x plen)/s
    # (host of NVIDIA H100 80GB HBM3, 700.00 W; phase 16)
    "host_stagea_cells_per_s": 1.44e7,
    # design call with device Stage A, cells/s beside its blocks
    # (NVIDIA H100 80GB HBM3, 700.00 W; phase 16, the Stage-A kernels)
    "device_stagea_cells_per_s": 1.08e7,
    # device Stage A's kernels of one 512-window block, copies included, s
    # (NVIDIA H100 80GB HBM3, 700.00 W; phases 10 and 16, the Stage-A
    # kernels of csrc/design_stage_a.cu)
    "device_stagea_block_s": 0.00156,
    # a CUDA context's start in a fresh process, s
    # (NVIDIA H100 80GB HBM3, 700.00 W; phase 16)
    "cuda_init_s": 0.552,
    # nvcc of the kernel sources (phase 1's parallel build), s
    # (NVIDIA H100 80GB HBM3, 700.00 W; phase 16)
    "kernel_build_s": 11.2,
    # loading one built kernel library, s
    # (NVIDIA H100 80GB HBM3, 700.00 W; phase 16)
    "kernel_load_s": 0.00775,
    # native banded identity (cluster/greedy.py), band cells/s a thread
    # (host of NVIDIA H100 80GB HBM3, 700.00 W; phase 17, genome pairs)
    "host_identity_cells_per_s": 2.22e8,
    # the banded-identity kernel's cells/s over a window of 2,112 genome
    # pairs (NVIDIA H100 80GB HBM3, 700.00 W; phase 17)
    "device_identity_cells_per_s": 3.11e11,
    # one DP row of a pair alone, s: a launch's floor is its longest pair's
    # rows times this (NVIDIA H100 80GB HBM3, 700.00 W; phase 17)
    "device_identity_row_s": 5.20e-7,
}

# host<->card link of the card's machine: pageable host memory to and from
# the card, MB/s, and the round trip of one synchronised tiny copy, ms
# (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 16)
LINK = {"up_mbps": 4760.0, "down_mbps": 10800.0, "rtt_ms": 0.023,
        "dispatch_ms": 0.023, "platform": "cuda", "probed": False}


def resolve_device(device="cuda"):
    """``device`` (str or torch.device) -> torch.device; raises when a
    CUDA device is requested and torch.cuda.is_available() is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the host"
            % str(device))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % str(device))
    return dev


def device_name(dev):
    """Human-readable name of a resolved device."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def forced_backend():
    """MPTPU_FORCE_BACKEND normalised to 'host'/'device'/None."""
    val = os.environ.get("MPTPU_FORCE_BACKEND", "").strip().lower()
    if val in ("host", "native", "numpy", "cpu"):
        return "host"
    if val in ("device", "gpu", "cuda", "conv"):
        return "device"
    return None


_DEVICE_WARM = False


def mark_device_warm():
    """Called by the device paths after their first success in this
    process: later estimates stop charging the start-up costs."""
    global _DEVICE_WARM
    _DEVICE_WARM = True


def device_startup_s(kernels=("find_hits",)):
    """Expected one-time cost of the first device use in this process: a
    CUDA context while none is initialised, and each of ``kernels`` not
    loaded yet (built first when its library is missing or stale).  Zero
    once a device path has completed here (mark_device_warm)."""
    if _DEVICE_WARM:
        return 0.0
    t = 0.0 if torch.cuda.is_initialized() else RATES["cuda_init_s"]
    from ..ops import _cuda
    for name in kernels:
        if name not in _cuda._libs:
            t += RATES["kernel_build_s"] if _cuda._stale(name) \
                else RATES["kernel_load_s"]
    return t


# -- time estimates ----------------------------------------------------------

def est_host_scan_s(total_bases, n_patterns, mm, native_ok):
    """Host wall-clock estimate for a mismatch scan."""
    if native_ok and 0 <= mm <= 3 and n_patterns >= 32:
        return total_bases / RATES["host_seed_bases_per_s"]
    if native_ok:
        return total_bases * n_patterns / RATES["host_mask_basepatterns_per_s"]
    return total_bases * n_patterns / RATES["numpy_basepatterns_per_s"]


def est_device_scan_s(total_bases, n_patterns, plen, n_batches,
                      upload_bytes, link=None, resident=False,
                      max_hits=1 << 17, want_mism=False):
    """Device wall-clock estimate for the batched scan
    (ops.mismatch_scan.find_hits_batched): the corpus encoded and uploaded
    once, one sync, one [n_batches, 1 + max_hits (+ max_hits)] int64 fetch,
    plus the card's work.

    ``resident=True`` drops the encode and upload terms (the corpus is
    already on the card in the scan's corpus_cache)."""
    link = link or LINK
    t = 0.0
    if not resident:
        t += total_bases / RATES["host_encode_bases_per_s"]
        t += upload_bytes / (link["up_mbps"] * 1e6)
    t += link.get("dispatch_ms", link["rtt_ms"]) / 1e3
    fetch_bytes = n_batches * (1 + max_hits * (2 if want_mism else 1)) * 8
    t += fetch_bytes / (link["down_mbps"] * 1e6)
    macs = 2.0 * total_bases * n_patterns * plen * 4
    t += macs / RATES["device_macs_per_s"]
    return t


def est_host_identity_s(cells, threads):
    """Host estimate for the clusterer's banded identities: their band
    cells on ``threads`` native threads."""
    return cells / (RATES["host_identity_cells_per_s"] * max(int(threads), 1))


def est_device_identity_s(cells, rows, launches=1):
    """Device estimate for the same identities in ``launches`` launches:
    each its dispatch and its longest pair's ``rows`` at one row's
    latency, plus the cells at the kernel's rate over a full card."""
    return (launches * (LINK["dispatch_ms"] / 1e3
                        + rows * RATES["device_identity_row_s"])
            + cells / RATES["device_identity_cells_per_s"])


def est_host_stagea_s(n_seqs, n_windows, plen):
    """Host Stage-A estimate for the design engine: the design call with
    host Stage A (window extraction, per-window freq/NN/Viterbi, Stage
    B)."""
    return n_seqs * n_windows * plen / RATES["host_stagea_cells_per_s"]


def est_device_stagea_s(n_seqs, n_windows, plen, block=512, link=None):
    """Device Stage-A estimate: shipping the patched window tensor back to
    the host Stage B (n_seqs * n_windows * plen int8 bytes), one sync and
    one block of the Stage-A kernels per window block, and the rest of
    the design call at its measured per-cell rate."""
    link = link or LINK
    cells = n_seqs * n_windows * plen
    blocks = max(1, -(-n_windows // block))
    dispatch_s = link.get("dispatch_ms", link["rtt_ms"]) / 1e3
    return (cells / (link["down_mbps"] * 1e6)
            + blocks * (dispatch_s + RATES["device_stagea_block_s"])
            + cells / RATES["device_stagea_cells_per_s"])
