"""The harness on the CPU: tiny cells defined only in a test's temporary
directory, the rate arithmetic, the result line, and ``correct`` coming out
false under each fault a cell can have, the timed path broken underneath
(the kernels' plain versions stand in for the card)."""

import json

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_rates_over_the_window():
    ctx = harness.Context("c", {}, {}, 1, "cpu", "/nonexistent", False,
                          harness.Names())
    records = [{"job": 0, "ok": True, "work": {"seqs": 4200, "panels": 1}},
               {"job": 1, "ok": False, "work": {"seqs": 4200, "panels": 1}},
               {"job": 2, "ok": True, "work": {"seqs": 4200, "panels": 1}}]
    run = harness.Run(ctx, records, (10.0, 40.0), 5.0, None, 3 * 2 ** 20)
    names = harness.Names()
    # the completed jobs' work over the window's start to the last end
    assert names.module("metrics", "run_seqs_per_s").read(run) == 280.0
    assert names.module("metrics", "spec.panels_per_min").read(run) == 4.0
    # the card's peak, read as memory_peak_bytes is; none on the CPU
    peak = names.module("metrics", "check_device_peak_mib")
    assert peak.read(run) == 3.0
    assert peak.read(harness.Run(ctx, records, (10.0, 40.0), 5.0, None)) \
        is None


def test_a_cell_defined_only_in_a_temporary_directory(tmp_path):
    result, out, err = tiny.run(tmp_path, "tiny.host", seed=2 ** 31 + 5)
    last = out.strip().splitlines()[-1]
    assert json.loads(last) == result
    assert list(result) == KEYS
    assert result["correct"] and result["attempted"] == 1
    assert set(result["metrics"]) == {"run_seqs_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    # the checks: the last lines of standard error, and the last key
    assert err.strip().splitlines()[-1] == \
        "check coverage_rows_differing: 0 (limit 0)"


def test_traced_run_reports_per_layer_metrics(tmp_path):
    result, _, _ = tiny.run(tmp_path, "tiny.device", trace=True,
                            readings=True)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert result["correct"]
    assert set(result["metrics"]) == {"run.align_s", "run.design_s",
                                      "run.pair_s"}
    assert set(result["checks"]) == {"coverage_rows_differing",
                                     "stage_a_windows_differing",
                                     "gotoh_members_differing"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["tiny.device", "tiny.spec"])
def test_control_fails_the_check(tmp_path, cell, capsys):
    """The control (the reference with one mismatch fewer allowed, in the
    program's place) differs from the reference: its readings are above
    the limit 0."""
    result, out, _ = tiny.run(tmp_path, cell, seconds=1.0, readings=True)
    assert result["correct"]
    readings = json.loads(next(line[len("READINGS "):]
                               for line in out.splitlines()
                               if line.startswith("READINGS ")))
    control = {k: v for k, v in readings.items() if "rows" in k}
    assert control and all(v > 0 for v in control.values())


# -- faults ------------------------------------------------------------------

def _find_hits_fault(monkeypatch, how):
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    find_hits = ms.find_hits

    def broken(target_masks, lengths, planes, suffix_planes, **kw):
        if how == "half":       # half of the batch's targets left out
            lengths = lengths.clone()
            lengths[int((lengths > 0).sum()) // 2:] = 0
        idx, n_hits, mism = find_hits(target_masks, lengths, planes,
                                      suffix_planes, **kw)
        if how == "unchanged":  # no hit comes back
            idx = idx.clone().fill_(-1)
            n_hits = n_hits * 0
        elif how == "altered" and int(n_hits) > 0:
            idx = idx.clone()   # the first hit one window further on
            idx[0] += planes.shape[0]
        return idx, n_hits, mism
    monkeypatch.setattr(ms, "find_hits", broken)


@pytest.mark.parametrize("how", ["half", "unchanged", "altered"])
@pytest.mark.parametrize("cell", ["tiny.host", "tiny.spec"])
def test_find_hits_faults_fail_the_check(tmp_path, monkeypatch, cell, how):
    _find_hits_fault(monkeypatch, how)
    result, _, _ = tiny.run(tmp_path, cell, seconds=0.5)
    assert not result["correct"]
    assert result["failed"] >= 1


def test_stage_a_answer_altered_fails_the_check(tmp_path, monkeypatch):
    from multiprime_tpu_torch.ops import design_scan
    # underneath the capture, which records what the program produced
    blocks = getattr(design_scan.design_stats_blocks, "__wrapped__",
                     design_scan.design_stats_blocks)

    def broken(*args, **kwargs):
        for k, (pos, stats) in enumerate(blocks(*args, **kwargs)):
            if k == 0:
                stats = dict(stats, freq=stats["freq"].copy())
                stats["freq"][0, 0, 0] += 1
            yield pos, stats
    monkeypatch.setattr(design_scan, "design_stats_blocks", broken)
    result, _, _ = tiny.run(tmp_path, "tiny.device")
    assert not result["correct"]
    assert result["checks"]["stage_a_windows_differing"]["value"] >= 1


def test_gotoh_answer_altered_fails_the_check(tmp_path, monkeypatch):
    from multiprime_tpu_torch.align import device as adev
    align = getattr(adev.align_ops_batch_device, "__wrapped__",
                    adev.align_ops_batch_device)

    def broken(*args, **kwargs):
        ops = align(*args, **kwargs)
        # member 0's first op, a pair of bases, as a gap in the member and
        # a gap in the center: the same bases consumed, one op more
        n = int((ops[0] != 3).sum())
        ops = np.concatenate([ops, np.full((len(ops), 1), 3, np.uint8)],
                             axis=1)
        ops[0, :n + 1] = np.concatenate([[1, 2], ops[0, 1:n]])
        return ops
    monkeypatch.setattr(adev, "align_ops_batch_device", broken)
    result, _, _ = tiny.run(tmp_path, "tiny.device")
    assert not result["correct"]
    assert result["checks"]["gotoh_members_differing"]["value"] >= 1
