"""The readers of the program's spans on a synthetic run: only the spans
of requests whose root lies inside a completed job count; nothing where
the program records no span."""

import sys

import pytest

from perfbench import harness

S = 1_000_000_000          # ns a second

RUN_METRICS = {"run.fanout_s": 7.0, "run.worker_start_s": 2.0,
               "run.fanout_busy_pct": 100.0 * 8.0 / 14.0,
               "run.stage_a_s": 1.0, "run.stage_b_s": 2.0,
               "run.kernel_s": 0.3}
SPEC_METRICS = {"spec.parse_s": 2.0, "spec.encode_s": 1.5,
                "spec.upload_s": 0.5, "spec.hitlist_s": 0.7,
                "spec.unspanned_pct": 7.0}


def _span(request, sid, parent, name, a, b, counts=None, kernels=None):
    return {"name": name, "id": sid, "parent": parent, "request": request,
            "pid": 1, "start": int(a * S), "end": int(b * S),
            "counts": counts or {}, "kernels": kernels or {}}


def _run_job(request, t0):
    """A `run` request's spans from t0 on: a fan-out of two workers."""
    r = request
    return [
        _span(r, r + "0", None, "run", t0 + 0.5, t0 + 9.5,
              kernels={"find_hits": [1, 0.05]}),
        _span(r, r + "1", r + "0", "fanout", t0 + 1, t0 + 8,
              counts={"workers": 2, "clusters": 2}),
        _span(r, r + "2", r + "1", "worker.start", t0 + 1, t0 + 2),
        _span(r, r + "3", r + "1", "worker.start", t0 + 1, t0 + 3),
        _span(r, r + "4", r + "1", "cluster", t0 + 2, t0 + 7,
              kernels={"gotoh_dp_warp": [3, 0.25]}),
        _span(r, r + "5", r + "1", "cluster", t0 + 3, t0 + 6),
        _span(r, r + "6", r + "4", "design.stage_a", t0 + 4, t0 + 5),
        _span(r, r + "7", r + "4", "design.stage_b", t0 + 5, t0 + 7)]


def _spec_job(request, t0):
    """A `specificity` request's spans from t0 on: 0.7 s of its 10 s job
    under no child of its root."""
    r = request
    kids = [("specificity.expand", 0.2, 0.5),
            ("specificity.parse", 0.5, 2.5), ("scan", 2.5, 6),
            ("scan", 6, 8), ("specificity.join", 8, 9),
            ("specificity.write", 9, 9.5)]
    spans = [_span(r, r + "0", None, "specificity", t0 + 0.2, t0 + 9.5)]
    spans += [_span(r, r + str(k + 1), r + "0", name, t0 + a, t0 + b)
              for k, (name, a, b) in enumerate(kids)]
    spans += [_span(r, r + "s%d" % k, r + "3", name, t0 + a, t0 + b)
              for k, (name, a, b) in enumerate([
                  ("scan.segment", 2.5, 3), ("scan.encode", 3, 4),
                  ("scan.upload", 4, 4.5), ("scan.hitlist", 5, 5.5)])]
    spans.append(_span(r, r + "s9", r + "4", "scan.hitlist", t0 + 7,
                       t0 + 7.2))
    return spans


def _run(records):
    ctx = harness.Context("c", {}, {}, 1, "cpu", "/nonexistent", True,
                          harness.Names())
    return harness.Run(ctx, records, (10.0, 40.0), 5.0, None)


# job 0 completed, job 1 failed, then a request after the last job
RECORDS = [{"job": 0, "ok": True, "start": 10.0, "end": 20.0},
           {"job": 1, "ok": False, "start": 20.0, "end": 30.0}]


@pytest.mark.parametrize("kind", ["run", "spec"])
def test_readers_keep_the_completed_jobs_spans(monkeypatch, kind):
    from multiprime_tpu_torch.utils import trace
    job = _run_job if kind == "run" else _spec_job
    want = RUN_METRICS if kind == "run" else SPEC_METRICS
    # the failed job's request and one outside every job are dropped;
    # doubled, their spans would change every reading
    spans = job("a", 10.0) + job("b", 20.0) + job("c", 31.0)
    monkeypatch.setattr(trace, "spans", lambda: spans)
    names = harness.Names()
    for metric, value in want.items():
        got = names.module("metrics", metric).read(_run(RECORDS))
        assert got == pytest.approx(value), metric
    # a request of the other kind in the same job counts for neither
    other = _spec_job if kind == "run" else _run_job
    monkeypatch.setattr(trace, "spans", lambda: other("d", 10.0))
    for metric in want:
        assert names.module("metrics", metric).read(_run(RECORDS)) is None


@pytest.mark.parametrize("metric", sorted(RUN_METRICS) + sorted(SPEC_METRICS))
def test_readers_find_nothing_without_the_recorder(monkeypatch, metric):
    """A program without utils/trace.py (the parent of the change that
    adds it), or a run that recorded nothing: the reader returns None."""
    from multiprime_tpu_torch.utils import trace
    read = harness.Names().module("metrics", metric).read
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert read(_run(RECORDS)) is None
    monkeypatch.setitem(sys.modules, "multiprime_tpu_torch.utils.trace",
                        None)
    assert read(_run(RECORDS)) is None


def test_traced_tiny_cells_report_the_span_metrics(tmp_path):
    """Traced runs of the tiny cells through the harness report the
    readers of the program's spans beside the benchmark's own: a pool of
    one in the `run` cell (no worker.start) and no kernel on the CPU; the
    panel cell's scan held to the device path (the plain kernels)."""
    from perfbench.tests import tiny
    result, _, _ = tiny.run(tmp_path / "run", "tiny.device", trace=True)
    assert result["correct"]
    assert set(result["metrics"]) == {
        "run.align_s", "run.design_s", "run.pair_s", "run.fanout_s",
        "run.fanout_busy_pct", "run.stage_a_s", "run.stage_b_s"}
    result, _, _ = tiny.run(tmp_path / "spec", "tiny.spec", trace=True)
    assert result["correct"]
    assert {"spec.parse_s", "spec.encode_s", "spec.upload_s",
            "spec.hitlist_s", "spec.unspanned_pct", "spec.scan_s",
            "spec.join_s"} <= set(result["metrics"])
    assert 0.0 <= result["metrics"]["spec.unspanned_pct"]["value"] < 100.0
