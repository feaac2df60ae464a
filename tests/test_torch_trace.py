"""The port's span recorder (multiprime_tpu_torch/utils/trace.py) on the
CPU: off without a torch.profiler session, the span tree of a traced
`run` (its pool's workers included) and `specificity`, the results
unchanged by it, and the kernel launchers' event timing."""

import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multiprime_tpu_torch.cli import main as tcli
from multiprime_tpu_torch.ops import _cuda
from multiprime_tpu_torch.utils import iupac, trace
from multiprime_tpu_torch.validate import scan as tscan

from .test_torch_pipeline import _three_families, _tree

LUT = np.array(list("ACGT"))
STAGES = ("seq_format", "build_dict", "rmdup", "clustering",
          "extract_cluster", "fanout", "aggregate", "solve", "coverage")


@pytest.fixture(autouse=True)
def empty_recorder():
    trace.take()
    yield
    trace.take()
    assert not trace.ON


@pytest.fixture
def record_functions(monkeypatch):
    """The names of the record_function ranges entered."""
    entered = []

    def counted(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return entered


def _run_argv(fa, res, *extra):
    return ["run", "-i", str(fa), "-r", str(res), "--device", "cpu",
            "--stage-a", "device", "--coverage", "0.5", "--nproc", "2",
            *extra]


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Two primer pairs, and a background of three 2-3 kb sequences with
    their amplicons planted."""
    d = tmp_path_factory.mktemp("panel")
    rng = np.random.default_rng(5)
    prims = ["".join(rng.choice(LUT, size=18)) for _ in range(4)]
    genomes = [list("".join(rng.choice(LUT, size=int(rng.integers(2000,
                                                                   3001)))))
               for _ in range(3)]
    for g, s in enumerate(genomes):
        pair = g % 2
        s[100:118] = prims[2 * pair]
        s[700:718] = iupac.rc(prims[2 * pair + 1])
    (d / "bg.fa").write_text("".join(">bg%d\n%s\n" % (i, "".join(s))
                                     for i, s in enumerate(genomes)))
    (d / "primers.fa").write_text("".join(
        ">P%d_%s\n%s\n" % (i // 2, "FR"[i % 2], p)
        for i, p in enumerate(prims)))
    return d


def _spec_argv(panel, out):
    return ["specificity", "-i", str(panel / "primers.fa"), "-r",
            str(panel / "bg.fa"), "-l", "18", "-t", "4", "-m", "1", "-s",
            "100,1500", "--exhaustive-join", "-o", str(out), "--device",
            "cpu"]


@pytest.mark.parametrize("command", ["run", "specificity"])
def test_off_without_a_profiler(tmp_path, panel, record_functions,
                                command):
    """No profiler session: the recorder stays empty and enters no
    record_function range."""
    if command == "run":
        fa = tmp_path / "three.fa"
        _three_families(fa)
        argv = _run_argv(fa, tmp_path / "res")
    else:
        argv = _spec_argv(panel, tmp_path / "s.out")
    assert tcli.main(argv) == 0
    assert trace.spans() == [] and record_functions == []


def _inside(spans):
    """Every span lies inside its parent's interval."""
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start"] <= s["end"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start"] <= s["start"] and s["end"] <= p["end"], \
                (s["name"], p["name"])


def test_traced_run_spans_and_unchanged_tree(tmp_path):
    """`run --profile DIR --nproc 2`: a root span with one request id,
    every parent stage and the fan-out, one worker.start a worker, each
    cluster's align, design.stage_b and pair from the workers, all inside
    their parents; DIR/spans.json holds them a pid a process; the tree is
    the one the run without a profiler writes."""
    fa = tmp_path / "three.fa"
    _three_families(fa)
    res = tmp_path / "res"
    prof = tmp_path / "prof"
    assert tcli.main(_run_argv(fa, res, "--profile", str(prof))) == 0
    spans = trace.spans()
    os.rename(res, tmp_path / "res_traced")
    assert tcli.main(_run_argv(fa, res)) == 0
    want, got = _tree(res), _tree(tmp_path / "res_traced")
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel

    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["run"]
    assert {s["request"] for s in spans} == {roots[0]["request"]}
    names = [s["name"] for s in spans]
    for stage in STAGES:
        assert stage in names, stage
    by_id = {s["id"]: s for s in spans}
    fanout = next(s for s in spans if s["name"] == "fanout")
    warm = fanout["counts"].pop("pool.server_warm")
    assert warm in (0, 1)
    assert fanout["counts"] == {"clusters": 3, "workers": 2,
                                "pool.forkserver": 1}
    starts = [s for s in spans if s["name"] == "worker.start"]
    assert len(starts) == 2
    assert len({s["pid"] for s in starts}) == 2
    assert all(s["parent"] == fanout["id"] for s in starts)
    clusters = [s for s in spans if s["name"] == "cluster"]
    assert len(clusters) == 3
    assert {s["pid"] for s in clusters} <= {s["pid"] for s in starts}
    for c in clusters:
        assert c["parent"] == fanout["id"]
        kids = {s["name"] for s in spans if s["parent"] == c["id"]}
        assert {"align", "design", "pair"} <= kids
        design = next(s for s in spans
                      if s["parent"] == c["id"] and s["name"] == "design")
        stage_b = [s for s in spans if s["parent"] == design["id"]
                   and s["name"] == "design.stage_b"]
        assert stage_b and sum(s["counts"]["windows"] for s in stage_b) > 0
        assert c["counts"]["members"] == 8
    _inside(spans)

    with open(prof / "spans.json") as f:
        chrome = json.load(f)["traceEvents"]
    complete = [e for e in chrome if e["ph"] == "X"]
    assert len(complete) == len(spans)
    assert {e["pid"] for e in complete} == {s["pid"] for s in spans}
    assert len({e["pid"] for e in complete}) == 3
    assert all(e["name"] in names for e in complete)
    assert by_id[fanout["parent"]]["name"] == "run"


def test_traced_specificity_on_the_host(tmp_path, panel, monkeypatch):
    """`specificity` on the host backend under a CPU profiler session, its
    background scanned in segments: expand, parse, two scans with their
    segment, encode and hit-list spans, the join and the write; the rows
    those of the run without a profiler."""
    import functools
    monkeypatch.setattr(tscan, "ScanParams", functools.partial(
        tscan.ScanParams, seg_len=600))
    monkeypatch.setenv("MPTPU_FORCE_BACKEND", "host")
    out = tmp_path / "traced.out"
    with profile(activities=[ProfilerActivity.CPU]):
        assert tcli.main(_spec_argv(panel, out)) == 0
    spans = trace.spans()
    assert tcli.main(_spec_argv(panel, tmp_path / "plain.out")) == 0
    assert out.read_bytes() == (tmp_path / "plain.out").read_bytes()
    root = next(s for s in spans if s["parent"] is None)
    assert root["name"] == "specificity"
    kids = [s["name"] for s in spans if s["parent"] == root["id"]]
    assert kids == ["specificity.expand", "specificity.parse", "scan",
                    "scan", "specificity.join", "specificity.write"]
    names = {s["name"] for s in spans}
    assert {"scan.segment", "scan.encode", "scan.host",
            "scan.hitlist"} <= names
    scans = [s for s in spans if s["name"] == "scan"]
    assert all(s["counts"]["segments"] > 3 for s in scans)
    assert sum(s["counts"]["hits"] for s in scans) >= 6
    _inside(spans)


class _StubEvent:
    recorded = 0

    def record(self, stream):
        _StubEvent.recorded += 1

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 2.5                       # ms


def _stub_lib(rc, calls):
    """A library bound as ``_cuda`` binds a kernel's, whose ``stub``
    launcher records its arguments and returns ``rc``."""
    def stub_launch(*args):
        calls.append(args)
        return rc
    lib = types.SimpleNamespace(
        stub_launch=stub_launch,
        stub_error_string=lambda code: b"stub refused %d" % code)
    _cuda._bind(lib, {"stub": ()})
    return lib


@pytest.mark.parametrize("on", [True, False])
def test_launcher_counts_kernel_time_when_on(monkeypatch, on):
    """``_cuda.launch`` on a stub library: while the trace records, each
    launch adds one launch and its events' time to the innermost span;
    off, nothing is recorded and no event is made.  Either way each
    launch counts once under its prefix."""
    calls = []
    lib = _stub_lib(0, calls)
    monkeypatch.setattr(_cuda, "_LAUNCHED", {})
    made = []
    monkeypatch.setattr(trace, "EVENTS", lambda handle: (
        made.append(handle) or _StubEvent(), _StubEvent(), None))
    if on:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.request("test"):
                with trace.span("kernel.site"):
                    _cuda.launch(lib, "stub", 1, 2, 77)
                    _cuda.launch(lib, "stub", 3, 4, 77)
    else:
        _cuda.launch(lib, "stub", 1, 2, 77)
    assert len(calls) == 2 if on else len(calls) == 1
    assert _cuda.launches()["stub"] == len(calls)
    assert sum(_cuda.launches().values()) == len(calls)
    spans = trace.spans()
    if not on:
        assert spans == [] and made == []
        return
    assert made == [77, 77]
    site = next(s for s in spans if s["name"] == "kernel.site")
    assert site["kernels"] == {"stub": [2, 0.005]}
    assert next(s for s in spans if s["name"] == "test")["kernels"] == {}


def test_launcher_raises_on_an_error_code_and_counts_nothing(monkeypatch):
    """A launcher's non-zero return code raises with the library's error
    string and the code; the refused launch is not counted."""
    calls = []
    lib = _stub_lib(9, calls)
    monkeypatch.setattr(_cuda, "_LAUNCHED", {"stub": 4})
    before = _cuda.launches()
    with pytest.raises(RuntimeError,
                       match=r"^stub kernel launch failed: stub refused 9 "
                             r"\(9\)$"):
        _cuda.launch(lib, "stub", 1, 2, 77)
    assert calls == [(1, 2, 77)]
    assert _cuda.launches() == before


def test_chrome_export_and_worker_hand_back():
    """A worker's spans (adopt, worker_started, take) merge under the
    parent's span; chrome() gives one complete event a span."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.request("job"):
            with trace.span("fanout"):
                state = trace.worker_state()
                parent = trace.spans()            # nothing closed yet
                assert parent == []
    request, fanout_id, t_pool = state
    spans = trace.take()
    try:
        trace.adopt(state)
        trace.worker_started()
        with trace.span("cluster"):
            trace.count("members", 3)
        handed = trace.take()
    finally:
        trace.adopt(None)
    assert [s["name"] for s in handed] == ["worker.start", "cluster"]
    assert all(s["request"] == request and s["parent"] == fanout_id
               for s in handed)
    assert handed[0]["start"] == t_pool
    trace.merge(spans + handed)
    events = trace.chrome(trace.spans(request))["traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "X"] == [
        "fanout", "job", "worker.start", "cluster"]
    cluster = next(e for e in events if e["name"] == "cluster")
    assert cluster["args"]["members"] == 3


def test_traced_run_counts_the_dps(tmp_path):
    """`run --profile DIR --refine device` with the device center-star: each
    align_ops_batch_device call's ``align.dp`` span counts its blocks,
    cells and pointer bytes, and each refine_msa call's ``align.refine``
    span its passes, kept passes, members, columns, cells and blocks, in
    DIR/spans.json."""
    fa = tmp_path / "three.fa"
    _three_families(fa)
    yaml = tmp_path / "device.yaml"
    yaml.write_text("align_backend: centerstar-device\n")
    prof = tmp_path / "prof"
    assert tcli.main(_run_argv(fa, tmp_path / "res", "-c", str(yaml),
                               "--refine", "device", "--profile",
                               str(prof))) == 0
    with open(prof / "spans.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    dp = [e["args"] for e in events if e["name"] == "align.dp"]
    polish = [e["args"] for e in events if e["name"] == "align.refine"]
    assert len(dp) == len(polish) == 3
    for a in dp:
        assert a["members"] == 7 and a["blocks"] == 1
        assert a["cells"] > 0 and a["ptr_bytes"] >= a["cells"]
    for a in polish:
        assert a["members"] == 8 and a["columns"] >= 480
        assert 1 <= a["passes"] <= 2 and a.get("kept", 0) <= a["passes"]
        assert a["blocks"] == a["passes"]
        assert a["cells"] >= a["passes"] * 8 * 480 * 470
        assert a["member_columns"] >= a["passes"] * 8 * 480
