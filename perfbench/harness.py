"""Runs one cell of BENCHMARK.json once and prints its result line.

Everything that belongs to one configuration, traffic mix, job kind or
metric is found by name, so a cell or a metric is added with files and an
entry in BENCHMARK.json and no edit here:

* ``configs/<config>.json``: the deployment (BENCHMARK.json names the file);
* ``traffic/<traffic>.json``: the cell's parameters; ``job`` names the
  driver;
* ``jobs/<job>.py``: ``setup(ctx)``, ``run_one(state, j)`` and
  ``check(state, run, readings)``, and ``TRACE``, the tracers a traced run
  starts ("profiler", "profiler_cuda", "nvml");
* ``metrics/<metric>.py``: ``read(run)`` -> a number, or None where the
  run holds nothing to read (the metric is then left out of the line).

One client in a closed loop: set-up (imports, the CUDA context, the
kernel libraries, the inputs made from the seed, a warm-up job), then jobs
one after another until ``seconds`` have passed, the last one run to its
end.  Rates are the completed jobs' work over the time from the window's
start to the last completion.  Then the check, which decides ``correct``.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import time
import traceback

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "multiprime_tpu")


class Refused(Exception):
    """A run that prints no result: no card, or a forbidden module."""


class Names:
    """Files of the benchmark found by kind and name: under each of
    ``dirs`` in turn (the benchmark's own folder last)."""

    def __init__(self, dirs=()):
        self.dirs = [*dirs, PKG]

    def path(self, kind, name, suffix):
        for d in self.dirs:
            p = os.path.join(d, kind, name + suffix)
            if os.path.exists(p):
                return p
        raise FileNotFoundError("no %s/%s%s under %s"
                                % (kind, name, suffix, self.dirs))

    def data(self, kind, name):
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind, name):
        path = self.path(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(
            "perfbench_%s_%s" % (kind, name.replace(".", "_")), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


class Context:
    """What a job driver is given: the cell's data, the seed, the device,
    a fresh work directory under TMPDIR, whether the run is traced, and
    where it puts spans and recorded calls."""

    def __init__(self, cell, config, traffic, seed, device, workdir, trace,
                 names):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device, self.workdir = seed, device, workdir
        self.trace, self.names = trace, names
        self.spans = []          # (name, start, end), perf_counter seconds
        self.calls = {}          # name -> recorded calls

    def span(self, name, start, end):
        self.spans.append((name, start, end))

    @staticmethod
    def log(*parts):
        print(*parts, flush=True)


class Run:
    """What one run gathered, for the metric readers."""

    def __init__(self, ctx, records, window, setup_s, tracer,
                 memory_peak_bytes=0):
        self.records = records
        self.memory_peak_bytes = memory_peak_bytes
        self.window_start, self.window_end = window
        self.setup_s = setup_s
        self.spans = ctx.spans
        self.calls = ctx.calls
        self.nvml = tracer.nvml if tracer else []
        self.profile = tracer.profile if tracer else None

    @property
    def elapsed_s(self):
        return self.window_end - self.window_start

    def completed(self):
        return [r for r in self.records if r["ok"]]


@contextlib.contextmanager
def environment(values):
    """Environment variables set for the span of one job, then restored."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _applies(metric, cell, e2e):
    """Whether a metric belongs to a cell: its ``workloads``, or where it
    has none, every cell (an end-to-end metric) or every cell that reports
    the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next((m for m in e2e if m["name"] == metric["moves"]), None)
        return moved is not None and _applies(moved, cell, e2e)
    return True


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cpu_s():
    """This process's CPU seconds so far, all its threads."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    return use.ru_utime + use.ru_stime


def _device_info(device, chips):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def _card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: no answer"
    return "card: " + out.strip().replace("\n", "; ")


def run_cell(workload, seed, seconds, trace, *, t_start, bench_path=None,
             search=(), device="cuda", chip_check=True, readings=False,
             out=None, err=None):
    """One run of one cell -> the result dict (also printed: earlier lines
    freely, the checks as the last lines of ``err``, the result as the last
    line of ``out``).  Raises Refused where no result may be printed."""
    out = out or sys.stdout
    err = err or sys.stderr
    bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    names = Names(search)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError("no workload %r in %s" % (workload, bench_path))
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg_path = cfg_entry["file"]
    if not os.path.isabs(cfg_path):
        cfg_path = os.path.join(os.path.dirname(os.path.abspath(bench_path)),
                                cfg_path)
    with open(cfg_path) as f:
        config = json.load(f)
    traffic = names.data("traffic", cell["traffic"])
    chips = int(cell["chips"])
    import torch
    if chip_check and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < chips):
        raise Refused("the cell asks for %d CUDA device(s); torch sees %s"
                      % (chips, torch.cuda.device_count()
                         if torch.cuda.is_available() else "none"))
    job = names.module("jobs", traffic["job"])
    workdir = tempfile.mkdtemp(prefix="perfbench-", dir=tempfile.gettempdir())
    ctx = Context(workload, config, traffic, seed, device, workdir, trace,
                  names)
    try:
        if torch.device(device).type == "cuda":
            print(_card_line(), file=out, flush=True)
        state = job.setup(ctx)
        setup_s = time.perf_counter() - t_start
        tracer = None
        if trace:
            from . import tracing
            tracer = tracing.Tracer(job.TRACE, workdir, device)
        records = []
        if tracer:
            tracer.start()
        w0 = time.perf_counter()
        j = 0
        while j == 0 or time.perf_counter() - w0 < seconds:
            cpu0 = _cpu_s()
            rec = {"job": j, "start": time.perf_counter(), "ok": False}
            try:
                rec.update(job.run_one(state, j))
                rec["ok"] = True
            except Exception:               # the run goes on; the job failed
                traceback.print_exc(file=err)
            rec["end"] = time.perf_counter()
            rec["cpu_s"] = _cpu_s() - cpu0
            records.append(rec)
            print("job %d: %s, %.3f s (cpu %.3f s)" % (
                j, "done" if rec["ok"] else "failed",
                rec["end"] - rec["start"], rec["cpu_s"]), file=out,
                flush=True)
            j += 1
        w1 = records[-1]["end"]
        if tracer:
            tracer.stop()
        bad = forbidden_modules()
        if bad:
            raise Refused("modules loaded in this process: %s" % bad)
        dev_info = _device_info(device, chips)
        run = Run(ctx, records, (w0, w1), setup_s, tracer,
                  dev_info["memory_peak_bytes"])
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        verdict = job.check(state, run, readings)
        result = _result(bench, cell, run, verdict, dev_info, tracer, names,
                         trace)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        raise Refused("modules loaded in this process: %s" % bad)
    if readings:
        print("READINGS " + json.dumps(verdict.get("readings", {})),
              file=out, flush=True)
    for name, c in result["checks"].items():
        print("check %s: %s (limit %s)" % (name, c["value"], c["limit"]),
              file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def _result(bench, cell, run, verdict, dev_info, tracer, names, trace):
    e2e = bench["end_to_end"]
    metrics = {}
    for m in (bench["per_layer"] if trace else e2e):
        if not _applies(m, cell["name"], e2e):
            continue
        if m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = names.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = verdict["checks"]
    refused = set(verdict.get("refused_jobs", ()))
    failed = sum(1 for r in run.records
                 if not r["ok"] or r["job"] in refused)
    correct = (failed == 0 and bool(run.completed())
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": len(run.records),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace:
        result["device"].update(tracer.device_times())
        result["breakdown"] = tracer.breakdown(verdict)
    result["checks"] = checks
    return result


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", type=int, choices=(0, 1), default=0,
                   help="also print the control's numbers (step 2 of the "
                        "check's limits); the benchmark's runs leave it off")
    args = p.parse_args(argv)
    try:
        run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                 t_start=t_start, readings=bool(args.readings))
    except Refused as e:
        print("perfbench: no result: %s" % e, file=sys.stderr, flush=True)
        return 2
    except Exception:
        traceback.print_exc()
        print("perfbench: no result", file=sys.stderr, flush=True)
        return 1
    return 0
