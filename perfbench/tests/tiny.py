"""A benchmark of tiny cells, written into a test's temporary directory: the
repository's configurations and traffic cut to sizes a CPU runs in
seconds, and cells defined only there."""

import io
import json
import os
import time

from perfbench import harness

ROOT = harness.ROOT
CELLS = {"tiny.device": ("tiny-cds", "tiny-device"),
         "tiny.spec": ("tiny-bg", "tiny-panels"),
         "tiny.host": ("tiny-cds", "tiny-host")}


def _load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def write(tmp):
    """-> (BENCHMARK.json path, its folder of files): three tiny cells."""
    base = os.path.join(tmp, "perfbench")
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    bench = _load("BENCHMARK.json")
    cds = _load("perfbench", "configs", "viral-cds-panel.json")
    cds.update(families=2, members=30, singletons=4)
    cds["settings"]["nproc"] = 1
    bg = _load("perfbench", "configs", "spec-bacterial-64mb.json")
    bg["background"].update(lengths=[150000, 120000], plants=6, straddles=2)
    traffic = {
        "tiny-device": dict(_load("perfbench", "traffic",
                                  "run-device-jobs.json"),
                            prepared_jobs=2, stage_a_singleton_share=0.5),
        "tiny-host": dict(_load("perfbench", "traffic", "run-host-jobs.json"),
                          prepared_jobs=2),
        "tiny-panels": dict(_load("perfbench", "traffic", "spec-panels.json"),
                            pool=dict(_load("perfbench", "traffic",
                                            "spec-panels.json")["pool"],
                                      pairs=12),
                            panels={"sizes": [3, 5], "count": 4},
                            check_panels=2,
                            # the scan held to its device path (find_hits)
                            env={"MPTPU_FORCE_BACKEND": "device"}),
    }
    for name, cfg in (("tiny-cds", cds), ("tiny-bg", bg)):
        with open(os.path.join(base, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
    for name, tr in traffic.items():
        with open(os.path.join(base, "traffic", name + ".json"), "w") as f:
            json.dump(tr, f)
    by_name = {c["name"]: c for c in bench["configs"]}
    bench["configs"] = [
        dict(by_name["viral-cds-panel"], name="tiny-cds",
             file="perfbench/configs/tiny-cds.json"),
        dict(by_name["spec-bacterial-64mb"], name="tiny-bg",
             file="perfbench/configs/tiny-bg.json")]
    # the cell of BENCHMARK.json each tiny cell takes its entries from;
    # the host path's traffic has no cell there yet
    old = {"tiny.device": "run.device", "tiny.spec": "spec.bg64",
           "tiny.host": "run.device"}
    bench["workloads"] = [dict(next(w for w in bench["workloads"]
                                    if w["name"] == old[cell]),
                               name=cell, config=cfg, traffic=tr)
                          for cell, (cfg, tr) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c, o in old.items()
                              if o in m["workloads"]]
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return path, base


def run(tmp, cell, *, seed=7, seconds=0.0, trace=False, readings=False,
        device="cpu"):
    """One run of a tiny cell in this process -> (result, stdout, stderr)."""
    path, base = write(str(tmp))
    out, err = io.StringIO(), io.StringIO()
    result = harness.run_cell(cell, seed, seconds, trace,
                              t_start=time.perf_counter(), bench_path=path,
                              search=[base], device=device,
                              chip_check=False, readings=readings, out=out,
                              err=err)
    return result, out.getvalue(), err.getvalue()
