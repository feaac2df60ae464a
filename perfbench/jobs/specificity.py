"""``specificity`` jobs: one primer panel screened against a background of
bacterial genomes, through ``multiprime_tpu_torch.cli.main.main`` in this
process, one fresh output directory a panel.

The configuration holds the background (``background``: genome lengths
and the planted amplicons) and the scan's flags (``scan``: term_len, term,
mm, product_size, exhaustive).  The traffic file names the panel generator
(``generator``, under generators/) with its ``pool`` and ``panels``, how
many panels the check compares (``check_panels``) and environment
variables set around each job (``env``).  Set-up makes the
pool, the background with the pool's amplicons planted in it (one FASTA
under TMPDIR) and every panel, from the seed.

A traced run times, from these files, each ``scan_hits_long`` call (both
directions of a panel; ended by a synchronise) and each ``pcr_join``, and
records the shapes of each ``find_hits`` call for its roofline.

The check, after the window: the rows of a sample of the completed panels
drawn from the seed, the largest panel always in it, against a plain scan
and exhaustive join over the background (reference/scan.py).
"""

import os
import time

import numpy as np

TRACE = ("profiler",)


def _argv(scan):
    return ["-l", str(scan["term_len"]), "-t", str(scan["term"]),
            "-m", str(scan["mm"]), "-s", "%d,%d" % tuple(scan["product_size"])
            ] + (["--exhaustive-join"] if scan["exhaustive"] else [])


def _trace_calls(ctx):
    """Spans around the scan and the join, and find_hits's shapes."""
    import torch
    from torch.profiler import record_function
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.validate import scan as vscan
    cuda = torch.device(ctx.device).type == "cuda"

    def spanned(name, fn, sync):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with record_function("perfbench:" + name):
                out = fn(*args, **kwargs)
                if sync and cuda:
                    torch.cuda.synchronize()
            ctx.span(name, t0, time.perf_counter())
            return out
        return wrapper

    vscan.scan_hits_long = spanned("spec.scan", vscan.scan_hits_long, True)
    vscan.pcr_join = spanned("spec.join", vscan.pcr_join, False)
    calls = ctx.calls.setdefault("find_hits", [])
    find_hits = ms.find_hits

    def recorded(target_masks, lengths, planes, suffix_planes, **kw):
        calls.append({"shape": tuple(target_masks.shape),
                      "mask_bytes": target_masks.element_size(),
                      "lens": lengths, "p": planes.shape[0],
                      "plen": kw["plen"], "max_hits": kw["max_hits"]})
        return find_hits(target_masks, lengths, planes, suffix_planes, **kw)
    ms.find_hits = recorded


def setup(ctx):
    from perfbench.generators import bacterial_background
    from multiprime_tpu_torch.cli import main as cli
    import torch
    cfg, tr = ctx.config, ctx.traffic
    if torch.device(ctx.device).type == "cuda":
        from multiprime_tpu_torch.ops import _cuda
        torch.cuda.init()
        # the kernel libraries this cell's jobs launch (nvcc in a
        # checkout's first run only)
        _cuda.build(list(tr["kernels"]))
        for name in tr["kernels"]:
            _cuda.load(name)
    gen = ctx.names.module("generators", tr["generator"])
    pool = gen.pool(tr["pool"], ctx.seed)
    ids, genomes, sites = bacterial_background.generate(
        cfg["background"], ctx.seed, pool)
    bg = os.path.join(ctx.workdir, "background.fa")
    bacterial_background.write_fasta(bg, ids, genomes)
    panels = gen.panels(tr["panels"], pool, ctx.seed)
    pdir = os.path.join(ctx.workdir, "panels")
    os.makedirs(pdir)
    paths = []
    for j, panel in enumerate(panels):
        paths.append(os.path.join(pdir, "panel%d.fa" % j))
        gen.write_fasta(paths[-1], panel)
    ctx.log("background: %d genomes, %d bases, %d planted amplicons; %d "
            "panels of %s pairs" % (len(genomes), sum(map(len, genomes)),
                                    len(sites), len(panels),
                                    sorted({len(p) // 2 for p in panels})))
    state = {"ctx": ctx, "cli": cli, "bg": bg, "ids": ids,
             "genomes": genomes, "panels": panels, "paths": paths}
    # the largest panel against the whole background: imports, the kernel
    # library, the CUDA context and the allocator at the window's shapes
    largest = max(range(len(panels)), key=lambda k: len(panels[k]))
    _job(state, "warmup", paths[largest], bg)
    if ctx.trace:
        _trace_calls(ctx)
    return state


def _job(state, name, panel, background):
    from perfbench import harness
    ctx = state["ctx"]
    out_dir = os.path.join(ctx.workdir, "jobs", name)
    os.makedirs(out_dir)
    out = os.path.join(out_dir, "s.out")
    with harness.environment(ctx.traffic.get("env", {})):
        rc = state["cli"].main(["specificity", "-i", panel, "-r",
                                background, "-o", out,
                                *_argv(ctx.config["scan"]),
                                "--device", ctx.device])
    if rc != 0:
        raise RuntimeError("specificity exited %s" % rc)
    return out


def run_one(state, j):
    k = j % len(state["paths"])
    out = _job(state, "job%d" % j, state["paths"][k], state["bg"])
    return {"work": {"panels": 1}, "out": out, "panel": k}


def check(state, run, readings):
    from perfbench.reference import scan as ref
    ctx = state["ctx"]
    t0 = time.perf_counter()
    done = run.completed()
    n = int(ctx.traffic["check_panels"])
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 4])
    sample = set()
    if done:
        largest = max(done, key=lambda r: len(state["panels"][r["panel"]]))
        sample.add(largest["job"])
        picks = rng.permutation(len(done))[:max(n - 1, 0)]
        sample |= {done[int(i)]["job"] for i in picks}
    targets = ref.Targets([g.tobytes().decode("ascii")
                           for g in state["genomes"]], ctx.device)
    scan = ctx.config["scan"]
    kw = dict(term_len=scan["term_len"], term=scan["term"], mm=scan["mm"],
              product_size=scan["product_size"], exhaustive=scan["exhaustive"])
    differ = compared = 0
    refused, extra = [], {}
    for rec in done:
        if rec["job"] not in sample:
            continue
        panel = state["panels"][rec["panel"]]
        want = ref.predicted_rows(panel, state["ids"], targets, **kw)
        bad = ref.rows_differing(ref.read_rows(rec["out"]), want)
        differ += bad
        compared += len(want)
        if bad:
            refused.append(rec["job"])
        if readings:
            # the control: the reference with one mismatch fewer allowed
            ctl = ref.predicted_rows(panel, state["ids"], targets,
                                     **dict(kw, mm=scan["mm"] - 1))
            extra["control.rows_differing"] = extra.get(
                "control.rows_differing", 0) + ref.rows_differing(ctl, want)
    ctx.log("check: %d panels of %d, %d rows compared in %.1f s"
            % (len(sample), len(done), compared, time.perf_counter() - t0))
    return {"checks": {"rows_differing": {"value": differ, "limit": 0}},
            "refused_jobs": refused, "readings": extra}
