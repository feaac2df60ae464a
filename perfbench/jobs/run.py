"""``run`` jobs: the port's whole pipeline on a viral CDS corpus, through
``multiprime_tpu_torch.cli.main.main`` in this process, one fresh results
directory a job.

The configuration holds the corpus (``families`` ... ``copy_every``), the
pipeline's settings (written to a ``--config`` YAML) and the rule-19
coverage scan's flags (``coverage_scan``).  The traffic file holds the
job's own flags (``argv``), further YAML keys (``yaml``), environment
variables set around each job (``env``), whether the device stages'
outputs are recorded for the check (``capture``; the share of one-row
MSAs whose Stage A is kept, ``stage_a_singleton_share``) and how many
job corpora set-up makes (``prepared_jobs``).  Job j's corpus is drawn
from (seed, j): every job of every run is a corpus of its own, with the
sizes the configuration states, so no job finds the primers of another
in the program's in-process memos.  A job past the prepared ones makes
its corpus as it starts, inside the window (about 0.1 s).

The check, after the window (reference/): every job's coverage rows
(Core_primers_set/BWT_coverage/*.out) against a plain scan and join of
its core primers over its corpus; where the traffic captures, the Stage-A
statistics of every multi-row MSA and of the sampled one-row MSAs against
the plain Stage A of the MSA file, and every center-star DP call's ops
against the plain Gotoh DP of the same center and members, which must be
sequences of the job's corpus.
"""

import json
import os
import shutil
import time

import numpy as np

TRACE = ("nvml", "profiler_cuda")
_WARMUP = {"families": 1, "members": 40, "singletons": 2}


def _rng_seed(seed, job):
    return [int(seed) % (1 << 63), 0 if job == "warmup" else 1 + job]


def _settings_yaml(path, config, traffic):
    settings = dict(config["settings"])
    scan = config["coverage_scan"]
    settings.update(scan_term_len=scan["term_len"], scan_term=scan["term"],
                    scan_mm=scan["mm"],
                    scan_product="%d,%d" % tuple(scan["product_size"]))
    settings.update(traffic.get("yaml", {}))
    with open(path, "w") as f:
        for k, v in settings.items():
            f.write("%s: %s\n" % (k, json.dumps(v)))


def setup(ctx):
    from perfbench import capture
    from perfbench.generators import viral_corpus
    from multiprime_tpu_torch import native
    from multiprime_tpu_torch.cli import main as cli
    cfg, tr = ctx.config, ctx.traffic
    import torch
    if torch.device(ctx.device).type == "cuda":
        from multiprime_tpu_torch.ops import _cuda
        torch.cuda.init()
        # the kernel libraries this cell's jobs launch (nvcc in a
        # checkout's first run only)
        _cuda.build(list(tr["kernels"]))
        for name in tr["kernels"]:
            _cuda.load(name)
    native.available()                   # builds the host library once
    if tr.get("capture"):
        capture.install()
    yaml_path = os.path.join(ctx.workdir, "settings.yaml")
    _settings_yaml(yaml_path, cfg, tr)
    inputs = os.path.join(ctx.workdir, "inputs")
    os.makedirs(inputs)
    state = {"ctx": ctx, "cli": cli, "yaml": yaml_path, "inputs": inputs,
             "corpora": {}}
    for j in range(int(tr["prepared_jobs"])):
        _corpus(state, j)
    # one small job through every stage the cell's jobs run: imports,
    # kernel libraries, the native library and a worker pool
    ids, rows = viral_corpus.generate(dict(cfg, **_WARMUP),
                                      _rng_seed(ctx.seed, "warmup"))
    warm = os.path.join(inputs, "warmup.fa")
    viral_corpus.write_fasta(warm, ids, rows)
    _job(state, "warmup", warm, capture_dir=None)
    shutil.rmtree(os.path.join(ctx.workdir, "warmup"))
    return state


def _corpus(state, j):
    """Job j's corpus, drawn from (seed, j) and written once -> (path, ids,
    rows)."""
    from perfbench.generators import viral_corpus
    if j not in state["corpora"]:
        ctx = state["ctx"]
        ids, rows = viral_corpus.generate(ctx.config, _rng_seed(ctx.seed, j))
        path = os.path.join(state["inputs"], "job%d.fa" % j)
        viral_corpus.write_fasta(path, ids, rows)
        state["corpora"][j] = (path, ids, rows)
    return state["corpora"][j]


def _job(state, name, fasta, capture_dir):
    from perfbench import capture, harness
    ctx = state["ctx"]
    res = os.path.join(ctx.workdir, name, "res")
    env = dict(ctx.traffic.get("env", {}))
    if capture_dir is not None:
        env[capture.DIR_VAR] = capture_dir
        env[capture.SEED_VAR] = ctx.seed
        env[capture.SHARE_VAR] = ctx.traffic.get("stage_a_singleton_share",
                                                 0)
    argv = ["run", "-c", state["yaml"], "-i", fasta, "-r", res,
            *ctx.traffic.get("argv", []), "--device", ctx.device]
    with harness.environment(env):
        rc = state["cli"].main(argv)
    if rc != 0:
        raise RuntimeError("run exited %s" % rc)
    with open(os.path.join(res, "pipeline_metrics.json")) as f:
        return res, json.load(f)


# what the check reads of a job's results; the rest of the tree goes as
# soon as the job ends, before most of it has reached the disk
_KEPT = (("Core_primers_set", "BWT_coverage"),
         ("Core_primers_set", "core_final_maxprimers_set.fa"),
         ("Primers_set", "final_maxprimers_set.fa"),
         ("Clusters_msa",))


def _keep(res, kept):
    """Moves what the check reads to ``kept``, deletes the rest -> the bytes
    the job wrote."""
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, files in os.walk(res) for f in files)
    for parts in _KEPT:
        src = os.path.join(res, *parts)
        if os.path.exists(src):
            dst = os.path.join(kept, *parts)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.rename(src, dst)
    shutil.rmtree(res)
    return written


def run_one(state, j):
    ctx = state["ctx"]
    fasta, ids, _ = _corpus(state, j)
    cap = (os.path.join(ctx.workdir, "job%d" % j, "capture")
           if ctx.traffic.get("capture") else None)
    res, metrics = _job(state, "job%d" % j, fasta, cap)
    kept = os.path.join(ctx.workdir, "job%d" % j, "kept")
    ctx.log("job %d wrote %d bytes of results" % (j, _keep(res, kept)))
    return {"work": {"seqs": len(ids)}, "res": kept, "capture": cap,
            "corpus": j, "timings_s":
            metrics["timings_s"], "backends": metrics["backends"]}


# -- the check ---------------------------------------------------------------

def _coverage_rows(state, rec, control=False):
    from perfbench.reference import scan as ref
    cfg = state["ctx"].config
    res = rec["res"]
    core = os.path.join(res, "Core_primers_set", "core_final_maxprimers_set.fa")
    name = "core_final_maxprimers_set.out"
    if not os.path.exists(core):
        core = os.path.join(res, "Primers_set", "final_maxprimers_set.fa")
        name = "final_maxprimers_set.out"
    out = os.path.join(res, "Core_primers_set", "BWT_coverage", name)
    _, ids, rows = state["corpora"][rec["corpus"]]
    targets = state.setdefault("targets", {})
    if rec["corpus"] not in targets:
        targets.clear()
        targets[rec["corpus"]] = ref.Targets(
            [r.tobytes().decode("ascii") for r in rows], state["ctx"].device)
    scan = cfg["coverage_scan"]
    kw = dict(term_len=scan["term_len"], term=scan["term"], mm=scan["mm"],
              product_size=scan["product_size"], exhaustive=scan["exhaustive"])
    primers = ref.read_primers(core)
    want = ref.predicted_rows(primers, ids, targets[rec["corpus"]], **kw)
    got = ref.read_rows(out)
    readings = {}
    if control:
        # the control: the reference with one mismatch fewer allowed
        kw["mm"] = scan["mm"] - 1
        readings["control.coverage_rows_differing"] = ref.rows_differing(
            ref.predicted_rows(primers, ids, targets[rec["corpus"]], **kw),
            want)
    return ref.rows_differing(got, want), len(want), readings


def _msa_masks(res):
    """digest -> (rows, columns) of every MSA the job wrote, its masks as
    the reference reads the file."""
    from perfbench import capture
    from perfbench.reference import stage_a
    out = {}
    msa_dir = os.path.join(res, "Clusters_msa")
    for name in sorted(os.listdir(msa_dir)):
        if name.endswith(".tmsa"):
            masks = stage_a.read_msa_masks(os.path.join(msa_dir, name))
            out[capture.masks_digest(masks)] = masks
    return out


def _stage_a_differing(state, rec, msas, records, control=False):
    """Windows whose Stage-A outputs differ from the plain Stage A, a
    multi-row MSA with no record counting all its columns; with
    ``control``, also the windows in which the control (the plain Stage A
    with its counts held in int8, not int64) differs from the plain Stage
    A."""
    import torch
    from perfbench import capture
    from perfbench.reference import stage_a
    cfg = state["ctx"].config["settings"]
    plen, variation = int(cfg["primer_len"]), int(cfg["variation"])
    bad = compared = ctl_bad = 0
    seen = set()
    for r in records:
        digest = str(r["digest"])
        masks = msas.get(digest)
        pos = r["positions"]
        if masks is None or len(pos) == 0 or pos.min() < 0 \
                or pos.max() + plen > masks.shape[1]:
            bad += max(len(pos), 1)
            continue
        seen.add(digest)
        lo = 0
        for size, wdig in zip(r["block_sizes"], r["win_digests"]):
            blk = pos[lo:lo + size]
            want = stage_a.stats(masks, blk, plen=plen, variation=variation,
                                 device=state["ctx"].device)
            differ = np.zeros(size, bool)
            for key in ("freq", "nn", "cover_number", "gap_number",
                        "viterbi"):
                got = r[key][lo:lo + size].reshape(size, -1)
                differ |= (got != want[key].reshape(size, -1)).any(axis=1)
            if capture.win_digest(want["win"]) != str(wdig):
                # one hash a block: every window of the block counts
                differ[:] = True
            bad += int(differ.sum())
            if control:
                ctl = stage_a.stats(masks, blk, plen=plen,
                                    variation=variation,
                                    device=state["ctx"].device,
                                    counts=torch.int8)
                ctl_differ = np.zeros(size, bool)
                for key in ("freq", "nn", "cover_number", "gap_number",
                            "viterbi"):
                    ctl_differ |= (ctl[key].reshape(size, -1)
                                   != want[key].reshape(size, -1)).any(axis=1)
                ctl_bad += int(ctl_differ.sum())
            compared += size
            lo += size
    for digest, masks in msas.items():
        if masks.shape[0] > 1 and digest not in seen:
            bad += masks.shape[1]
    return bad, compared, ctl_bad


def _gotoh_differing(state, rec, records, n_multi, fault=False):
    """Members whose center-star ops differ from the plain Gotoh DP, or
    whose center or member is not a sequence of the job's corpus; a
    multi-row MSA with no DP call counts one.  With ``fault``, also the
    members that differ where the plain DP stands in for the program with
    an answer altered: member 0's first op of each call split into a gap
    on each side."""
    from perfbench.reference import gotoh
    _, _, rows = state["corpora"][rec["corpus"]]
    corpus = {r.tobytes().decode("ascii") for r in rows}
    bad = compared = faulted = 0
    for r in records:
        lens = r["lens"]
        members = np.split(r["members"], np.cumsum(lens)[:-1])
        want = gotoh.align(r["center"], members, state["ctx"].device)
        if fault and want:
            altered = np.concatenate([[1, 2], want[0][1:]]).astype(np.uint8)
            faulted += int(not np.array_equal(altered, want[0]))
        ops = r["ops"]
        inputs_ok = gotoh.decode(r["center"]) in corpus
        for k, (m, w) in enumerate(zip(members, want)):
            got = ops[k][ops[k] != 3]
            if not inputs_ok or gotoh.decode(m) not in corpus \
                    or not np.array_equal(got, w):
                bad += 1
        compared += len(members)
    bad += max(n_multi - len(records), 0)
    return bad, compared, faulted


def check(state, run, readings):
    from perfbench import capture
    ctx = state["ctx"]
    t0 = time.perf_counter()
    cov = stage = dp = 0
    n_rows = n_windows = n_members = 0
    refused, extra = [], {}
    for rec in run.completed():
        differ, rows, more = _coverage_rows(state, rec, control=readings)
        for k, v in more.items():
            extra[k] = extra.get(k, 0) + v
        job_bad = differ
        cov += differ
        n_rows += rows
        if rec["capture"] is not None:
            spent, size = capture.cost(rec["capture"])
            ctx.log("job %d: the capture took %.3f s summed over the "
                    "workers and kept %d bytes" % (rec["job"], spent, size))
            msas = _msa_masks(rec["res"])
            a_recs, g_recs = capture.load(rec["capture"])
            s_bad, s_n, s_ctl = _stage_a_differing(state, rec, msas, a_recs,
                                                   control=readings)
            if readings:
                extra["control.stage_a_windows_differing"] = extra.get(
                    "control.stage_a_windows_differing", 0) + s_ctl
            n_multi = sum(m.shape[0] > 1 for m in msas.values())
            g_bad, g_n, g_fault = _gotoh_differing(state, rec, g_recs,
                                                   n_multi, fault=readings)
            if readings:
                extra["fault.gotoh_members_differing"] = extra.get(
                    "fault.gotoh_members_differing", 0) + g_fault
            stage += s_bad
            dp += g_bad
            n_windows += s_n
            n_members += g_n
            job_bad += s_bad + g_bad
        if job_bad:
            refused.append(rec["job"])
        shutil.rmtree(os.path.dirname(rec["res"]), ignore_errors=True)
    checks = {"coverage_rows_differing": {"value": cov, "limit": 0}}
    if ctx.traffic.get("capture"):
        checks["stage_a_windows_differing"] = {"value": stage, "limit": 0}
        checks["gotoh_members_differing"] = {"value": dp, "limit": 0}
    ctx.log("check: %d coverage rows, %d Stage-A windows, %d center-star "
            "members compared in %.1f s" % (n_rows, n_windows, n_members,
                                           time.perf_counter() - t0))
    for rec in run.completed():
        ctx.log("job %d: stages %s; backends %s" % (
            rec["job"], json.dumps(rec["timings_s"]),
            json.dumps(rec["backends"])))
    done = run.completed()
    gaps = []
    if done:
        for key in ("align", "design", "pair", "cluster", "solve", "pcr",
                    "scan"):
            vals = [r["timings_s"].get(key, 0.0) for r in done]
            gaps.append(["host stage %s, s a job (summed over workers)"
                         % key, sum(vals) / len(vals)])
        gaps.sort(key=lambda g: -g[1])
    return {"checks": checks, "refused_jobs": refused, "readings": extra,
            "idle_gaps": gaps}
