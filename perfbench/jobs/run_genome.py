"""``run`` jobs of whole genomes: the port's whole pipeline on a corpus of
viral genome families with indels (generators/viral_genomes.py), through
``multiprime_tpu_torch.cli.main.main`` in this process, one fresh results
directory a job.  Set-up, the job and what a job keeps are those of
jobs/run.py, with this generator; the warm-up job is one family of 40
genomes at full length.

Set-up first asks the program's ``run --help`` for every flag of the
traffic's ``argv``, and fails at once where one is missing (a program that
cannot run this cell), before it builds or runs anything.

The check, after the window (reference/), each part with limit 0:

* ``coverage_rows_differing``, ``stage_a_windows_differing``: as in
  jobs/run.py, for every completed job;
* ``gotoh_members_differing``: every recorded center-star DP call's
  members whose center or sequence is not in the job's corpus, whose ops do
  not give the optimum score of a plain score-only DP of every member, or,
  for a seeded sample of ``GOTOH_SAMPLE`` members a call (every member of a
  smaller call), whose ops differ from the plain DP's (its pointers in
  blocks that fit ``GOTOH_PTR_BYTES``); a multi-row MSA with no call
  counts one;
* ``refine_rows_differing``: for one multi-row MSA a run, the rows of
  the job's ``Clusters_msa`` file against the whole chain rebuilt plainly:
  the recorded ops merged into the center-star MSA, then the plain polish
  passes (reference/refine.py, float32, pointers in blocks that fit
  ``REFINE_PTR_BYTES``).  The MSA is the first, in an order drawn from the
  seed, that the program polished (a kept pass), so that a wrong pass
  cannot hide behind a pass both sides reject; where the program polished
  none, the first in that order.  The passes the plain polish kept are
  logged.

With ``readings``, besides jobs/run.py's controls, the rows that differ
where the plain answer stands in for the program's with one change:
``fault.gotoh_members_differing`` (a sampled member's ops with the first op
split into a gap on each side, a call) and ``fault.refine_rows_differing``
(the rebuilt MSA with its first residue that has a gap after it moved into
that gap).
"""

import contextlib
import io
import os
import shutil
import time

import numpy as np

TRACE = ("nvml", "profiler_cuda")
_WARMUP = {"families": 1, "members": 40, "singletons": 0}
GOTOH_SAMPLE = 32
GOTOH_PTR_BYTES = 8 << 30
REFINE_PTR_BYTES = 48 << 30
# the polish passes of the pipeline's default (PipelineConfig.msa_refine)
# where the settings name none
_PASSES = 2


def _takes_flags(cli, argv):
    """Raises where the program's ``run --help`` lists no flag of ``argv``:
    a program that does not take this cell's jobs."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            cli.main(["run", "--help"])
        except SystemExit:
            pass
    missing = [a for a in argv if a.startswith("--")
               and a not in out.getvalue()]
    if missing:
        raise RuntimeError("the program's run takes no %s" % missing)


def setup(ctx):
    from multiprime_tpu_torch.cli import main as cli
    cfg, tr = ctx.config, ctx.traffic
    _takes_flags(cli, tr.get("argv", []))
    from perfbench import capture
    from perfbench.generators import viral_genomes
    from multiprime_tpu_torch import native
    base = ctx.names.module("jobs", "run")
    import torch
    if torch.device(ctx.device).type == "cuda":
        from multiprime_tpu_torch.ops import _cuda
        torch.cuda.init()
        _cuda.build(list(tr["kernels"]))
        for name in tr["kernels"]:
            _cuda.load(name)
    native.available()
    if tr.get("capture"):
        capture.install()
    yaml_path = os.path.join(ctx.workdir, "settings.yaml")
    base._settings_yaml(yaml_path, cfg, tr)
    inputs = os.path.join(ctx.workdir, "inputs")
    os.makedirs(inputs)
    state = {"ctx": ctx, "cli": cli, "yaml": yaml_path, "inputs": inputs,
             "corpora": {}, "base": base}
    for j in range(int(tr["prepared_jobs"])):
        _corpus(state, j)
    ids, rows = viral_genomes.generate(dict(cfg, **_WARMUP),
                                       base._rng_seed(ctx.seed, "warmup"))
    warm = os.path.join(inputs, "warmup.fa")
    viral_genomes.write_fasta(warm, ids, rows)
    base._job(state, "warmup", warm, capture_dir=None)
    shutil.rmtree(os.path.join(ctx.workdir, "warmup"))
    return state


def _corpus(state, j):
    """Job j's corpus, drawn from (seed, j) and written once -> (path, ids,
    rows)."""
    from perfbench.generators import viral_genomes
    if j not in state["corpora"]:
        ctx = state["ctx"]
        ids, rows = viral_genomes.generate(
            ctx.config, state["base"]._rng_seed(ctx.seed, j))
        path = os.path.join(state["inputs"], "job%d.fa" % j)
        viral_genomes.write_fasta(path, ids, rows)
        state["corpora"][j] = (path, ids, rows)
    return state["corpora"][j]


def run_one(state, j):
    ctx, base = state["ctx"], state["base"]
    fasta, ids, _ = _corpus(state, j)
    cap = (os.path.join(ctx.workdir, "job%d" % j, "capture")
           if ctx.traffic.get("capture") else None)
    res, metrics = base._job(state, "job%d" % j, fasta, cap)
    kept = os.path.join(ctx.workdir, "job%d" % j, "kept")
    ctx.log("job %d wrote %d bytes of results" % (j, base._keep(res, kept)))
    return {"work": {"seqs": len(ids)}, "res": kept, "capture": cap,
            "corpus": j, "timings_s": metrics["timings_s"],
            "backends": metrics["backends"]}


# -- the check ---------------------------------------------------------------

def _split(r):
    """A recorded DP call -> (center codes, member code arrays, forward
    ops a member)."""
    members = np.split(r["members"], np.cumsum(r["lens"])[:-1])
    ops = [o[o != 3] for o in r["ops"]]
    return r["center"], members, ops


def _sample(seed, job, call, m):
    """A seeded sample of GOTOH_SAMPLE of m members (all of a smaller
    call), in order."""
    if m <= GOTOH_SAMPLE:
        return list(range(m))
    rng = np.random.default_rng([int(seed) % (1 << 63), job, call])
    return sorted(rng.choice(m, GOTOH_SAMPLE, replace=False).tolist())


def _gotoh_differing(state, rec, records, n_multi, fault=False):
    """Members whose recorded ops fail the check (module docstring);
    -> (differing, compared, faulted)."""
    from perfbench.reference import gotoh, gotoh_blocked as gb
    ctx = state["ctx"]
    _, _, rows = state["corpora"][rec["corpus"]]
    corpus = {r.tobytes().decode("ascii") for r in rows}
    bad = compared = faulted = 0
    for n, r in enumerate(records):
        c, members, got = _split(r)
        la, lb = len(c), max(max(len(b) for b in members), 1)
        sample = _sample(ctx.seed, rec["job"], n, len(members))
        fit = gb.members_fitting(la, lb, GOTOH_PTR_BYTES)
        scores, ptr = gb.dp(c, members, ctx.device, keep=sample[:fit])
        want = gb.trace(ptr, la, [len(members[k]) for k in sample[:fit]])
        want += gb.align(c, [members[k] for k in sample[fit:]], ctx.device,
                         GOTOH_PTR_BYTES)
        exact = dict(zip(sample, want))
        if fault:
            k = sample[0]
            altered = np.concatenate([[1, 2], exact[k][1:]]).astype(np.uint8)
            faulted += int(not np.array_equal(altered, exact[k])
                           or gb.ops_score(c, members[k], altered)
                           != scores[k])
        inputs_ok = gotoh.decode(c) in corpus
        for k, (b, o) in enumerate(zip(members, got)):
            if not inputs_ok or gotoh.decode(b) not in corpus \
                    or gb.ops_score(c, b, o) != scores[k] \
                    or (k in exact and not np.array_equal(o, exact[k])):
                bad += 1
        compared += len(members)
    bad += max(n_multi - len(records), 0)
    return bad, compared, faulted


def _read_msa(path):
    """An MSA FASTA -> (ids, uint8 ASCII rows [N, C])."""
    ids, rows, cur = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    rows.append("".join(cur))
                ids.append(line[1:].strip())
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        rows.append("".join(cur))
    return ids, np.stack([np.frombuffer(r.encode("ascii"), np.uint8)
                          for r in rows])


def _job_msa(rec, r):
    """The job's ``Clusters_msa`` file of the recorded DP call ``r`` ->
    (its rows, uint8 ASCII [N, C], and the center's row), or None where no
    file holds the call's center and members in order."""
    from perfbench.reference import gotoh
    c, members, _ = _split(r)
    center = gotoh.decode(c).encode("ascii")
    seqs = [gotoh.decode(b).encode("ascii") for b in members]
    n = 1 + len(seqs)
    msa_dir = os.path.join(rec["res"], "Clusters_msa")
    for name in sorted(os.listdir(msa_dir)):
        if not name.endswith(".tmsa"):
            continue
        _, mat = _read_msa(os.path.join(msa_dir, name))
        if mat.shape[0] != n:
            continue
        stripped = [row[row != ord("-")].tobytes() for row in mat]
        for p in range(n):
            if stripped[p] == center \
                    and stripped[:p] + stripped[p + 1:] == seqs:
                return mat, p
    return None


def _star(r, p):
    """The plain center-star MSA of the recorded DP call ``r``, its
    center's row at ``p`` as in the job's file."""
    from perfbench.reference import gotoh, refine
    c, members, ops = _split(r)
    star = refine.merge(gotoh.decode(c).encode("ascii"),
                        [gotoh.decode(b).encode("ascii") for b in members],
                        ops)
    return np.concatenate([star[1:1 + p], star[:1], star[1 + p:]])


def _differing(a, b):
    """Rows of ``a`` that differ from ``b``'s (all where the shapes do)."""
    return len(a) if a.shape != b.shape else int((a != b).any(axis=1).sum())


def _refine_differing(state, pick, fault=False):
    """Rows of the chosen MSA (``_refine_choice``) that differ from the
    plain chain (module docstring) -> (differing, rows, faulted, passes
    the plain polish kept)."""
    from perfbench.reference import refine
    ctx = state["ctx"]
    _, _, r, found = pick
    if found is None:
        n = 1 + len(r["lens"])
        return n, n, 0, 0
    mat, p = found
    passes = int(ctx.config["settings"].get("msa_refine", _PASSES))
    want, kept = refine.refine(_star(r, p), passes, ctx.device,
                               ptr_bytes=REFINE_PTR_BYTES)
    faulted = 0
    if fault:
        altered = want.copy()
        row, col = np.argwhere((altered[:, :-1] != ord("-"))
                               & (altered[:, 1:] == ord("-")))[0]
        altered[row, col:col + 2] = altered[row, col:col + 2][::-1]
        faulted = _differing(altered, want)
    return _differing(mat, want), len(mat), faulted, kept


def _refine_choice(seed, run):
    """The MSA whose polish the check rebuilds -> (job, recorded call
    file, the call, ``_job_msa``'s find), or None where no completed job
    recorded a call.  The calls are tried in an order drawn from the seed;
    the first whose MSA the program polished (its rows are not the plain
    center-star MSA's, all-gap columns dropped) is taken, so that the
    plain passes meet a kept one; else the first in that order, whose
    rebuild shows whether the program should have kept one."""
    from perfbench.reference import refine
    calls = []
    for rec in run.completed():
        cap = rec.get("capture")
        if cap and os.path.isdir(cap):
            calls += [(rec, f) for f in sorted(os.listdir(cap))
                      if f.startswith("gotoh-") and f.endswith(".npz")]
    if not calls:
        return None
    rng = np.random.default_rng([int(seed) % (1 << 63), 20])
    first = None
    for k in rng.permutation(len(calls)).tolist():
        rec, name = calls[k]
        with np.load(os.path.join(rec["capture"], name)) as z:
            r = {key: z[key] for key in z.files}
        found = _job_msa(rec, r)
        pick = (rec["job"], name, r, found)
        first = first or pick
        if found is not None and _differing(
                found[0], refine.drop_gap_columns(_star(r, found[1]))):
            return pick
    return first


def check(state, run, readings):
    from perfbench import capture
    ctx, base = state["ctx"], state["base"]
    t0 = time.perf_counter()
    cov = stage = dp = ref_bad = 0
    n_rows = n_windows = n_members = n_ref = 0
    refused, extra = [], {}
    spent = dict.fromkeys(("coverage", "stage_a", "gotoh", "refine"), 0.0)
    t = time.perf_counter()
    choice = _refine_choice(ctx.seed, run)
    spent["refine"] += time.perf_counter() - t

    def add(key, v):
        extra[key] = extra.get(key, 0) + v

    for rec in run.completed():
        t = time.perf_counter()
        differ, rows, more = base._coverage_rows(state, rec, control=readings)
        spent["coverage"] += time.perf_counter() - t
        for k, v in more.items():
            add(k, v)
        job_bad = differ
        cov += differ
        n_rows += rows
        if rec["capture"] is not None:
            size = capture.cost(rec["capture"])
            ctx.log("job %d: the capture took %.3f s summed over the "
                    "workers and kept %d bytes" % (rec["job"], *size))
            t = time.perf_counter()
            msas = base._msa_masks(rec["res"])
            a_recs, g_recs = capture.load(rec["capture"])
            s_bad, s_n, s_ctl = base._stage_a_differing(
                state, rec, msas, a_recs, control=readings)
            spent["stage_a"] += time.perf_counter() - t
            if readings:
                add("control.stage_a_windows_differing", s_ctl)
            t = time.perf_counter()
            n_multi = sum(m.shape[0] > 1 for m in msas.values())
            g_bad, g_n, g_fault = _gotoh_differing(state, rec, g_recs,
                                                   n_multi, fault=readings)
            spent["gotoh"] += time.perf_counter() - t
            if readings:
                add("fault.gotoh_members_differing", g_fault)
            stage += s_bad
            dp += g_bad
            n_windows += s_n
            n_members += g_n
            job_bad += s_bad + g_bad
            if choice is not None and choice[0] == rec["job"]:
                t = time.perf_counter()
                r_bad, n_ref, r_fault, kept = _refine_differing(
                    state, choice, fault=readings)
                spent["refine"] += time.perf_counter() - t
                ctx.log("job %d: the polish of %s rebuilt: %d rows, %d "
                        "differing, %d passes kept by the plain polish" % (
                            rec["job"], choice[1], n_ref, r_bad, kept))
                if readings:
                    add("fault.refine_rows_differing", r_fault)
                ref_bad += r_bad
                job_bad += r_bad
        if job_bad:
            refused.append(rec["job"])
        shutil.rmtree(os.path.dirname(rec["res"]), ignore_errors=True)
    checks = {"coverage_rows_differing": {"value": cov, "limit": 0}}
    if ctx.traffic.get("capture"):
        if choice is None and run.completed():
            ref_bad += 1          # no recorded DP call: nothing rebuilt
        checks["stage_a_windows_differing"] = {"value": stage, "limit": 0}
        checks["gotoh_members_differing"] = {"value": dp, "limit": 0}
        checks["refine_rows_differing"] = {"value": ref_bad, "limit": 0}
    ctx.log("check: %d coverage rows, %d Stage-A windows, %d center-star "
            "members, %d refined rows compared in %.1f s (%s)" % (
                n_rows, n_windows, n_members, n_ref,
                time.perf_counter() - t0,
                ", ".join("%s %.1f s" % kv for kv in spent.items())))
    done = run.completed()
    for rec in done:
        ctx.log("job %d: stages %s; backends %s" % (
            rec["job"], rec["timings_s"], rec["backends"]))
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
