"""The whole-genome cell on the CPU: its generator, its plain references
against the port and against the unblocked plain DP, and a tiny cut of
the cell run through the harness, ``correct`` with every check at 0 and
each fault reading non-zero (the kernels' plain versions stand in for the
card)."""

import io
import json
import os
import re
import time

import numpy as np
import pytest

from perfbench import harness, roofline_dp
from perfbench.generators import viral_genomes
from perfbench.reference import gotoh, gotoh_blocked, refine as pref


def _config():
    with open(os.path.join(harness.ROOT, "perfbench", "configs",
                           "kobuvirus-genome-panel.json")) as f:
        return json.load(f)


def test_genomes_are_deterministic_with_indels():
    # the configuration, with the singletons it cut
    cfg = dict(_config(), singletons=10)
    ids, rows = viral_genomes.generate(cfg, [2 ** 31 + 11, 1])
    ids2, rows2 = viral_genomes.generate(cfg, [2 ** 31 + 11, 1])
    assert ids == ids2 and all(np.array_equal(a, b)
                               for a, b in zip(rows, rows2))
    _, other = viral_genomes.generate(cfg, [2 ** 31 + 12, 1])
    assert not np.array_equal(rows[1], other[1])
    assert len(ids) == 2 * 500 + 10
    assert sum(i.startswith("S") for i in ids) == 10
    assert all(8200 <= len(r) <= 8400 for r in rows[-10:])
    for r in rows:
        assert set(np.unique(r).tolist()) <= set(b"ACGT")
    for fam in range(2):
        block = rows[fam * 500:(fam + 1) * 500]
        base = block[0]
        assert 8200 <= len(base) <= 8400
        # every tenth member an exact copy of the base
        assert all(np.array_equal(b, base) for b in block[::10])
        # the others carry indels: lengths move, about 8 of 1-12 bases a
        # member at 0.1% a base
        lens = np.array([len(b) for b in block])
        assert (lens != len(base)).mean() > 0.5
        assert np.abs(lens - len(base)).max() <= 12 * 30


def _family(seed, n, length, div, rate):
    params = dict(families=1, members=n, singletons=0,
                  length_range=[length, length + 20], divergences=[div],
                  copy_every=10, indel_rate=rate, indel_len_p=0.5,
                  indel_max=12)
    _, rows = viral_genomes.generate(params, [seed, 1])
    return [r.tobytes().decode("ascii") for r in rows]


def test_blocked_gotoh_equals_unblocked():
    """Exact ops in blocks of 3 members equal the plain DP of gotoh.py;
    every member's optimum score equals its ops' score."""
    seqs = _family(5, 14, 120, 0.1, 0.03)
    c = gotoh.encode(seqs[0])
    members = [gotoh.encode(s) for s in seqs[1:]] + [gotoh.encode("ACGTN")]
    want = gotoh.align(c, members, "cpu")
    per = (len(c) + 1) * (max(len(b) for b in members) + 1)
    got = gotoh_blocked.align(c, members, "cpu", ptr_bytes=3 * per)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    scores, ptr = gotoh_blocked.dp(c, members, "cpu", keep=[2, 5])
    assert ptr.shape[1] == 2
    assert all(np.array_equal(a, want[k]) for a, k in zip(
        gotoh_blocked.trace(ptr, len(c), [len(members[k]) for k in (2, 5)]),
        (2, 5)))
    assert [gotoh_blocked.ops_score(c, b, o)
            for b, o in zip(members, want)] == scores.tolist()
    altered = np.concatenate([[1, 2], want[0][1:]])
    assert gotoh_blocked.ops_score(c, members[0], altered) < scores[0]


def test_plain_refine_equals_the_port():
    """The plain merge equals the port's center-star MSA, and the plain
    polish (in blocks) equals the port's host refine_msa, which moves
    residues here."""
    from multiprime_tpu_torch.align import centerstar, refine
    seqs = _family(12345, 60, 300, 0.15, 0.03)
    ids = [str(k) for k in range(len(seqs))]
    _, msa = centerstar.center_star_msa(ids, seqs, backend="numpy",
                                        device="cpu")
    center = centerstar.pick_center(seqs)
    members = [s for k, s in enumerate(seqs) if k != center]
    ops = gotoh.align(gotoh.encode(seqs[center]),
                      [gotoh.encode(s) for s in members], "cpu")
    star = pref.merge(seqs[center].encode(), [s.encode() for s in members],
                      ops)
    mat = np.frombuffer("".join(msa).encode(), np.uint8).reshape(len(msa),
                                                                  -1)
    order = [center] + [k for k in range(len(seqs)) if k != center]
    assert np.array_equal(star, mat[order])
    want = refine.refine_msa(msa, 2)
    assert want != msa
    got, kept = pref.refine(mat, 2, "cpu",
                            ptr_bytes=(mat.shape[1] + 1) * 400 * 7)
    assert [r.tobytes().decode() for r in got] == want
    assert kept >= 1


def test_dp_bounds_count_the_cells():
    """chip_smoke.py's rates and counts: 20 int32 operations a Gotoh cell,
    7 fp32 a refine cell and 8 a column and member."""
    cells = 512 * 923 * 934
    assert roofline_dp.gotoh_bound_s(cells) == pytest.approx(
        20 * cells / (132 * 64 * 1.98e9))
    rc = 256 * 2917 * 924
    assert roofline_dp.refine_bound_s(rc, 256 * 2917) == pytest.approx(
        (7 * rc + 8 * 256 * 2917) / (132 * 128 * 1.98e9))


def _tiny_bench(tmp):
    """A benchmark of one tiny genome cell in ``tmp``: 1 family of 14
    genomes of 600-620 bases at 8% divergence and 3% indels, 2
    singletons, one worker."""
    base = os.path.join(tmp, "perfbench")
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = _config()
    # a gappier family than the cell's, at a size the CPU runs in seconds
    cfg.update(families=1, members=14, singletons=2,
               length_range=[600, 620], divergences=[0.08], indel_rate=0.03)
    cfg["settings"]["nproc"] = 1
    with open(os.path.join(harness.ROOT, "perfbench", "traffic",
                           "run-genome-jobs.json")) as f:
        traffic = dict(json.load(f), prepared_jobs=1)
    with open(os.path.join(base, "configs", "tiny-genome.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(base, "traffic", "tiny-genome.json"), "w") as f:
        json.dump(traffic, f)
    entry = next(c for c in bench["configs"]
                 if c["name"] == "kobuvirus-genome-panel")
    bench["configs"] = [dict(entry, name="tiny-genome",
                             file="perfbench/configs/tiny-genome.json")]
    cell = next(w for w in bench["workloads"] if w["name"] == "run.genome")
    bench["workloads"] = [dict(cell, name="tiny.genome", config="tiny-genome",
                               traffic="tiny-genome")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tiny.genome"] if "run.genome"
                              in m["workloads"] else [])
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path, base


def test_tiny_genome_cell_is_correct_and_its_faults_read(tmp_path, capfd):
    path, base = _tiny_bench(str(tmp_path))
    out, err = io.StringIO(), io.StringIO()
    result = harness.run_cell("tiny.genome", 2 ** 31 + 7, 0.0, True,
                              t_start=time.perf_counter(), bench_path=path,
                              search=[base], device="cpu", chip_check=False,
                              readings=True, out=out, err=err)
    assert result["correct"], err.getvalue()[-3000:]
    assert set(result["checks"]) == {
        "coverage_rows_differing", "stage_a_windows_differing",
        "gotoh_members_differing", "refine_rows_differing"}
    assert all(c["value"] == 0 for c in result["checks"].values())
    # the spans' metrics; the rooflines need CUDA events, none on the CPU
    assert {"genome.gotoh_s", "genome.refine_s"} <= set(result["metrics"])
    readings = json.loads(next(
        line for line in out.getvalue().splitlines()
        if line.startswith("READINGS "))[len("READINGS "):])
    for key in ("fault.gotoh_members_differing",
                "fault.refine_rows_differing",
                "control.coverage_rows_differing",
                "control.stage_a_windows_differing"):
        assert key in readings
    assert readings["fault.gotoh_members_differing"] > 0
    assert readings["fault.refine_rows_differing"] > 0
    # the rebuilt MSA is one the program polished: the plain polish kept a
    # pass there too
    logged = capfd.readouterr()
    assert re.search(r"rebuilt: \d+ rows, 0 differing, [1-9]\d* passes kept",
                     logged.out + logged.err)
