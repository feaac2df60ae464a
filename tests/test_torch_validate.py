"""The PyTorch port's device-scan entry points that are not `scan` itself
(`specificity`, `update`, `nondimer-filter`, `onestep` and the solver's
off-target screen) against the JAX package's, on the CPU: same seeded
inputs, byte-identical output files, each pair of runs in one process (the
dimer report of `update` follows set order, which the hash seed fixes)."""

import functools
import os
import shutil

import numpy as np
import pytest

from multiprime_tpu.cli import main as jcli
from multiprime_tpu.solve import maxset as jmaxset
from multiprime_tpu.validate import scan as jscan
from multiprime_tpu_torch.cli import main as tcli
from multiprime_tpu_torch.solve import maxset as tmaxset
from multiprime_tpu_torch.utils import iupac
from multiprime_tpu_torch.validate import scan as tscan

LUT = np.array(list("ACGT"))


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_tree(tmp_path, setup, argv, jax_extra=(), torch_extra=()):
    """argv(work) through the JAX CLI, then the port's with --device cpu,
    each into a fresh `work` (outputs may embed their path) that
    setup(work) filled; asserts the two trees are byte-identical and
    returns the port's."""
    work = tmp_path / "work"
    trees = []
    for cli, extra in ((jcli, list(jax_extra)),
                       (tcli, ["--device", "cpu"] + list(torch_extra))):
        if work.exists():
            shutil.rmtree(work)
        work.mkdir()
        setup(work)
        assert cli.main(argv(work) + extra) in (0, None)
        trees.append(_tree(work))
    want, got = trees
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    return got


def _seq(rng, n):
    return "".join(rng.choice(LUT, size=n))


def _sub(rng, s, k):
    """s with k substitutions outside its last 4 bases."""
    s = list(s)
    for at in rng.choice(len(s) - 4, size=k, replace=False):
        s[at] = str(rng.choice([c for c in "ACGT" if c != s[at]]))
    return "".join(s)


# ---------------------------------------------------------------------------
# specificity: targets longer than the segment length
# ---------------------------------------------------------------------------

SEG_LEN = 600            # stride 600 - 17 = 583 for 18-mers


@pytest.fixture(scope="module")
def background():
    """Four degenerate primer pairs and a background of six sequences of
    1.5-3 kb: amplicons planted with 0-1 substitutions outside the 3'
    terminal 4 bases, several straddling a multiple of the segment stride;
    in the last, a lone F site ahead of an amplicon (the reference join's
    early exit abandons that sequence)."""
    rng = np.random.default_rng(29)
    prims = []
    for _ in range(8):
        p = list(_seq(rng, 18))
        for at in rng.choice(14, size=2, replace=False):
            p[at] = str(rng.choice(list("RYKM")))
        prims.append("".join(p))
    genomes = [list(_seq(rng, int(rng.integers(1500, 3001))))
               for _ in range(5)]
    stride = SEG_LEN - 17

    def plant(g, at, s):
        genomes[g][at:at + len(s)] = s

    sites = []
    for k in range(14):
        g = k % 5
        pair = k % 4
        f = _sub(rng, iupac.expand(prims[2 * pair])[k % 4], k % 2)
        r = iupac.rc(_sub(rng, iupac.expand(prims[2 * pair + 1])[0],
                          (k // 2) % 2))
        if k < 6:           # F straddles a stride multiple
            at = stride * (1 + k % 2) - 9
        else:
            at = int(rng.integers(0, len(genomes[g]) - 1400))
        gap = int(rng.integers(150, 900))
        if at + gap + 18 > len(genomes[g]):
            continue
        plant(g, at, f)
        plant(g, at + gap, r)
        sites.append((g, at))
    # bg5: a lone F site 1.7 kb ahead of an amplicon (early-exit bait)
    genomes.append(list(_seq(rng, 3000)))
    plant(5, 20, iupac.expand(prims[0])[0])
    plant(5, 1800, iupac.expand(prims[0])[1])
    plant(5, 2200, iupac.rc(iupac.expand(prims[1])[0]))
    bg = "".join(">bg%d chr%d\n%s\n" % (i, i, "".join(s))
                 for i, s in enumerate(genomes))
    fa = "".join(">P%d_%s\n%s\n" % (i // 2, "FR"[i % 2], p)
                 for i, p in enumerate(prims))
    return fa, bg, sites


@pytest.mark.parametrize("exhaustive", [False, True])
def test_specificity_equals_jax(tmp_path, monkeypatch, background,
                                exhaustive):
    """Both packages' specificity CLI with their scans' seg_len cut to 600
    bases, so every background sequence is scanned as overlapping
    segments."""
    for mod in (jscan, tscan):
        monkeypatch.setattr(mod, "ScanParams", functools.partial(
            mod.ScanParams, seg_len=SEG_LEN))
    fa, bg, sites = background

    def setup(d):
        (d / "primers.fa").write_text(fa)
        (d / "bg.fa").write_text(bg)
    tree = _same_tree(tmp_path, setup, lambda d: [
        "specificity", "-i", str(d / "primers.fa"), "-r", str(d / "bg.fa"),
        "-l", "18", "-t", "4", "-m", "1", "-s", "100,1500", "-o",
        str(d / "spec.out")] + (["--exhaustive-join"] if exhaustive else []))
    assert sorted(tree) == ["bg.fa", "primers.fa", "primers.term.fa",
                            "spec.out", "spec.out.pair.num",
                            "spec.out.total.acc.num"]
    rows = [line.split("\t") for line in
            tree["spec.out"].decode().splitlines()[1:]]
    found = {(int(r[0][2:]), int(r[1])) for r in rows}
    stride = SEG_LEN - 17
    straddling = [s for s in sites if s[1] % stride > stride - 18]
    assert len(set(straddling) & found) >= 4
    if exhaustive:
        assert set(straddling) <= found
    assert any(r[0] == "bg5" for r in rows) == exhaustive
    assert len(found) >= len(sites) - 3


# ---------------------------------------------------------------------------
# update, nondimer-filter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def update_inputs():
    """A core set and a new set with cross-dimers (a new primer's 3' end is
    the reverse complement of a core primer's), one shared primer, and a
    reference DB where core F x new R, new F x core R and new F x new R
    amplify."""
    rng = np.random.default_rng(37)
    core = [_seq(rng, 18) for _ in range(6)]
    new = [_seq(rng, 18) for _ in range(6)]
    new[1] = "TTGATG" + iupac.rc(core[0])[:12]
    new[3] = new[3][:9] + "R" + new[3][10:]
    new[5] = core[2]                                   # shared: name|name
    ref = []
    for k in range(8):
        s = list(_seq(rng, 900))
        f = [core[0], new[0], new[2], core[2]][k % 4]
        r = [new[1], core[1], new[3], new[5]][k % 4]
        s[60:78] = iupac.expand(f)[0]
        s[60 + 300 + 20 * k:78 + 300 + 20 * k] = iupac.rc(iupac.expand(r)[0])
        ref.append("".join(s))
    core_fa = "".join(">C%d_%s\n%s\n" % (i // 2, "FR"[i % 2], p)
                      for i, p in enumerate(core))
    new_fa = "".join(">N%d_%s\n%s\n" % (i // 2, "FR"[i % 2], p)
                     for i, p in enumerate(new))
    ref_fa = "".join(">t%d\n%s\n" % (i, s) for i, s in enumerate(ref))
    return core_fa, new_fa, ref_fa


def _update_setup(inputs):
    core_fa, new_fa, ref_fa = inputs

    def setup(d):
        (d / "core").mkdir()
        (d / "new").mkdir()
        (d / "core" / "core.fa").write_text(core_fa)
        (d / "new" / "new.fa").write_text(new_fa)
        (d / "ref.fa").write_text(ref_fa)
    return setup


@pytest.mark.parametrize("func", ["D", "O", "DO"])
def test_update_equals_jax(tmp_path, update_inputs, func):
    tree = _same_tree(tmp_path, _update_setup(update_inputs), lambda d: [
        "update", "-i", str(d / "new" / "new.fa"), "-c",
        str(d / "core" / "core.fa"), "-r", str(d / "ref.fa"), "-f", func,
        "-o", str(d / "upd")])
    if "D" in func:
        assert tree["upd.dimer"].count(b"\n") > 1
    if "O" in func:
        assert tree["upd.offtargets"].count(b"\n") >= 7
        assert "new/new.term.fa" in tree and "core/core.term.fa" in tree


def test_nondimer_filter_equals_jax(tmp_path, update_inputs):
    """Host code (no --device): the port's filter keeps the JAX filter's
    primers."""
    core_fa, new_fa, _ = update_inputs
    trees = []
    for cli in (jcli, tcli):
        d = tmp_path / ("jax" if cli is jcli else "torch")
        d.mkdir()
        (d / "new.fa").write_text(new_fa)
        (d / "pool.fa").write_text(core_fa)
        assert cli.main(["nondimer-filter", "-i", str(d / "new.fa"), "-p",
                         str(d / "pool.fa"), "-o", str(d / "clean.fa")]) == 0
        trees.append(_tree(d))
    assert trees[0] == trees[1]
    assert 0 < trees[1]["clean.fa"].count(b">") < 6


# ---------------------------------------------------------------------------
# onestep
# ---------------------------------------------------------------------------

def test_onestep_equals_jax(tmp_path):
    """The small_cluster input of tests/test_onestep_cli.py: design, pair
    and the coverage scan, every file byte-identical."""
    rng = np.random.default_rng(11)
    base = "".join(rng.choice(list("ACGT"), size=400))
    seqs = []
    for _ in range(8):
        s = list(base)
        for _ in range(4):
            s[int(rng.integers(len(s)))] = str(rng.choice(list("ACGT")))
        seqs.append("".join(s))
    text = "".join(">seq%d\n%s\n" % (i, s) for i, s in enumerate(seqs))

    def setup(d):
        (d / "c.tmsa").write_text(text)
        (d / "c.tfa").write_text(text)
    tree = _same_tree(tmp_path, setup, lambda d: [
        "onestep", "-i", str(d / "c.tmsa"), "-r", str(d / "c.tfa"), "-s",
        "100,300", "-f", "0.6", "--out1", str(d / "d.top.primer.out"), "-o",
        str(d / "d.candidate.txt")])
    assert b"total coverage of primer set (PS) is: 8" in \
        tree["d.candidate_target.total.acc.num"]


@pytest.mark.parametrize("devices", ["2", "0"])
def test_onestep_devices_other_than_one_raise(tmp_path, devices):
    with pytest.raises(NotImplementedError, match="parallel/mesh.py"):
        tcli.main(["onestep", "-i", "x", "-r", "y", "--devices", devices,
                   "--out1", str(tmp_path / "o1"), "-o",
                   str(tmp_path / "o2"), "--device", "cpu"])
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# solve with the in-loop off-target screen
# ---------------------------------------------------------------------------

def test_greedy_maximal_with_offtarget_equals_jax(tmp_path, monkeypatch):
    """Pairs of three clusters; the background amplifies some of them, so
    the screen rejects those and takes the next pair.  The port uploads the
    background once for all pairs."""
    rng = np.random.default_rng(5)
    rows, bg = [], []
    for c in range(3):
        fields = ["Cluster_%d_10.txt" % c]
        for k in range(3):
            f, r = _seq(rng, 18), _seq(rng, 18)
            if k < 2 and c != 1:
                bg.append(_seq(rng, 40) + f + _seq(rng, 150) + iupac.rc(r)
                          + _seq(rng, 40))
            fields += [f, r, "186:50:0.9", "9", "%d:%d" % (10 * k, 200)]
        rows.append(fields)
    bg_fa = tmp_path / "bg.fa"
    bg_fa.write_text("".join(">bg%d\n%s\n" % (i, s) for i, s in enumerate(bg)))
    cached = []
    real = tscan.scan_hits

    def counting(targets, patterns, params, device="cuda"):
        out = real(targets, patterns, params, device)
        cached.append(len(params.corpus_cache))
        return out
    monkeypatch.setattr(tscan, "scan_hits", counting)
    got_rows = [list(r) for r in rows]
    want = jmaxset.greedy_maximal_with_offtarget(
        rows, str(tmp_path / "j.xls"), str(tmp_path / "j.next"), str(bg_fa))
    got = tmaxset.greedy_maximal_with_offtarget(
        got_rows, str(tmp_path / "t.xls"), str(tmp_path / "t.next"),
        str(bg_fa), device="cpu")
    assert got == want
    for a, b in (("j.xls", "t.xls"), ("j.next", "t.next")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    ranks = [c.get("Primer_rank") for c in got]
    assert ranks == ["11", "1", "11"]
    assert len(cached) > 2 and set(cached) == {1}
