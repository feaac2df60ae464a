"""The PyTorch port's host tool subcommands against the JAX package's CLI,
on the CPU: same seeded inputs, byte-identical output files and stdout.

Each pair of runs writes into the same path, one after the other (some
outputs embed their own path), and the whole directory is compared."""

import os
import shutil

import numpy as np
import pytest

from multiprime_tpu.cli import main as jcli
from multiprime_tpu_torch.cli import main as tcli


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _both(tmp_path, capsys, setup, argv):
    """Runs argv(work) through the JAX CLI, then the port's, each in a fresh
    `work` directory that setup(work) filled; -> (JAX tree, port tree,
    JAX stdout, port stdout)."""
    work = tmp_path / "work"
    trees, outs = [], []
    for cli in (jcli, tcli):
        if work.exists():
            shutil.rmtree(work)
        work.mkdir()
        setup(work)
        capsys.readouterr()
        rc = cli.main(argv(work))
        assert rc in (0, None), rc
        if cli is tcli:
            assert rc == 0
        outs.append(capsys.readouterr().out)
        trees.append(_tree(work))
    return trees[0], trees[1], outs[0], outs[1]


def _assert_same(tmp_path, capsys, setup, argv, min_files=2):
    want, got, want_out, got_out = _both(tmp_path, capsys, setup, argv)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    assert got_out == want_out
    assert len(want) >= min_files
    return want


def _random_seqs(rng, n, lo, hi, letters="ACGT"):
    lut = np.array(list(letters))
    return ["".join(rng.choice(lut, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def _rc(s):
    from multiprime_tpu_torch.utils import iupac
    return iupac.rc(s)


# ---------------------------------------------------------------------------
# solve, findimer
# ---------------------------------------------------------------------------

def _candidate_rows(rng, n_clusters=7, poison_all_last=False):
    """candidate_primers_sets.txt rows, 2-5 pairs a cluster; pairs whose 3'
    end is the reverse complement of cluster 0's F make certain dimers
    (the construction of tests/test_shadow_tools.py)."""
    lut = np.array(list("ACGT"))

    def mk():
        return "".join(rng.choice(lut, size=18))
    ac = np.array(list("AC"))
    poison = "".join(rng.choice(ac, size=18))
    poison_r = "".join(rng.choice(ac, size=18))
    rows = []
    for c in range(n_clusters):
        n_pairs = 2 if c == 0 else \
            5 if c == n_clusters - 1 else int(rng.integers(3, 5))
        fields = ["Cluster_%d_%d.txt" % (c, 100 + c)]
        for k in range(n_pairs):
            f, r = mk(), mk()
            if c == 0 and k == 0:
                f, r = poison, poison_r
            if c > 0 and (k == 0 or
                          (poison_all_last and c == n_clusters - 1)):
                f = mk()[:9] + _rc(poison[9:])
            fields += [f, r, "%d:%.2f:%.3f" % (150 + 10 * c, 50 + k, 0.9),
                       str(400 - 5 * k), "%d:%d" % (100 + k, 300 + k)]
        rows.append("\t".join(fields))
    return rows


@pytest.mark.parametrize("method", ["T", "M"])
def test_solve_equals_jax(tmp_path, capsys, method):
    rows = _candidate_rows(np.random.default_rng(31),
                           poison_all_last=method == "T")

    def setup(d):
        (d / "cand.txt").write_text("\n".join(rows) + "\n")
    tree = _assert_same(tmp_path, capsys, setup, lambda d: [
        "solve", "-i", str(d / "cand.txt"), "-m", method, "-o",
        str(d / "final.xls")], min_files=3)
    assert tree["final.xls"].count(b"\n") > 2
    if method == "T":
        assert tree["fina.next.xls"]            # str.rstrip(".xls") quirk


def test_findimer_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(41)
    prims = _random_seqs(rng, 14, 18, 18)
    prims[3] = prims[3][:10] + _rc(prims[0][2:10])       # planted dimer
    prims[7] = "GGTAYGGYYTCAGRCATC"                       # degenerate
    text = "".join(">Cluster_%d_F\n%s\n" % (i, s) for i, s in enumerate(prims))

    def setup(d):
        (d / "set.fa").write_text(text)
    tree = _assert_same(tmp_path, capsys, setup, lambda d: [
        "findimer", "-i", str(d / "set.fa"), "-t", "3.96", "-o",
        str(d / "out")], min_files=3)
    assert tree["out"].count(b"\n") > 1


# ---------------------------------------------------------------------------
# pcr, seq-format
# ---------------------------------------------------------------------------

F1, R1 = "GGTAYGGYYTCAGRCATC", "CRACRTATTTCTCDAGGT"
F2, R2 = "ACGTACGTACGTACGTAA", "TTGGCCAATTGGCCAATT"


def _pcr_targets():
    """Targets with planted products of two degenerate pairs, some holding
    both (the input of tests/test_shadow_tools.py's pcr_case)."""
    from multiprime_tpu_torch.utils import iupac
    rng = np.random.default_rng(11)
    seqs = _random_seqs(rng, 12, 400, 700)
    for i in range(8):
        s = seqs[i]
        seqs[i] = (s[:50] + iupac.expand(F1)[i % 4] + s[68:250]
                   + iupac.rc(iupac.expand(R1)[(i * 3) % 8]) + s[268:])
    for i in range(6, 10):
        s = seqs[i]
        seqs[i] = s[:300] + F2 + s[318:380] + iupac.rc(R2) + s[398:]
    return "".join(">seq%d\n%s\n" % (i, s) for i, s in enumerate(seqs))


@pytest.mark.parametrize("fmt", ["fa", "xls", "seq"])
def test_pcr_equals_jax(tmp_path, capsys, fmt):
    targets = _pcr_targets()
    inputs = {
        "fa": ">Cluster_7.fa_50_F\n%s\n>Cluster_7.fa_268_R\n%s\n"
              ">Cluster_9_300_F\n%s\n>Cluster_9_398_R\n%s\n"
              % (F1, R1, F2, R2),
        "xls": "#Primer\tPrimer_rank\tPrimer_F\tPrimer_R\tx\ty\tz\n"
               "Clusters/Cluster_7.fa\t1\t%s\t%s\t186:50:0.9\t200\t50:268\n"
               "Clusters/Cluster_9.fa\t1\t%s\t%s\t98:50:0.9\t80\t300:398\n"
               "Clusters/Cluster_11.fa\n" % (F1, R1, F2, R2)}

    def setup(d):
        (d / "targets.fa").write_text(targets)
        if fmt != "seq":
            (d / ("pairs." + fmt)).write_text(inputs[fmt])
    tree = _assert_same(tmp_path, capsys, setup, lambda d: [
        "pcr", "-i", "%s,%s" % (F1, R1) if fmt == "seq"
        else str(d / ("pairs." + fmt)), "-r", str(d / "targets.fa"),
        "-f", fmt, "-o", str(d / "products"), "-s", str(d / "cov.xls")],
        min_files=4)
    assert any(k.startswith("products/") and v for k, v in tree.items())


def test_seq_format_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    seqs = _random_seqs(rng, 30, 100, 400, letters="ACGTacgtNRY")
    seqs[4] = "GC" * 150                                  # GC-rich: dropped
    text = "".join(">s%d desc %d\n%s\n" % (i, i, s) for i, s in enumerate(seqs))

    def setup(d):
        (d / "in.fa").write_text(text)
    _assert_same(tmp_path, capsys, setup, lambda d: [
        "seq-format", "-i", str(d / "in.fa"), "-o", str(d / "out.fa"),
        "-g", "0.7", "-l", "200"])


# ---------------------------------------------------------------------------
# tm, tm-primer3, dg, expand, kmer-filter
# ---------------------------------------------------------------------------

def _primer_fa(d, seed=9):
    rng = np.random.default_rng(seed)
    prims = _random_seqs(rng, 30, 14, 26)
    prims += ["GGTAYGGYYTCAGRCATC", "ACGTACGT", "ATTA", "TGCA"]
    (d / "p.fa").write_text("".join(">p%d\n%s\n" % (i, s)
                                    for i, s in enumerate(prims)))


@pytest.mark.parametrize("fmt", ["fa", "seq"])
def test_tm_equals_jax(tmp_path, capsys, fmt):
    _assert_same(tmp_path, capsys, _primer_fa, lambda d: [
        "tm", "-i", str(d / "p.fa") if fmt == "fa" else "GGTAYGGYYTCAGRCATC",
        "-f", fmt, "-c", "100", "-m", "50", "-d", "1.5", "-n", "0.25", "-o",
        str(d / "tm.xls")])


@pytest.mark.parametrize("expand", [False, True])
def test_tm_primer3_equals_jax(tmp_path, capsys, expand):
    _assert_same(tmp_path, capsys, _primer_fa, lambda d: [
        "tm-primer3", "-i", str(d / "p.fa"), "-o", str(d / "tm.xls")]
        + (["--expand"] if expand else []))


@pytest.mark.parametrize("gini", ["unified", "H_bonds"])
def test_dg_equals_jax(tmp_path, capsys, gini):
    _assert_same(tmp_path, capsys, _primer_fa, lambda d: [
        "dg", "-i", str(d / "p.fa"), "-f", "fa", "-g", gini, "-o",
        str(d / "dg.xls")])


def test_expand_equals_jax(tmp_path, capsys):
    def setup(d):
        (d / "in.fa").write_text(">P1\nGGTAYGGYYTCAGRCATC\n>P2\nACGT\n"
                                 ">P3\nNNAC\n>P4.v2\nAWSMK\n")
    tree = _assert_same(tmp_path, capsys, setup, lambda d: [
        "expand", "-i", str(d / "in.fa"), "-o", str(d / "out.fa")])
    assert tree["out.fa"].count(b">") == 16 + 1 + 16 + 16


def test_kmer_filter_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(5)
    kmers = _random_seqs(rng, 120, 18, 19)
    kmers += ["ACACACACACGTACGTAA", "AAAATTTTACGTACGTAC",
              "ACGTACGTACGTAGCGCC", "GGGGGGGGGGGGGGGGGG",
              "ATATATATATATATATAT", F1, R1, "A" * 18]

    def setup(d):
        (d / "k.fa").write_text("".join(">k%d\n%s\n" % (i, s)
                                        for i, s in enumerate(kmers)))
    tree = _assert_same(tmp_path, capsys, setup, lambda d: [
        "kmer-filter", "-i", str(d / "k.fa"), "-g", "0.2,0.7", "-o",
        str(d / "out.fa")])
    assert tree["out.fa"].count(b">") > 10


# ---------------------------------------------------------------------------
# ont, roc, build-native
# ---------------------------------------------------------------------------

def _ont_inputs(d):
    """Primer fasta + fq reads with distinct pair counts, mutated ends and
    a read of no primer."""
    from multiprime_tpu_torch.utils import iupac
    rng = np.random.default_rng(21)
    pa, pb = "GGTAYGGYYTCAGACATC", "ACGTTGCCAATTGGCTGA"
    (d / "primers.fa").write_text(">PA\n%s\n>PB\n%s\n" % (pa, pb))
    pa1 = iupac.expand(pa)[1]
    pb_mut = pb[:5] + ("A" if pb[5] != "A" else "C") + pb[6:]

    def mid(n):
        return "".join(rng.choice(np.array(list("ACGT")), size=n))
    reads = ([pa1 + mid(60) + iupac.rc(pb)] * 4
             + [pa1 + mid(40) + iupac.rc(pa1)] * 2
             + [pb_mut + mid(50) + iupac.rc(pa1)] * 3 + [mid(90)])
    (d / "reads.fq").write_text("".join("@r%d\n%s\n+\n%s\n" % (
        i, s, "I" * len(s)) for i, s in enumerate(reads)))


@pytest.mark.parametrize("metric", ["difflib", "banded"])
@pytest.mark.parametrize("variant", [False, True])
def test_ont_equals_jax(tmp_path, capsys, metric, variant):
    tree = _assert_same(tmp_path, capsys, _ont_inputs, lambda d: [
        "ont", "-i", str(d / "reads.fq"), "-s", str(d / "primers.fa"),
        "-l", "18", "-m", "0.6", "-f", "fq", "--metric", metric, "-o",
        str(d / "out")] + (["--variant"] if variant else []), min_files=4)
    assert tree["out.num"].count(b"\n") > 2


def test_roc_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(17)
    real = rng.integers(0, 2, size=60)
    pred = np.clip(real * 0.6 + rng.random(60) * 0.5, 0, 1)

    def setup(d):
        (d / "roc.csv").write_text("sample,real,predict\n" + "".join(
            "s%d,%d,%.3f\n" % (i, r, p)
            for i, (r, p) in enumerate(zip(real, pred))))
    tree = _assert_same(tmp_path, capsys, setup, lambda d: [
        "roc", "-i", str(d / "roc.csv"), "-o", str(d / "roc.tsv")])
    assert tree["roc.tsv"].startswith(b"metric\tvalue\nacc\t")


def test_build_native_prints_the_ports_library(capsys):
    from multiprime_tpu_torch import native
    assert tcli.main(["build-native"]) == 0
    out = capsys.readouterr().out
    assert out == "native runtime ready: %s\n" % native._SO
    assert os.path.dirname(native._SO).endswith(
        os.path.join("multiprime_tpu_torch", "native"))
    assert os.path.exists(native._SO)
