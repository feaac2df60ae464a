"""The PyTorch port's coverage validation and pipeline against the JAX
package's, on the CPU: same inputs, byte-identical output files."""

import os
import pickle

import numpy as np
import pytest
import torch

from multiprime_tpu.pipeline import driver as jdriver
from multiprime_tpu.utils import iupac
from multiprime_tpu.validate import scan as jscan
from multiprime_tpu_torch.cli import main as tcli
from multiprime_tpu_torch.pipeline import driver as tdriver
from multiprime_tpu_torch.utils import link as tlink
from multiprime_tpu_torch.validate import scan as tscan

SCAN_SUFFIXES = ("", ".pair.num", ".total.acc.num", ".unmatched.fa")


def _same_files(a, b, suffixes=SCAN_SUFFIXES):
    for suffix in suffixes:
        assert os.path.exists(a + suffix) == os.path.exists(b + suffix), suffix
        if os.path.exists(a + suffix):
            with open(a + suffix, "rb") as fa, open(b + suffix, "rb") as fb:
                assert fa.read() == fb.read(), suffix


def _degenerate(rng, n, plen, letters="ACGTRYMKSW"):
    lut = np.array(list(letters))
    weights = np.array([10.0] * 4 + [1.0] * (len(letters) - 4))
    return ["".join(rng.choice(lut, size=plen, p=weights / weights.sum()))
            for _ in range(n)]


@pytest.fixture(scope="module")
def scan_inputs(tmp_path_factory):
    """Degenerate primer pairs planted as F and reverse-complement R sites
    (exact and one-mismatch copies) in 900 bp targets, a 5 kb target for
    the segmented scan, and the targets dict of the unmatched records."""
    rng = np.random.default_rng(5)
    lut = np.array(list("ACGT"))
    pats = _degenerate(rng, 6, 18)
    genomes = []
    for g in range(10):
        genome = list("".join(rng.choice(lut, size=900)))
        pair = g % 4
        if pair < 3:
            f = iupac.expand(pats[2 * pair])[0]
            r = iupac.expand(pats[2 * pair + 1])[0]
            genome[100:118] = f
            genome[500:518] = iupac.rc(r)
            f2 = list(f)
            f2[4] = "A" if f2[4] != "A" else "C"
            genome[300:318] = f2
        genomes.append("".join(genome))
    genome = list("".join(rng.choice(lut, size=5000)))
    genome[590:608] = iupac.expand(pats[0])[0]
    genome[1190:1208] = iupac.rc(iupac.expand(pats[1])[0])
    genomes.append("".join(genome) + "NNNNacgtRY")
    root = tmp_path_factory.mktemp("scan_inputs")
    prim = root / "p.fa"
    prim.write_text("".join(">P%d_%s\n%s\n" % (i // 2, "FR"[i % 2], p)
                            for i, p in enumerate(pats)))
    ref = root / "g.fa"
    ref.write_text("".join(">g%d\n%s\n" % (i, s)
                           for i, s in enumerate(genomes)))
    targets = {"g%d" % i: ">g%d\n%s\n" % (i, s)
               for i, s in enumerate(genomes)}
    return prim.read_text(), str(ref), targets


def _run_scan(mod, tmp_path, name, scan_inputs, backend, **kw):
    primers, ref, targets = scan_inputs
    d = tmp_path / name
    d.mkdir()
    prim = d / "p.fa"
    prim.write_text(primers)
    params = mod.ScanParams(term_len=0, term=4, mm=1, backend=backend,
                            product_size=(100, 1500), **kw)
    out = str(d / "o.out")
    extra = {"device": "cpu"} if mod is tscan else {}
    rows = mod.run(str(prim), ref, out, params, targets, **extra)
    return out, rows


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_scan_run_outputs_equal_jax(tmp_path, scan_inputs, backend):
    want, rows = _run_scan(jscan, tmp_path, "jax", scan_inputs, "numpy")
    got, _ = _run_scan(tscan, tmp_path, "torch", scan_inputs, backend)
    assert len(rows) >= 8
    _same_files(want, got, SCAN_SUFFIXES + (".term.fa",))
    _same_files(str(tmp_path / "jax" / "p.term.fa"),
                str(tmp_path / "torch" / "p.term.fa"), ("",))
    assert tscan.LAST_BACKEND == ("host" if backend == "numpy" else "device")


def test_scan_run_segmented_equals_jax(tmp_path, scan_inputs):
    """scan_hits_long with a small seg_len: the 5 kb target is cut into
    overlapping segments, its boundary-spanning plants still found."""
    want, _ = _run_scan(jscan, tmp_path, "jax", scan_inputs, "conv",
                        seg_len=600)
    got, rows = _run_scan(tscan, tmp_path, "torch", scan_inputs, "device",
                          seg_len=600)
    _same_files(want, got)
    assert any(r[0] == "g10" and r[1] == 590 for r in rows)


def test_scan_hits_retry_and_mixed_lengths():
    """Hits beyond the first per-batch cap (2**17) drive the retry loop;
    mixed-length pattern sets scan per length group."""
    dense = ["A" * 1000] * 20
    pats = ["A" * 18] + ["A" * k + "C" + "A" * (17 - k) for k in range(7)]
    params = dict(mm=1, term=1, want_mism=True)
    got = tscan.scan_hits(dense, pats, tscan.ScanParams(backend="device",
                                                        **params), "cpu")
    want = jscan.scan_hits(dense, pats, jscan.ScanParams(backend="numpy",
                                                         **params))
    assert len(got) > 1 << 17 and got == want
    seqs = ["ACGTACGTACGTACGTACGTACGT" * 4]
    mixed = ["ACGTACGT", "ACGTACGTACGT"]
    got = tscan.scan_hits(seqs, mixed, tscan.ScanParams(mm=0, term=2),
                          "cpu")
    assert got == jscan.scan_hits(seqs, mixed,
                                  jscan.ScanParams(mm=0, term=2,
                                                   backend="numpy"))
    assert {p for _, _, p, _ in got} == {0, 1}


def test_scan_backend_policy(monkeypatch):
    monkeypatch.delenv("MPTPU_FORCE_BACKEND", raising=False)
    assert tscan._resolve_backend("auto") == "device"
    for name in ("device", "conv", "pallas"):
        assert tscan._resolve_backend(name) == "device"
    assert tscan._resolve_backend("numpy") == "numpy"
    monkeypatch.setenv("MPTPU_FORCE_BACKEND", "host")
    assert tscan._resolve_backend("auto") == "numpy"
    with pytest.raises(ValueError, match="unknown scan backend"):
        tscan._resolve_backend("bowtie")


def test_scan_cli_equals_jax(tmp_path, scan_inputs):
    from multiprime_tpu.cli import main as jcli
    primers, ref, targets = scan_inputs
    outs = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        (d / "p.fa").write_text(primers)
        with open(d / "t.dict", "wb") as f:
            pickle.dump(targets, f)
        outs[name] = str(d / "o.out")
        assert cli.main(["scan", "-i", str(d / "p.fa"), "-r", ref, "-l", "18",
                         "-t", "1", "-m", "2", "-s", "50,2000", "-d",
                         str(d / "t.dict"), "-o", outs[name]] + extra) == 0
    _same_files(outs["jax"], outs["torch"])


def test_cli_unported_subcommands_exit_2(capsys):
    """Every subcommand is ported: the port's CLI dispatches each of the
    JAX package's subcommands to a function of its own, and only an
    unknown subcommand exits 2."""
    import importlib
    import re
    from multiprime_tpu.cli import main as jcli
    jax_cmds = set(re.findall(r'cmd == "([a-z0-9-]+)"',
                              open(jcli.__file__).read()))
    assert len(jax_cmds) == 22 and set(tcli.COMMANDS) == jax_cmds
    for cmd, (module, name) in tcli.COMMANDS.items():
        mod = tcli if module is None else importlib.import_module(
            "multiprime_tpu_torch.cli." + module)
        assert callable(getattr(mod, name)), cmd
    for cmd in ("solve", "pcr", "specificity", "tm"):
        with pytest.raises(SystemExit) as exc:         # argparse: no -o
            tcli.main([cmd, "-i", "x", "--nonsense"])
        assert exc.value.code == 2
        assert "not ported yet" not in capsys.readouterr().out
    assert tcli.main(["nonsense"]) == 2
    assert "unknown subcommand: nonsense" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (e) the whole `run` pipeline
# ---------------------------------------------------------------------------

def _three_families(path):
    """The three-family input of tests/test_cli_pipeline.py."""
    rng = np.random.default_rng(41)
    lut = np.array(list("ACGT"))
    bases = ["".join(rng.choice(lut, size=480)) for _ in range(3)]
    with open(path, "w") as f:
        for b, base in enumerate(bases):
            for i in range(8):
                s = list(base)
                for _ in range(6):
                    s[rng.integers(0, len(s))] = str(rng.choice(lut))
                f.write(">%c%d\n%s\n" % (65 + b, i, "".join(s)))


PIPE_KW = dict(virus_name="three", coverage=0.5, min_seq_length=100,
               product_size=(100, 400), algo="v20")


def _tree(root, skip=("pipeline_metrics.json",)):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.name not in skip}


def test_run_pipeline_tree_equals_jax(tmp_path):
    """Both pipelines write to the same path, one after the other (several
    outputs embed the results path), and every file but the timings is
    byte-identical; the port's scan went through the device path."""
    fa = tmp_path / "three.fa"
    _three_families(fa)
    res = tmp_path / "res"
    jdriver.run_pipeline(None, input_fa=str(fa), results_dir=str(res),
                         **PIPE_KW)
    os.rename(res, tmp_path / "res_jax")
    pipe, _ = tdriver.run_pipeline(None, input_fa=str(fa),
                                   results_dir=str(res), device="cpu",
                                   **PIPE_KW)
    want = _tree(tmp_path / "res_jax")
    got = _tree(res)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    assert any(r.startswith("Core_primers_set/BWT_coverage/") for r in got)
    backends = pipe._backends()
    assert backends["scan_backend"] == "device"
    assert backends["device"] == "cpu"


def test_cli_run_equals_jax_cli(tmp_path):
    """`run --device cpu` through the port's CLI writes the tree that
    `run` of the JAX package's CLI writes, with default settings."""
    from multiprime_tpu.cli import main as jcli
    fa = tmp_path / "three.fa"
    _three_families(fa)
    res = tmp_path / "res"
    flags = ["run", "-i", str(fa), "-r", str(res), "--coverage", "0.5"]
    assert jcli.main(flags) == 0
    os.rename(res, tmp_path / "res_jax")
    assert tcli.main(flags + ["--device", "cpu"]) == 0
    want = _tree(tmp_path / "res_jax")
    got = _tree(res)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
