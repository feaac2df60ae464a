"""The PyTorch port's alternative backends against the JAX package's, on
the CPU: the DEGEPRIME-style WRC designer (`wrc`, `run-dege`), the
progressive MSA, the multiPrime2 global-optimum refinement (`--algo v2`),
and `run` trees with each of them."""

import os

import numpy as np
import pytest

from multiprime_tpu.align import progressive as jprog
from multiprime_tpu.cli import design as jdesign
from multiprime_tpu.cli import main as jcli
from multiprime_tpu.models import global_opt as jglobal
from multiprime_tpu.pipeline import driver as jdriver
from multiprime_tpu_torch.align import progressive as tprog
from multiprime_tpu_torch.cli import design as tdesign
from multiprime_tpu_torch.cli import main as tcli
from multiprime_tpu_torch.models import global_opt as tglobal
from multiprime_tpu_torch.pipeline import driver as tdriver

from .test_torch_pipeline import PIPE_KW, _three_families, _tree

LUT = np.array(list("ACGT"))


def _family(rng, n, length, subs, indels=0):
    """n members of one random base sequence, each with `subs` seeded
    substitutions and up to `indels` indels of 1-6 bases."""
    base = list(rng.choice(LUT, size=length))
    out = []
    for _ in range(n):
        s = list(base)
        for _ in range(subs):
            s[int(rng.integers(len(s)))] = str(rng.choice(LUT))
        for _ in range(int(rng.integers(0, indels + 1))):
            k = int(rng.integers(1, 7))
            at = int(rng.integers(10, len(s) - 10))
            if rng.random() < 0.5:
                del s[at:at + k]
            else:
                s[at:at] = list(rng.choice(LUT, size=k))
        out.append("".join(s))
    return out


def _msa_file(path, rows):
    path.write_text("".join(">m%d\n%s\n" % (i, r) for i, r in enumerate(rows)))


@pytest.fixture(scope="module")
def msa(tmp_path_factory):
    """A gapped alignment of 40 members (the progressive MSA of a seeded
    family with indels)."""
    rng = np.random.default_rng(19)
    seqs = _family(rng, 40, 420, 12, indels=2)
    _, rows = tprog.progressive_msa(["m%d" % i for i in range(40)], seqs)
    path = tmp_path_factory.mktemp("msa") / "c.msa"
    _msa_file(path, rows)
    return path


@pytest.mark.parametrize("argv", [
    ["-l", "18", "-d", "96"],
    ["-l", "20", "-d", "12", "-n", "30", "--seed", "3", "--trim", "0.5",
     "--skip", "5", "--depth", "2"]])
def test_wrc_equals_jax(tmp_path, msa, argv):
    outs = []
    for cli in (jcli, tcli):
        out = tmp_path / ("jax.out" if cli is jcli else "torch.out")
        assert cli.main(["wrc", "-i", str(msa), "-o", str(out)] + argv) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert outs[1].startswith(b"Pos\t") and outs[1].count(b"\n") > 50


def test_run_dege_equals_jax(tmp_path, msa):
    outs = []
    for cli in (jcli, tcli):
        out = tmp_path / ("jax.out" if cli is jcli else "torch.out")
        assert cli.main(["run-dege", "-i", str(msa), "-o", str(out), "-l",
                         "18", "-d", "8", "--seed", "2"]) == 0
        assert not os.path.exists(str(out) + ".tmp")
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[1].count(b"\n") > 50


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_progressive_msa_equals_jax(seed):
    """Three families of different divergence, mixed, with indels."""
    rng = np.random.default_rng(seed)
    seqs = (_family(rng, 9, 300, 6, indels=2)
            + _family(rng, 5, 280, 20, indels=3) + _family(rng, 2, 260, 2))
    order = rng.permutation(len(seqs))
    seqs = [seqs[i] for i in order]
    ids = ["s%d" % i for i in range(len(seqs))]
    want = jprog.progressive_msa(ids, seqs)
    got = tprog.progressive_msa(ids, seqs)
    assert got[0] == want[0] and got[1] == want[1]
    assert len({len(r) for r in got[1]}) == 1
    assert any("-" in r for r in got[1])


def test_refine_global_equals_jax():
    """refine_global on seeded cover dicts: variants of a consensus with
    1-4 substitutions, over dege_number and variation settings."""
    rng = np.random.default_rng(8)
    cases = 0
    for _ in range(30):
        base = "".join(rng.choice(LUT, size=18))
        cover = {base: int(rng.integers(5, 40))}
        for _ in range(int(rng.integers(1, 8))):
            v = list(base)
            for at in rng.choice(18, size=int(rng.integers(1, 5)),
                                 replace=False):
                v[at] = str(rng.choice(LUT))
            cover["".join(v)] = int(rng.integers(1, 20))
        total = sum(cover.values())
        for dege, var in ((4, 1), (2, 0), (6, 2)):
            want = jglobal.refine_global(base, dict(cover), dege, var, total)
            got = tglobal.refine_global(base, dict(cover), dege, var, total)
            assert got == want
            cases += 1
    assert cases == 90


def test_design_v2_equals_jax(tmp_path):
    """`design --algo v2` (the JAX package's design CLI against the port's):
    the .top.primer.out with its degeneracy column and the sidecars."""
    rng = np.random.default_rng(12)
    path = tmp_path / "c.tmsa"
    _msa_file(path, _family(rng, 30, 320, 4))
    trees = []
    for name, mod, extra in (("jax", jdesign, []),
                             ("torch", tdesign, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        mod.main(["-i", str(path), "-o", str(d / "c.top.primer.out"), "-f",
                  "0.5", "-s", "100", "-c", "2,3,-1", "--algo", "v2"] + extra)
        trees.append(_tree(d))
    assert trees[0] == trees[1]
    header = trees[1]["c.top.primer.out"].split(b"\n")[0].split(b"\t")
    assert b"degeneracy" in header
    assert trees[1]["c.top.primer.out"].count(b"\n") > 5


@pytest.mark.parametrize("override", [
    {"design_backend": "wrc"}, {"align_backend": "progressive"},
    {"algo": "v2"}], ids=["wrc", "progressive", "v2"])
def test_run_pipeline_backend_tree_equals_jax(tmp_path, override,
                                              monkeypatch):
    """The three-family `run` with each alternative backend: both pipelines
    write into the same path, one after the other, and every file but the
    timings is byte-identical; the port's scan held to the device path
    (MPTPU_FORCE_BACKEND), which the crossover gives to the host here."""
    fa = tmp_path / "three.fa"
    _three_families(fa)
    res = tmp_path / "res"
    kw = dict(PIPE_KW, **override)
    jdriver.run_pipeline(None, input_fa=str(fa), results_dir=str(res), **kw)
    os.rename(res, tmp_path / "res_jax")
    monkeypatch.setenv("MPTPU_FORCE_BACKEND", "device")
    pipe, _ = tdriver.run_pipeline(None, input_fa=str(fa),
                                   results_dir=str(res), device="cpu", **kw)
    want = _tree(tmp_path / "res_jax")
    got = _tree(res)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    assert any(r.startswith("Core_primers_set/BWT_coverage/") for r in got)
    backends = pipe._backends()
    assert backends["scan_backend"] == "device"
    if "align_backend" in override:
        assert backends["align_served"] == {"progressive": 3}
    if "design_backend" in override:
        tables = [r for r in got if r.startswith("Clusters_primer/")
                  and r.endswith(".top.primer.out")]
        assert tables and all(got[r].startswith(b"Pos\t") for r in tables)
