"""The port's `design` and `pair` CLIs and the device Stage A / device
align `run` against the JAX package, on the CPU: byte-identical files."""

import json
import os

import pytest

from multiprime_tpu.cli import main as jcli
from multiprime_tpu.pipeline import driver as jdriver
from multiprime_tpu_torch.cli import main as tcli
from multiprime_tpu_torch.pipeline import driver as tdriver

from .test_torch_design_scan import _synthetic_family
from .test_torch_pipeline import PIPE_KW, _three_families, _tree

DESIGN_SUFFIXES = ("", ".gap_seq_id_json", ".non_coverage_seq_id_json")
PAIR_SUFFIXES = (".txt", ".xls", ".fa")


@pytest.fixture
def msa(tmp_path):
    """The conserved synthetic family as an MSA file and its ungapped
    cluster fasta."""
    ids, chars = _synthetic_family(seed=7, n=30, length=260)
    rows = [r.tobytes().decode("ascii") for r in chars]
    path = tmp_path / "c.tmsa"
    path.write_text("".join("%s\n%s\n" % (i, r) for i, r in zip(ids, rows)))
    tfa = tmp_path / "c.tfa"
    tfa.write_text("".join("%s\n%s\n" % (i, r.replace("-", ""))
                           for i, r in zip(ids, rows)))
    return str(path), str(tfa)


def _take(base, suffixes):
    """Read and remove base+suffix for each suffix (each must exist)."""
    out = {}
    for suffix in suffixes:
        with open(base + suffix, "rb") as f:
            out[suffix] = f.read()
        os.remove(base + suffix)
    return out


DESIGN_FLAGS = ["-f", "0.5", "-s", "100", "-c", "2,3,-1"]


@pytest.mark.parametrize("stage_a", ["device", "host", "auto"])
def test_design_cli_equals_jax(tmp_path, msa, stage_a, monkeypatch):
    """`design --stage-a X --device cpu` writes the .top.primer.out and its
    two JSON sidecars of JAX's `mptpu design`, byte for byte."""
    monkeypatch.delenv("MPTPU_FORCE_BACKEND", raising=False)
    out = str(tmp_path / "c.top.primer.out")
    jcli.main(["design", "-i", msa[0], "-o", out] + DESIGN_FLAGS)
    want = _take(out, DESIGN_SUFFIXES)
    assert tcli.main(["design", "-i", msa[0], "-o", out, "--stage-a",
                      stage_a, "--device", "cpu"] + DESIGN_FLAGS) == 0
    got = _take(out, DESIGN_SUFFIXES)
    assert want[""].count(b"\n") > 2
    assert got == want


def test_pair_cli_equals_jax(tmp_path, msa):
    """`pair` on the design table writes JAX's `mptpu pair` files (the txt
    embeds its own path, so both write to one path in turn)."""
    table = str(tmp_path / "c.top.primer.out")
    assert tcli.main(["design", "-i", msa[0], "-o", table, "--stage-a",
                      "device", "--device", "cpu"] + DESIGN_FLAGS) == 0
    base = str(tmp_path / "c.candidate.primers")
    flags = ["pair", "-i", table, "-r", msa[1], "-s", "100,400", "-f", "0.5",
             "-o", base + ".txt"]
    jcli.main(flags)
    want = _take(base, PAIR_SUFFIXES)
    assert tcli.main(flags) == 0
    assert _take(base, PAIR_SUFFIXES) == want
    assert want[".xls"].count(b"\n") > 1


@pytest.mark.parametrize("nproc", [1, 2])
def test_run_pipeline_device_stages_equal_jax_host(tmp_path, nproc):
    """`run_pipeline` with device Stage A and the device Gotoh (torch on the
    CPU; in process, and in a pool of two workers, which the driver forks
    from its forkserver since they run torch ops) writes the tree of the
    JAX package's host run, and its metrics show that the device paths
    served every cluster."""
    fa = tmp_path / "three.fa"
    _three_families(fa)
    res = tmp_path / "res"
    jdriver.run_pipeline(None, input_fa=str(fa), results_dir=str(res),
                         **PIPE_KW)
    os.rename(res, tmp_path / "res_jax")
    pipe, _ = tdriver.run_pipeline(
        None, input_fa=str(fa), results_dir=str(res), device="cpu",
        stage_a="device", align_backend="centerstar-device", nproc=nproc,
        **PIPE_KW)
    assert pipe._clusters_use_torch()
    want = _tree(tmp_path / "res_jax")
    got = _tree(res)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    backends = pipe._backends()
    n_clusters = len(pipe.cluster_names)
    assert n_clusters >= 2
    assert backends["stage_a_served"] == {"device": n_clusters}
    assert backends["align_served"] == {"device": n_clusters}
    # the plain versions served on the CPU: no kernel launched
    launches = backends["launches"]
    assert launches["gotoh_dp"] == launches["refine_dp"] == 0
    assert launches["gotoh_dp_warp"] == launches["refine_dp_warp"] == 0
    assert launches["stage_a_windows"] == 0
    assert set(launches.values()) == {0}


def test_run_reports_its_own_launches(tmp_path, monkeypatch):
    """``backends["launches"]`` counts the run's own launches, keyed by
    every launcher prefix: a CPU run (plain versions only, a pool of two
    workers) started after launches counted earlier in the process reports
    zero for each, in its metrics file too, and a launch after the run
    ends is not the run's."""
    from multiprime_tpu_torch.ops import _cuda
    monkeypatch.setattr(_cuda, "_LAUNCHED", {
        "find_hits": 7, "gotoh_dp": 3, "stage_a_windows": 2,
        "banded_identity": 5})
    fa = tmp_path / "three.fa"
    _three_families(fa)
    res = tmp_path / "res"
    pipe, _ = tdriver.run_pipeline(
        None, input_fa=str(fa), results_dir=str(res), device="cpu",
        stage_a="device", align_backend="centerstar-device", nproc=2,
        **PIPE_KW)
    want = {prefix: 0 for lib in _cuda._LAUNCHERS.values() for prefix in lib}
    assert pipe._backends()["launches"] == want
    with open(res / "pipeline_metrics.json") as f:
        assert json.load(f)["backends"]["launches"] == want
    assert _cuda.launches()["find_hits"] == 7
    _cuda._LAUNCHED["find_hits"] += 4
    assert pipe._backends()["launches"] == want


def _indel_families(path, length=420):
    """Two families of 8 members with substitutions and indels of 1-6
    bases, and a singleton."""
    import numpy as np
    rng = np.random.default_rng(53)
    lut = np.array(list("ACGT"))
    with open(path, "w") as f:
        for fam in range(2):
            base = list(rng.choice(lut, size=length))
            for i in range(8):
                s = list(base)
                for _ in range(10):
                    k = int(rng.integers(0, len(s)))
                    kind = rng.integers(0, 3)
                    n = int(rng.integers(1, 7))
                    if kind == 0:
                        s[k] = str(rng.choice(lut))
                    elif kind == 1:
                        del s[k:k + n]
                    else:
                        s[k:k] = list(rng.choice(lut, size=n))
                f.write(">%c%d\n%s\n" % (65 + fam, i, "".join(s)))
        f.write(">S0\n%s\n" % "".join(rng.choice(lut, size=length)))


def test_run_refine_device_tree_equals_host(tmp_path):
    """`run --refine device` (the refine DP's plain version on the CPU,
    the device center-star, a pool of two workers) writes the tree of
    `--refine host` and of the JAX package's host `run` on the same
    FASTA, and its backends name the refine backend that served each
    multi-row cluster."""
    fa = tmp_path / "indels.fa"
    _indel_families(fa)
    yaml = tmp_path / "device.yaml"
    yaml.write_text("align_backend: centerstar-device\n")
    res = tmp_path / "res"
    jcli.main(["run", "-i", str(fa), "-r", str(res), "--coverage", "0.5"])
    trees, backends = {"jax": _tree(res)}, {}
    os.rename(res, tmp_path / "res_jax")
    for refine in ("host", "device"):
        assert tcli.main(["run", "-c", str(yaml), "-i", str(fa), "-r",
                          str(res), "--device", "cpu", "--coverage", "0.5",
                          "--nproc", "2", "--refine", refine]) == 0
        with open(res / "pipeline_metrics.json") as f:
            backends[refine] = json.load(f)["backends"]
        trees[refine] = _tree(res)
        os.rename(res, tmp_path / ("res_" + refine))
    assert any(rel.endswith(".tmsa") for rel in trees["jax"])
    for side in ("host", "device"):
        assert sorted(trees[side]) == sorted(trees["jax"])
        for rel in trees["jax"]:
            assert trees[side][rel] == trees["jax"][rel], (side, rel)
    assert backends["device"]["align_served"]["device"] == 2
    assert backends["host"]["refine_served"] == {"host": 2}
    assert backends["device"]["refine_served"] == {"device": 2}
    launches = backends["device"]["launches"]
    assert launches["refine_dp"] + launches["refine_dp_warp"] == 0


@pytest.mark.parametrize("yaml_text", ["refine_backend: gpu\n", None])
def test_pipeline_refuses_an_unknown_refine(tmp_path, yaml_text):
    """A refine backend other than host or device, from the YAML key
    refine_backend or set on the config, is refused as the pipeline is
    built, before any stage runs."""
    if yaml_text is None:
        cfg = tdriver.PipelineConfig()
        cfg.refine = "auto"
    else:
        path = tmp_path / "bad.yaml"
        path.write_text(yaml_text)
        cfg = tdriver.PipelineConfig.from_yaml(str(path))
    with pytest.raises(ValueError, match="refine"):
        tdriver.Pipeline(cfg)
