"""The port's `design` and `pair` CLIs and the device Stage A / device
align `run` against the JAX package, on the CPU: byte-identical files."""

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
    # the plain versions served on the CPU: no DP kernel launched
    assert backends["gotoh_dp_launches"] == backends["refine_dp_launches"] == 0
    assert backends["gotoh_dp_warp_launches"] == 0
    assert backends["refine_dp_warp_launches"] == 0
    assert backends["stage_a_kernel_launches"] == 0
