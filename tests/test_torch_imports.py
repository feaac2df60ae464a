"""The PyTorch port stands alone: it loads neither JAX nor the JAX package,
asks for the GPU unless told otherwise, and refuses the one path it has not
ported yet (more than one GPU) instead of running something else."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from multiprime_tpu_torch.align import centerstar, refine
from multiprime_tpu_torch.cli import main as tcli
from multiprime_tpu_torch.models import mcdpd
from multiprime_tpu_torch.pipeline import driver as tdriver
from multiprime_tpu_torch.utils import link as tlink
from multiprime_tpu_torch.validate import scan as tscan

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "multiprime_tpu_torch"


def _forbidden(name):
    return (name in ("jax", "jaxlib", "multiprime_tpu")
            or name.startswith(("jax.", "jaxlib.", "multiprime_tpu.")))


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    """AST scan: no import of jax, jaxlib or multiprime_tpu, and no module
    name of theirs in a string (sys.modules lookups, importlib)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names = [node.value] if _forbidden(node.value) else []
        else:
            continue
        for name in names:
            assert not _forbidden(name), "%s:%d imports %s" % (
                path.relative_to(ROOT), node.lineno, name)


_SUBPROCESS = r"""
import json, os, sys
import numpy as np
root = sys.argv[1]
rng = np.random.default_rng(41)
lut = np.array(list("ACGT"))
bases = ["".join(rng.choice(lut, size=480)) for _ in range(3)]
fa = os.path.join(root, "three.fa")
with open(fa, "w") as f:
    for b, base in enumerate(bases):
        for i in range(8):
            s = list(base)
            for _ in range(6):
                s[rng.integers(0, len(s))] = str(rng.choice(lut))
            f.write(">%c%d\n%s\n" % (65 + b, i, "".join(s)))
from multiprime_tpu_torch.pipeline.driver import run_pipeline
import multiprime_tpu_torch.cli.main
import multiprime_tpu_torch.ops._cuda
from multiprime_tpu_torch.ops import dimer
dimer.dimer_hit_matrix_fused(["ACGTACGTAC", "GTACGTACGT"], device="cpu")
pipe, _ = run_pipeline(None, input_fa=fa, results_dir=os.path.join(root, "r"),
                       virus_name="three", coverage=0.5, min_seq_length=100,
                       product_size=(100, 400), algo="v20", device="cpu")
print(json.dumps({"modules": sorted(sys.modules),
                  "backends": pipe._backends()}))
"""


def test_port_run_loads_no_jax(tmp_path):
    """In a fresh interpreter, the port's whole `run` on the CPU leaves
    neither jax nor any multiprime_tpu module in sys.modules."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS, str(tmp_path)], env=env,
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in got["modules"] if _forbidden(m)] == []
    assert "multiprime_tpu_torch.validate.scan" in got["modules"]
    assert "multiprime_tpu_torch.ops.dimer" in got["modules"]
    assert got["backends"]["scan_backend"] == "device"
    assert (tmp_path / "r" / "Core_primers_set" / "BWT_coverage").is_dir()


# ---------------------------------------------------------------------------
# (h) the GPU is the default: asking for it without one raises
# ---------------------------------------------------------------------------

def _needs_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: device='cuda' does not raise")


def test_cuda_without_gpu_raises(tmp_path):
    _needs_no_gpu()
    with pytest.raises(RuntimeError, match="is_available"):
        tlink.resolve_device("cuda")
    assert tlink.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tlink.resolve_device("meta")
    with pytest.raises(RuntimeError, match="is_available"):
        tscan.scan_hits(["ACGT" * 10], ["ACGTACGT"], tscan.ScanParams())
    prim = tmp_path / "p.fa"
    prim.write_text(">p\nACGTACGT\n")
    ref = tmp_path / "r.fa"
    ref.write_text(">r\n" + "ACGT" * 10 + "\n")
    with pytest.raises(RuntimeError, match="is_available"):
        tscan.run(str(prim), str(ref), str(tmp_path / "o.out"),
                  tscan.ScanParams())
    with pytest.raises(RuntimeError, match="is_available"):
        tdriver.run_pipeline(None, input_fa=str(ref),
                             results_dir=str(tmp_path / "res"))
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.main(["scan", "-i", str(prim), "-r", str(ref), "-o",
                   str(tmp_path / "c.out")])
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.main(["run", "-i", str(ref), "-r", str(tmp_path / "res2")])
    assert not (tmp_path / "o.out").exists()


def _new_entry_points(tmp_path):
    """The entry points of the dimer matrix, the two-phase scan, device
    Stage A, the device DPs, the design CLI and the scans of specificity,
    update, onestep and the solver's off-target screen, called with their
    default device."""
    from multiprime_tpu_torch.align import device as adev
    from multiprime_tpu_torch.cli import design as tdesign
    from multiprime_tpu_torch.ops import design_scan
    from multiprime_tpu_torch.ops import dimer
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.solve import maxset
    from multiprime_tpu_torch.validate import specificity, update
    oh = np.zeros((2, 24, 4), np.uint8)
    masks = np.full((3, 40), 1, np.int32)
    msa = tmp_path / "m.msa"
    msa.write_text(">a\n" + "ACGT" * 60 + "\n>b\n" + "ACGT" * 60 + "\n")
    rows = ["ACGT-ACGT", "ACGTTACGT"]
    prim = tmp_path / "p.fa"
    prim.write_text(">p_F\nACGTACGTAC\n>p_R\nGTACGTACGT\n")
    out = str(tmp_path / "o.out")
    spec = ["-i", str(prim), "-r", str(msa), "-o", out]
    pairs = [["c1", "ACGTACGTAC", "GTACGTACGT", "1:2:3", "9", "0:1"]]
    return {
        "dimer_hit_matrix": lambda: dimer.dimer_hit_matrix(["ACGTACGTAC"]),
        "dimer_hit_matrix_fused":
            lambda: dimer.dimer_hit_matrix_fused(["ACGTACGTAC"]),
        "match_counts": lambda: ms.match_counts(oh, oh[:1, :8]),
        "find_hits_bitmap": lambda: ms.find_hits_bitmap(
            oh, np.array([24, 24]), oh[:1, :8], oh[:1, :8]),
        "design_stats": lambda: design_scan.design_stats(masks, [0, 5]),
        "design_stats_blocks": lambda: list(
            design_scan.design_stats_blocks(masks, [0, 5])),
        "stage_a_device": lambda: mcdpd.DesignEngine(mcdpd.DesignParams(
            stage_a="device", coverage=0.5, min_product=50)).design(
                *mcdpd.parse_msa(str(msa))),
        "align_ops_batch_device": lambda: adev.align_ops_batch_device(
            np.array([0, 1, 2]), [np.array([0, 1])]),
        "center_star_msa_device": lambda: centerstar.center_star_msa(
            ["a", "b"], ["ACGT", "ACG"], backend="device"),
        "refine_pass_device": lambda: refine.refine_pass(rows,
                                                         backend="device"),
        "design_cli": lambda: tdesign.main(["-i", str(msa), "-o", str(
            tmp_path / "o.out"), "--stage-a", "host"]),
        "specificity": lambda: specificity.run(str(prim), str(msa), out),
        "update_with_ref": lambda: update.run(str(prim), str(prim), str(msa),
                                              out),
        "greedy_maximal_with_offtarget":
            lambda: maxset.greedy_maximal_with_offtarget(pairs, out, out,
                                                         str(msa)),
        "specificity_cli": lambda: tcli.main(["specificity"] + spec),
        "update_cli": lambda: tcli.main(["update", "-c", str(prim)] + spec),
        "onestep_cli": lambda: tcli.main([
            "onestep", "-i", str(msa), "-r", str(msa), "--out1", out, "-o",
            str(tmp_path / "o.txt")]),
    }


@pytest.mark.parametrize("name", ["dimer_hit_matrix",
                                  "dimer_hit_matrix_fused", "match_counts",
                                  "find_hits_bitmap", "design_stats",
                                  "design_stats_blocks", "stage_a_device",
                                  "align_ops_batch_device",
                                  "center_star_msa_device",
                                  "refine_pass_device", "design_cli",
                                  "specificity", "update_with_ref",
                                  "greedy_maximal_with_offtarget",
                                  "specificity_cli", "update_cli",
                                  "onestep_cli"])
def test_new_entry_points_default_to_cuda(name, tmp_path):
    _needs_no_gpu()
    with pytest.raises(RuntimeError, match="is_available"):
        _new_entry_points(tmp_path)[name]()
    assert not (tmp_path / "o.out").exists()
    assert not (tmp_path / "p.term.fa").exists()


@pytest.mark.parametrize("override", [{"devices": 2}])
def test_unported_pipeline_options_raise(tmp_path, override):
    ref = tmp_path / "r.fa"
    ref.write_text(">r\n" + "ACGT" * 100 + "\n")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdriver.run_pipeline(None, input_fa=str(ref), device="cpu",
                             results_dir=str(tmp_path / "res"), **override)


@pytest.mark.parametrize("override", [
    {"align_backend": "progressive"}, {"design_backend": "wrc"}])
def test_ported_pipeline_options_run(tmp_path, override):
    """The progressive MSA and the WRC designer are ported: the run that
    raised before completes (their trees are held to JAX's in
    tests/test_torch_backends.py)."""
    ref = tmp_path / "r.fa"
    ref.write_text(">r\n" + "ACGT" * 100 + "\n")
    pipe, log = tdriver.run_pipeline(None, input_fa=str(ref), device="cpu",
                                     results_dir=str(tmp_path / "res"),
                                     **override)
    assert log and (tmp_path / "res" / "cluster.txt").exists()


def test_unported_device_backends_raise(monkeypatch):
    """Device Stage A and the device DPs are ported: they resolve to the
    device instead of raising NotImplementedError; the auto align policy
    takes the device DP only for a CUDA device and a large pointer tensor;
    and the design engine designs the v2 flow."""
    monkeypatch.delenv("MPTPU_FORCE_BACKEND", raising=False)
    assert mcdpd.resolve_stage_a(100, 100, 18) == "device"
    monkeypatch.setenv("MPTPU_FORCE_BACKEND", "host")
    assert mcdpd.resolve_stage_a(100, 100, 18) == "host"
    assert centerstar._use_device_backend("device", 10, 100, "cpu") is True
    assert centerstar._use_device_backend("auto", 1024, 512, "cuda") is True
    assert centerstar._use_device_backend("auto", 1023, 512, "cuda") is False
    assert centerstar._use_device_backend("auto", 10 ** 6, 10 ** 6,
                                          "cpu") is False
    assert centerstar._use_device_backend("numpy", 10 ** 6, 10 ** 6) is False
    rng = np.random.default_rng(12)
    ascii_lut = np.frombuffer(b"ACGT", np.uint8)
    base = rng.integers(0, 4, size=320)
    chars = np.zeros((30, 320), dtype=np.uint8)
    for i in range(30):
        s = base.copy()
        s[rng.integers(0, 320, size=4)] = rng.integers(0, 4, size=4)
        chars[i] = ascii_lut[s]
    res = mcdpd.DesignEngine(mcdpd.DesignParams(
        coverage=0.5, min_product=100, coordinate="2,3,-1",
        algo="v2")).design([">v%d" % i for i in range(30)], chars)
    assert res and all(hasattr(r, "degeneracy") for r in res)


def test_fork_safe_tracks_cuda(monkeypatch):
    assert mcdpd.fork_safe() == (not torch.cuda.is_initialized())
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert mcdpd.fork_safe() is False


def test_kernel_build_goes_stale_with_its_source_or_a_header(tmp_path,
                                                            monkeypatch):
    from multiprime_tpu_torch.ops import _cuda
    src, build = tmp_path / "csrc", tmp_path / "_build"
    src.mkdir()
    build.mkdir()
    monkeypatch.setattr(_cuda, "SRC_DIR", str(src))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(build))
    (src / "k.cu").write_text("")
    (src / "shared.cuh").write_text("")
    assert _cuda._stale("k")                   # never built
    (build / "libk.so").write_text("")
    for path, t in ((src / "k.cu", 1), (src / "shared.cuh", 1),
                    (build / "libk.so", 2)):
        os.utime(path, (t, t))
    assert not _cuda._stale("k")
    for newer in ("k.cu", "shared.cuh"):
        os.utime(src / newer, (3, 3))
        assert _cuda._stale("k")
        os.utime(src / newer, (1, 1))
