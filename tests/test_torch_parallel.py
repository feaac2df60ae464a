"""The port's device mesh (parallel/mesh.py) against the JAX package's, on
the CPU: an 8-entry CPU mesh beside JAX's 8 virtual CPU devices
(tests/conftest.py), the same seeded inputs, equal integers and
byte-identical files.  Also the driver's mesh run, its shard slot under a
two-rank gloo group, `run --profile`, and the multi-device dry run."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from multiprime_tpu.ops import design_scan as jds
from multiprime_tpu.ops import mismatch_scan as jms
from multiprime_tpu.parallel import mesh as jmesh
from multiprime_tpu.pipeline import driver as jdriver
from multiprime_tpu.validate import scan as jscan
from multiprime_tpu_torch.cli import main as tcli
from multiprime_tpu_torch.ops import design_scan as tds
from multiprime_tpu_torch.ops import mismatch_scan as tms
from multiprime_tpu_torch.parallel import mesh as tmesh
from multiprime_tpu_torch.pipeline import driver as tdriver
from multiprime_tpu_torch.validate import scan as tscan

from .test_torch_pipeline import PIPE_KW, _three_families, _tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def meshes():
    """(JAX's 8-device mesh, the port's 8-entry CPU mesh)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(8), tmesh.make_mesh(8, device="cpu")


def _example(n=32, length=256, w=32, seed=0):
    rng = np.random.default_rng(seed)
    masks = (1 << rng.integers(0, 4, size=(n, length))).astype(np.int32)
    masks[rng.random((n, length)) < 0.05] = 0
    positions = np.arange(8, 8 + w, dtype=np.int32)
    return masks, positions


def test_make_mesh_factorisation_and_devices():
    """The JAX package's factorisation, CPU entries for "cpu", and a mesh of
    any device array (one device several times included)."""
    for n, shape in ((8, (4, 2)), (6, (3, 2)), (5, (5, 1)), (1, (1, 1))):
        m = tmesh.make_mesh(n, device="cpu")
        assert (m.shape["seq"], m.shape["win"]) == shape == tuple(
            jmesh.make_mesh(n).devices.shape)
        assert m.devices.size == n
        assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert tmesh.make_mesh(8, seq_axis=2, device="cpu").shape == {
        "seq": 2, "win": 4}
    m = tmesh.Mesh([["cpu", "cpu"], ["cpu", "cpu"]])
    assert m.shape == {"seq": 2, "win": 2}
    assert tmesh.Mesh(m.spec()).spec() == m.spec()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tmesh.make_mesh(2, device="cuda")


def test_design_stats_sharded_equals_jax(meshes):
    masks, positions = _example()
    want = jmesh.design_stats_sharded(meshes[0], masks, positions)
    got = tmesh.design_stats_sharded(meshes[1], masks, positions)
    single = tds.design_stats(masks, positions, device="cpu")
    for key in ("freq", "nn", "cover_number", "gap_number", "viterbi"):
        assert np.array_equal(np.asarray(want[key]).astype(np.int64),
                              got[key].numpy().astype(np.int64)), key
        assert got[key].dtype == single[key].dtype
        assert torch.equal(got[key], single[key]), key


def test_design_blocks_sharded_equals_jax(meshes):
    """Rows padded with all-gap rows (37 % 4), windows padded (70 % 32):
    the block stream equals JAX's sharded one and the port's unsharded one,
    patched windows and pad-corrected gap counts included."""
    masks, _ = _example(n=37, length=256, seed=3)
    positions = np.arange(4, 4 + 70, dtype=np.int32)
    want = list(jmesh.design_stats_blocks_sharded(
        meshes[0], masks, positions, plen=18, variation=1, block=32))
    got = list(tmesh.design_stats_blocks_sharded(
        meshes[1], masks, positions, plen=18, variation=1, block=32))
    single = list(tds.design_stats_blocks(masks, positions, plen=18,
                                          variation=1, block=32,
                                          device="cpu"))
    assert len(want) == len(got) == len(single) == 3
    for (pw, w), (pg, g), (ps, s) in zip(want, got, single):
        assert np.array_equal(pw, pg) and np.array_equal(pg, ps)
        assert sorted(w) == sorted(g) == sorted(s)
        for key in w:
            assert np.array_equal(np.asarray(w[key]).astype(np.int64),
                                  g[key].astype(np.int64)), key
            assert g[key].dtype == s[key].dtype
            assert np.array_equal(g[key], s[key]), key


def _ragged_scan_inputs():
    """tests/test_parallel.py's ragged targets: an exact, a 1-mismatch and
    a 3'-vetoed plant."""
    rng = np.random.default_rng(5)
    lut = np.array(list("ACGT"))
    targets = ["".join(rng.choice(lut, size=int(n)))
               for n in rng.integers(60, 300, size=37)]
    primers = ["".join(rng.choice(lut, size=18)) for _ in range(5)]
    targets[0] = targets[0][:10] + primers[0] + targets[0][28:]
    mut = list(primers[1])
    mut[2] = "A" if mut[2] != "A" else "C"
    targets[8] = targets[8][:50] + "".join(mut) + targets[8][68:]
    bad = list(primers[2])
    bad[-1] = "A" if bad[-1] != "A" else "C"
    targets[36] = targets[36][:5] + "".join(bad) + targets[36][23:]
    return targets, primers


def test_find_hits_sharded_blocks_equal_jax(meshes):
    """Per-shard packed blocks, decoded with their row offsets, equal JAX's
    hit for hit, and the unsharded find_hits_packed."""
    targets, primers = _ragged_scan_inputs()
    targets = targets[:32]
    p1h = jms.encode_primers(primers)
    s1h = p1h.copy()
    s1h[:, :-4, :] = 0
    masks, lens = jms.encode_target_masks(targets, length=512)
    want = jmesh.find_hits_sharded(meshes[0], masks, lens, p1h, s1h, mm=1,
                                   term=4, max_hits_per_shard=256,
                                   want_mism=True)
    got = tmesh.find_hits_sharded(meshes[1], masks, lens, p1h, s1h, mm=1,
                                  term=4, max_hits_per_shard=256,
                                  want_mism=True)
    assert got.shape == want.shape == (8, 1 + 2 * 256)
    n_out, rows = 512 - 18 + 1, 4

    def decode(blocks):
        out = []
        for si, blk in enumerate(blocks):
            seq, pos, pat, mism, _ = tms.decode_packed(blk, n_out, 5, 256)
            out += list(zip((seq + si * rows).tolist(), pos.tolist(),
                            pat.tolist(), mism.tolist()))
        return out
    assert decode(got) == decode(want)
    planes, sfx = tms.pack_patterns(p1h, s1h, device="cpu")
    single = tms.find_hits_packed(torch.from_numpy(masks),
                                  torch.from_numpy(lens), planes, sfx,
                                  plen=18, mm=1, term=4, max_hits=2048)
    seq, pos, pat, mism, n_hits = tms.decode_packed(single.numpy(), n_out,
                                                    5, 2048)
    assert decode(got) == list(zip(seq.tolist(), pos.tolist(), pat.tolist(),
                                   mism.tolist()))
    assert n_hits >= 2


def test_scan_hits_under_mesh_equals_jax(meshes):
    """scan_hits under use_mesh (an explicit backend takes the sharded
    path, "numpy" included) equals JAX's sharded and single scans."""
    targets, primers = _ragged_scan_inputs()
    params = dict(mm=1, term=4, batch_seqs=8, device_batch_seqs=16,
                  backend="numpy", want_mism=True)
    want = jscan.scan_hits(targets, primers, jscan.ScanParams(**params))
    with jmesh.use_mesh(meshes[0]):
        want_sharded = jscan.scan_hits(targets, primers,
                                       jscan.ScanParams(**params))
    with tmesh.use_mesh(meshes[1]):
        got = tscan.scan_hits(targets, primers, tscan.ScanParams(**params),
                              "cpu")
    assert tscan.LAST_BACKEND == "device-sharded"
    assert got == want_sharded == want
    assert any(s == 0 for s, *_ in got) and any(s == 8 for s, *_ in got)
    assert not any(s == 36 for s, *_ in got)


def test_validate_run_under_mesh_equals_jax(meshes, tmp_path):
    """vscan.run under use_mesh writes JAX's .out/.pair.num/.total.acc.num
    byte for byte."""
    from multiprime_tpu.utils import iupac
    rng = np.random.default_rng(11)
    lut = np.array(list("ACGT"))
    f_primer = "".join(rng.choice(lut, size=18))
    r_primer = "".join(rng.choice(lut, size=18))
    targets = []
    for i in range(23):
        body = "".join(rng.choice(lut, size=400))
        if i % 3 == 0:
            body = (body[:60] + f_primer + body[78:240]
                    + iupac.rc(r_primer) + body[258:])
        targets.append(body)
    ref_fa = tmp_path / "ref.fa"
    ref_fa.write_text("".join(">g%d\n%s\n" % (i, t)
                              for i, t in enumerate(targets)))
    outs = {}
    for name, mod, mesh, ctx in (("jax", jscan, meshes[0], jmesh.use_mesh),
                                 ("torch", tscan, meshes[1],
                                  tmesh.use_mesh)):
        d = tmp_path / name
        d.mkdir()
        (d / "p.fa").write_text(">C0_F\n%s\n>C0_R\n%s\n"
                                % (f_primer, r_primer))
        params = mod.ScanParams(mm=1, term=4, product_size=(100, 400),
                                batch_seqs=8, device_batch_seqs=16,
                                backend="numpy")
        extra = {"device": "cpu"} if mod is tscan else {}
        with ctx(mesh):
            mod.run(str(d / "p.fa"), str(ref_fa), str(d / "o.out"), params,
                    **extra)
        outs[name] = d / "o.out"
    for suffix in ("", ".pair.num", ".total.acc.num"):
        a = (str(outs["jax"]) + suffix)
        b = (str(outs["torch"]) + suffix)
        assert open(a, "rb").read() == open(b, "rb").read(), suffix
    assert len(outs["torch"].read_text().splitlines()) > 1
    assert tscan.LAST_BACKEND == "device-sharded"


def test_coverage_counts_sharded_equals_jax(meshes):
    rng = np.random.default_rng(1)
    lut = np.array(list("ACGT"))
    targets = ["".join(rng.choice(lut, size=128)) for _ in range(32)]
    primers = ["".join(rng.choice(lut, size=18)) for _ in range(8)]
    targets[3] = targets[3][:40] + primers[2] + targets[3][58:]
    t1h, lengths = jms.encode_targets(targets)
    p1h = jms.encode_primers(primers)
    s1h = p1h.copy()
    s1h[:, :-4, :] = 0
    want_hits, want_cov = jmesh.coverage_counts_sharded(
        meshes[0], t1h, lengths, p1h, s1h, mm=1, term=4)
    hits, covered = tmesh.coverage_counts_sharded(
        meshes[1], t1h, lengths, p1h, s1h, mm=1, term=4)
    assert hits.dtype == covered.dtype == torch.int64
    assert np.array_equal(np.asarray(want_hits), hits.numpy())
    assert int(covered) == int(want_cov) >= 1
    # the unsharded sum of the match-count kernel's plain version
    counts = tms.match_counts(t1h, p1h, device="cpu").numpy()
    suffix = tms.match_counts(t1h, s1h, device="cpu").numpy()
    ok = ((18 - counts) <= 1) & (suffix >= 4)
    ok &= (np.arange(counts.shape[1])[None, :, None] + 18
           <= lengths[:, None, None])
    assert np.array_equal(hits.numpy(), ok.sum(axis=(0, 1)))


def _two_families(path):
    """tests/test_parallel.py's two-family input."""
    rng = np.random.default_rng(9)
    lut = np.array(list("ACGT"))
    bases = ["".join(rng.choice(lut, size=500)) for _ in range(2)]
    with open(path, "w") as f:
        for b, base in enumerate(bases):
            for i in range(8):
                s = list(base)
                for _ in range(6):
                    s[rng.integers(0, len(s))] = str(rng.choice(lut))
                f.write(">%c%d\n%s\n" % (65 + b, i, "".join(s)))


@pytest.mark.parametrize("nproc", [1, 2])
def test_run_pipeline_devices_equals_jax(tmp_path, nproc):
    """`run_pipeline(devices=8, device="cpu", stage_a="device")` writes the
    tree of JAX's devices=8 run byte for byte (both into one path, one
    after the other), every cluster's Stage A through the sharded block
    runner: in process, and in a pool of two workers forked from the
    driver's forkserver, each handed the mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    fa = tmp_path / "two.fa"
    _two_families(fa)
    res = tmp_path / "res"
    kw = dict(input_fa=str(fa), results_dir=str(res), virus_name="two",
              coverage=0.5, min_seq_length=100, product_size=(100, 400),
              algo="v20", stage_a="device")
    jdriver.run_pipeline(None, devices=8, **kw)
    os.rename(res, tmp_path / "res_jax")
    pipe, _ = tdriver.run_pipeline(None, devices=8, device="cpu",
                                   nproc=nproc, **kw)
    want = _tree(tmp_path / "res_jax")
    got = _tree(res)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    backends = pipe._backends()
    assert backends["devices"] == 8
    assert backends["stage_a_served"] == {
        "device-sharded": len(pipe.cluster_names)}
    assert tmesh.active_mesh() is None


_SLOT = r"""
import json, sys
import torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                        world_size=2, rank=rank)
from multiprime_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
cfg = PipelineConfig()
cfg.device = "cpu"
pipe = Pipeline(cfg)
got = {"auto": pipe._resolve_cluster_shard(),
       "flag": getattr(pipe, "_shard_auto", False)}
cfg.cluster_shard = "0/1"
got["explicit"] = pipe._resolve_cluster_shard()
dist.barrier()
dist.destroy_process_group()
print(json.dumps(got))
"""


def test_resolve_cluster_shard_under_gloo_group():
    """Two CPU processes in one gloo group: each resolves its shard slot to
    (rank, 2) with no cluster_shard set, and an explicit "0/1" wins."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _SLOT, str(r), port],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert got == {"auto": [rank, 2], "flag": True, "explicit": None}
    cfg = tdriver.PipelineConfig()
    cfg.device = "cpu"
    assert tdriver.Pipeline(cfg)._resolve_cluster_shard() is None


def test_run_profile_same_tree_and_trace(tmp_path):
    """`run --profile DIR --device cpu` writes the tree of the run without
    it (into the same path, in turn) and a torch.profiler trace under
    DIR."""
    fa = tmp_path / "three.fa"
    _three_families(fa)
    res = tmp_path / "res"
    flags = ["run", "-i", str(fa), "-r", str(res), "--coverage", "0.5",
             "--device", "cpu"]
    assert tcli.main(flags) == 0
    os.rename(res, tmp_path / "res_plain")
    trace = tmp_path / "trace"
    assert tcli.main(flags + ["--profile", str(trace)]) == 0
    want = _tree(tmp_path / "res_plain")
    got = _tree(res)
    assert sorted(got) == sorted(want) and len(want) > 10
    for rel in want:
        assert got[rel] == want[rel], rel
    traces = list(trace.rglob("*.pt.trace.json"))
    assert traces and traces[0].stat().st_size > 0
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_dryrun_multichip_cpu(capsys):
    """The multi-device dry run on 4 CPU entries: every leg prints OK (the
    reference slices print skipped without a reference checkout)."""
    from multiprime_tpu_torch.parallel import dryrun
    assert dryrun.main(["4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for leg in ("dryrun_multichip OK on 4 devices", "driver-mesh OK",
                "cluster-shard OK", "composed OK", "auto-slot OK",
                "real-slice: reference test.fa not mounted, skipped",
                "golden-slice: golden tree not mounted, skipped"):
        assert leg in out, leg
