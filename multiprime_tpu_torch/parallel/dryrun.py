"""Multi-device dry run of the port: the counterpart of the JAX package's
multi-chip dry run (``dryrun_multichip`` and its slices).

    python -m multiprime_tpu_torch.parallel.dryrun N [--device cpu|cuda]
        [--reference DIR]

runs the sharded design step on an N-device mesh (N CPU entries with
``--device cpu``; N GPUs with ``cuda``, which must be present), then the
slices: a real pipeline slice and the golden-cluster slice (both read the
reference checkout given by ``--reference`` and print "skipped" without
it), and the driver's mesh run against one device, its cluster-shard
workers, two composed shard-worker processes with meshes of their own, and
two processes whose shard slots come from a torch.distributed gloo group.
Every leg holds its outputs byte-identical to the single-device ones.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _example_inputs(n=64, length=512, w=128, seed=0):
    rng = np.random.default_rng(seed)
    masks = (1 << rng.integers(0, 4, size=(n, length))).astype(np.int32)
    # sprinkle gaps
    masks[rng.random((n, length)) < 0.05] = 0
    positions = np.arange(8, 8 + w, dtype=np.int32)
    return masks, positions


def dryrun_multichip(n_devices, *, device="cuda", reference=None):
    """Run the sharded design step on an n_devices mesh of ``device``'s
    type, hold it to the unsharded Stage A, then run every slice."""
    from ..ops import design_scan
    from ..ops import mismatch_scan as ms
    from . import mesh as pmesh

    mesh = pmesh.make_mesh(n_devices, device=device)
    seq_shards = mesh.shape["seq"]
    win_shards = mesh.shape["win"]
    n = 8 * seq_shards
    w = 16 * win_shards
    masks, positions = _example_inputs(n=n, length=256, w=w)

    rng = np.random.default_rng(1)
    lut = np.array(list("ACGT"))
    n_t = 4 * seq_shards * win_shards
    targets = ["".join(rng.choice(lut, size=128)) for _ in range(n_t)]
    primers = ["".join(rng.choice(lut, size=18)) for _ in range(8)]
    # plant one exact hit so the summed coverage is observable
    targets[0] = targets[0][:40] + primers[0] + targets[0][58:]
    t1h, lengths = ms.encode_targets(targets)
    p1h = ms.encode_primers(primers)
    s1h = p1h.copy()
    s1h[:, :-4, :] = 0

    stats, hits, covered = pmesh.full_design_step(
        mesh, masks, positions, t1h, lengths, p1h, s1h)
    assert tuple(stats["freq"].shape) == (w, 18, 4)
    assert tuple(stats["viterbi"].shape) == (w, 18)
    assert int(stats["cover_number"].min()) >= 0
    assert tuple(hits.shape) == (len(primers),)
    assert int(covered) >= 1, "planted hit not found across shards"
    single = design_scan.design_stats(masks, positions, plen=18, variation=1,
                                      device=mesh.devices[0, 0])
    for key in ("freq", "nn", "cover_number", "gap_number", "viterbi"):
        assert np.array_equal(stats[key].cpu().numpy(),
                              single[key].cpu().numpy()), key
    print("dryrun_multichip OK on", n_devices, "devices:",
          "windows", w, "| covered targets", int(covered))
    _real_pipeline_slice(mesh, reference)
    _golden_cluster_slice(mesh, reference)
    _driver_mesh_run(n_devices, device)


def _golden_cluster_slice(mesh, reference):
    """Production-shape sharded slice: the golden 500-seq x 1951-col
    Cluster_0_20727 MSA through the sharded Stage-A block runner (every
    block's tensors equal to the single-device stream) and the golden core
    primer set through the sharded sparse scan against the 500 full-length
    genomes (byte-identical outputs)."""
    results = os.path.join(reference or "", "test_data", "results")
    tmsa = os.path.join(results, "Clusters_msa", "Cluster_0_20727.tmsa")
    core_fa = os.path.join(results, "Core_primers_set",
                           "core_final_maxprimers_set.fa")
    tfa = os.path.join(results, "Clusters_fa", "Cluster_0_20727.tfa")
    if not reference or not all(map(os.path.exists, (tmsa, core_fa, tfa))):
        print("golden-slice: golden tree not mounted, skipped")
        return
    from ..models import mcdpd
    from ..ops import design_scan
    from ..utils import iupac
    from ..validate import scan as vscan
    from . import mesh as pmesh

    ids, chars = mcdpd.parse_msa(tmsa)
    masks = iupac.bytes_to_masks(chars).astype(np.int32)
    assert masks.shape[0] == 500 and masks.shape[1] == 1951, masks.shape
    win_shards = mesh.shape["win"]
    w = masks.shape[1] - 18 + 1
    w -= w % win_shards
    positions = np.arange(0, w, dtype=np.int32)
    single_stream = design_scan.design_stats_blocks(
        masks, positions, device=mesh.devices[0, 0])
    sharded_stream = pmesh.design_stats_blocks_sharded(mesh, masks, positions)
    n_blocks = 0
    for (pos_a, a), (pos_b, b) in zip(single_stream, sharded_stream):
        assert np.array_equal(pos_a, pos_b)
        for key in ("freq", "nn", "cover_number", "gap_number",
                    "viterbi", "win"):
            assert np.array_equal(a[key], b[key]), \
                "golden-slice Stage-A mismatch: %s" % key
        n_blocks += 1
    with tempfile.TemporaryDirectory() as td:
        params = vscan.ScanParams(term_len=18, term=1, mm=1,
                                  product_size=(50, 2000),
                                  device_batch_seqs=64, backend="numpy")
        # vscan.run writes <primer fa stem>.term.fa beside its input:
        # never into the read-only reference tree
        local_fa = os.path.join(td, "core.fa")
        shutil.copy(core_fa, local_fa)
        out_single = os.path.join(td, "single.out")
        rows_single = vscan.run(local_fa, tfa, out_single, params,
                                device=mesh.devices[0, 0])
        out_mesh = os.path.join(td, "mesh.out")
        with pmesh.use_mesh(mesh):
            rows_mesh = vscan.run(local_fa, tfa, out_mesh, params,
                                  device=mesh.devices[0, 0])
        assert rows_single == rows_mesh
        for suffix in ("", ".pair.num", ".total.acc.num"):
            with open(out_single + suffix, "rb") as fa, \
                    open(out_mesh + suffix, "rb") as fb:
                assert fa.read() == fb.read(), \
                    "golden-slice scan differs for %r" % suffix
        assert len(rows_single) >= 400, len(rows_single)
    print("golden-slice OK: 500x1951 MSA, %d windows in %d sharded "
          "Stage-A blocks equal; sharded core-set scan %d rows "
          "byte-identical" % (w, n_blocks, len(rows_single)))


def _real_pipeline_slice(mesh, reference):
    """A pipeline slice on the mesh: the reference's test.fa -> MSA ->
    design -> sharded sparse scan -> PCR join, with byte-identical
    .out/.pair.num against the single-device path, on real ragged tensors
    (genome lengths, gap patterns, padding rows)."""
    ref = os.path.join(reference or "", "test_data", "test.fa")
    if not reference or not os.path.exists(ref):
        print("real-slice: reference test.fa not mounted, skipped")
        return
    from ..align import centerstar
    from ..models import mcdpd
    from ..ops import design_scan
    from ..utils import iupac
    from ..validate import scan as vscan
    from . import mesh as pmesh

    first = mesh.devices[0, 0]
    gene_ids, genomes = vscan.parse_fasta(ref)
    targets = [s[:2500] for s in genomes]
    ids, rows = centerstar.center_star_msa(
        ["s%d" % i for i in range(len(targets))],
        [t[:600] for t in targets], backend="numpy", device=first)
    chars = np.stack([np.frombuffer(r.encode(), np.uint8) for r in rows])
    masks_real = iupac.bytes_to_masks(chars).astype(np.int32)
    n_pad = -masks_real.shape[0] % mesh.shape["seq"]
    if n_pad:          # padding rows = all-gap sequences
        masks_real = np.concatenate(
            [masks_real, np.zeros((n_pad, masks_real.shape[1]), np.int32)])
    w_real = masks_real.shape[1] - 18
    w_real -= w_real % mesh.shape["win"]
    pos_real = np.arange(0, w_real, dtype=np.int32)
    sharded = pmesh.design_stats_sharded(mesh, masks_real, pos_real)
    single = design_scan.design_stats(masks_real, pos_real, device=first)
    for key in ("freq", "nn", "cover_number", "gap_number", "viterbi"):
        assert np.array_equal(sharded[key].cpu().numpy(),
                              single[key].cpu().numpy()), \
            "sharded Stage-A mismatch on real MSA: %s" % key

    eng = mcdpd.DesignEngine(mcdpd.DesignParams(
        coverage=0.5, min_product=100, coordinate="2,3,-1", algo="v16"))
    results = eng.design(ids, chars)
    assert results, "design produced no windows on the real MSA slice"
    results = sorted(results, key=lambda r: r.position)
    f_pool = results[:len(results) // 2] or results[:1]
    f_res = max(f_pool, key=lambda r: r.coverage)
    r_cands = [r for r in results if r.position >= f_res.position + 120]
    r_res = max(r_cands or [results[-1]], key=lambda r: r.coverage)
    with tempfile.TemporaryDirectory() as td:
        primer_fa = os.path.join(td, "primers.fa")
        with open(primer_fa, "w") as f:
            f.write(">C0_F\n%s\n>C0_R\n%s\n"
                    % (f_res.primer, iupac.rc(r_res.primer)))
        ref_fa = os.path.join(td, "targets.fa")
        with open(ref_fa, "w") as f:
            for g, t in zip(gene_ids, targets):
                f.write(">%s\n%s\n" % (g, t))
        params = vscan.ScanParams(mm=1, term=4, product_size=(100, 2000),
                                  batch_seqs=4, device_batch_seqs=8,
                                  backend="numpy")
        out_single = os.path.join(td, "single.out")
        vscan.run(primer_fa, ref_fa, out_single, params, device=first)
        out_mesh = os.path.join(td, "mesh.out")
        with pmesh.use_mesh(mesh):
            vscan.run(primer_fa, ref_fa, out_mesh, params, device=first)
        products = 0
        for suffix in ("", ".pair.num", ".total.acc.num"):
            with open(out_single + suffix, "rb") as fa, \
                    open(out_mesh + suffix, "rb") as fb:
                a = fa.read()
                assert a == fb.read(), \
                    "sharded scan output differs for %r" % suffix
            if suffix == "":
                products = len(a.splitlines()) - 1
        assert products > 0, "no PCR products: the slice missed the join"
    print("real-slice OK: %d windows designed, %d PCR products, "
          "sharded .out/.pair.num byte-identical" % (len(results), products))


def _tree_files(root, skip=("pipeline_metrics.json", ".aggregate.lock")):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), root)
            if not any(rel.endswith(s) for s in skip):
                out[rel] = os.path.join(d, name)
    return out


def _compare(one, other, label):
    want, got = _tree_files(one), _tree_files(other)
    assert sorted(want) == sorted(got), label + " trees hold other files"
    for rel, path in want.items():
        with open(path, "rb") as fa, open(got[rel], "rb") as fb:
            assert fa.read() == fb.read(), label + " tree differs: " + rel
    assert len(want) > 10, label + " compared too few files"
    return len(want)


def _two_families(path):
    rng = np.random.default_rng(17)
    lut = np.array(list("ACGT"))
    bases = ["".join(rng.choice(lut, size=500)) for _ in range(2)]
    with open(path, "w") as f:
        for b, base in enumerate(bases):
            for i in range(8):
                s = list(base)
                for _ in range(6):
                    s[rng.integers(0, len(s))] = str(rng.choice(lut))
                f.write(">%c%d\n%s\n" % (65 + b, i, "".join(s)))


def _driver_mesh_run(n_devices, device):
    """`run --devices N` (PipelineConfig.devices) on a small synthetic
    input writes the tree of --devices 1, byte for byte, with the device
    Stage A and the coverage scan routed through the mesh by the pipeline
    itself; then the cluster-shard, composed and auto-slot legs."""
    from ..pipeline.driver import run_pipeline
    td = tempfile.mkdtemp()
    try:
        fa = os.path.join(td, "two.fa")
        _two_families(fa)
        res = os.path.join(td, "res")
        kw = dict(input_fa=fa, results_dir=res, virus_name="two",
                  coverage=0.5, min_seq_length=100,
                  product_size=(100, 400), algo="v20", stage_a="device",
                  device=str(device))
        run_pipeline(None, devices=1, **kw)
        one = os.path.join(td, "res_one")
        os.rename(res, one)
        run_pipeline(None, devices=n_devices, **kw)
        n_files = _compare(one, res, "driver --devices")
        print("driver-mesh OK: run devices=%d tree byte-identical to "
              "devices=1 (%d files)" % (n_devices, n_files))
        # cluster-axis fan-out sharding: two shard runs over the shared
        # results dir, then the aggregate tail (same path: several
        # reference formats embed the output path)
        shutil.rmtree(res)
        run_pipeline(None, cluster_shard="0/2", **kw)
        run_pipeline(None, cluster_shard="1/2", **kw)
        run_pipeline(None, **kw)             # cached no-op resume
        n_files = _compare(one, res, "cluster-shard")
        print("cluster-shard OK: 0/2 + 1/2 workers + resume tree "
              "byte-identical to the sequential run (%d files)" % n_files)
        # composed: two shard-worker processes, each with a mesh of its own
        per_worker = max(2, n_devices // 2)
        shutil.rmtree(res)
        _workers([[_COMPOSED_WORKER, json.dumps(
            dict(kw, devices=per_worker, cluster_shard="%d/2" % i))]
            for i in range(2)], "composed shard workers")
        run_pipeline(None, **kw)
        n_files = _compare(one, res, "composed")
        print("composed OK: 2 shard workers x %d-device meshes + resume "
              "tree byte-identical (%d files)" % (per_worker, n_files))
        # auto-slot: cluster_shard resolved from a two-rank gloo group,
        # with no explicit i/P anywhere
        shutil.rmtree(res)
        port = _free_port()
        _workers([[_AUTOSLOT_WORKER, str(rank), port, json.dumps(kw)]
                  for rank in range(2)], "auto-slot workers")
        run_pipeline(None, **kw)
        n_files = _compare(one, res, "auto-slot")
        print("auto-slot OK: 2 torch.distributed ranks auto-partitioned the "
              "fan-out, tree byte-identical (%d files)" % n_files)
    finally:
        shutil.rmtree(td, ignore_errors=True)


_COMPOSED_WORKER = r"""
import json, sys
kw = json.loads(sys.argv[1])
kw["product_size"] = tuple(kw["product_size"])
from multiprime_tpu_torch.pipeline.driver import run_pipeline
run_pipeline(None, **kw)
print("COMPOSED-WORKER-OK", kw["cluster_shard"])
"""

_AUTOSLOT_WORKER = r"""
import json, sys
import torch.distributed as dist
rank, port, kw = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
kw["product_size"] = tuple(kw["product_size"])
dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                        world_size=2, rank=rank)
from multiprime_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
cfg = PipelineConfig()
for k, v in kw.items():
    setattr(cfg, k, v)
pipe = Pipeline(cfg)
slot = pipe._resolve_cluster_shard()    # the torch.distributed branch
assert slot == (rank, 2), slot
pipe.run()
dist.destroy_process_group()
print("AUTOSLOT-WORKER-OK", rank)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def _workers(argvs, label, timeout=600):
    """Run one `python -c` worker per argv (code first) at once, with this
    checkout first on the path; raise unless every one exits 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", *argv], env=env)
             for argv in argvs]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0] * len(procs), "%s failed: %r" % (label, codes)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "multiprime_tpu_torch.parallel.dryrun")
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--reference", metavar="DIR",
                    help="the reference checkout (test_data/...) of the "
                         "real and golden slices; they are skipped "
                         "without it")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n_devices, device=a.device, reference=a.reference)
    return 0


if __name__ == "__main__":
    sys.exit(main())
