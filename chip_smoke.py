#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (multiprime_tpu_torch).

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 chip_smoke.py [--report PATH] [--families F --members M
                           --singletons S]

Phases (each prints one line or more; any failure exits non-zero before
the final line):

1. card and build: the card's name and power limit, then nvcc builds every
   kernel in multiprime_tpu_torch/csrc from the checkout's sources, and
   each compiled kernel's registers, spills and static shared memory;
2. the hit-code kernel against its plain PyTorch version, exact int8
   equality, on an edge-case grid (plen 8-63 with K = 4 * plen off the
   32-byte k-step, P unpadded from 1 to 745, mm up to plen + 1, rows
   shorter than a window tile) and at the main path's batch shape and the
   scan cell's, with CUDA-event times of kernel, plain version and a conv1d
   yardstick;
3. find_hits_batched on the card against find_hits_numpy on the host, and
   a device scan whose hits overflow the first max_hits (the retry);
4. `run` through the CLI in a subprocess on the seeded 21k-sequence corpus
   (20 families x 1000 members + 1000 singletons, 900 bp), then the rule-19
   scan rerun on the host backend: BWT_coverage outputs byte-identical;
5. `scan` through the CLI on the run's aggregated candidate set against
   the 21k targets, device vs host byte-identical; then -m 4 on 4200
   targets on the device, held to the plain version through find_hits;
6. the match-count and bitmap kernels against their plain versions, exact,
   on edge-case grids (the bitmap on phase 2's grid, with raw IUPAC masks
   of several bases a position and with pure masks);
7. find_hits_bitmap (the two-phase scan) on the 21k targets against phase
   5's patterns, equal tuple for tuple to find_hits over the scan's
   batches; the bitmap kernel timed at that shape beside its plain version
   and a conv1d yardstick;
8. dimer_hit_matrix_fused and dimer_hit_matrix on the unique candidate
   primers (the first DIMER_PRIMERS of them), equal to each other and to
   verify_against_host on a seeded sample; the match-count kernel timed at
   the fused path's first bucket;
9. `run` again on the same corpus with device Stage A (--stage-a device)
   and the device Gotoh (align_backend: centerstar-device), into phase 4's
   results path: every output file byte-identical to phase 4's (but
   pipeline_metrics.json and logs), Stage A and the align DP served by the
   card; both runs' stage seconds;
10. the device torch ops on the largest cluster of that run, each equal
   to its counterpart and timed: design_stats_blocks on the card vs the
   CPU (and the cluster's design with host vs device Stage A);
   align_ops_batch_device vs native.gotoh_ops_batch and
   refine_pass_device vs native.refine_realign on its members with seeded
   indels (one 512-member Gotoh block timed); CUDA launches and device
   busy time of one block each (torch.profiler), peak device memory;
11. `specificity` through the CLI against a seeded background of about
   64 Mb (15 x 4 Mb and one shorter sequence, so that the scan's last
   batch holds padding rows) holding 200 planted amplicons of phase 5's
   candidate pairs, 30 of them across a multiple of the segment stride:
   on the card and on the host backend (MPTPU_FORCE_BACKEND=host), with
   and without --exhaustive-join, every output byte-identical between the
   two, at least 150 plants in the exhaustive .out; the hit-code kernel
   held to its plain version on the scan's last batch (padding rows
   included) and timed there with the find_hits compaction (16 segments
   of 65,536 bases x the 18-base keys);
12. `update -f DO` (phase 4's final set as the core; the candidate pairs of
   two family clusters not in the panel, the smallest such candidate sets,
   as the new set; the formatted 21k targets as the reference DB) and
   `nondimer-filter`, card vs host backend, byte-identical;
13. `onestep` on the largest family cluster, card vs host backend, into the
   same path, every file byte-identical;
14. the kernels line.

The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is available or the package is not beside this script.
"""

import argparse
import filecmp
import glob
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense int8 tensor-core rate
BF16_OPS_PER_S = 0.989e15      # H100 SXM dense bf16 tensor-core rate
DEVICE = "cuda"
# the dimer phase's cap on unique primers: 2,000 and 8,000 are the scales
# at which the JAX package's ops/dimer.py was measured
DIMER_PRIMERS = 8000


def fail(msg):
    print("FAIL: " + msg, flush=True)
    sys.exit(1)


def say(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn() in ms over iters calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def random_seqs(rng, n, lo, hi, letters="ACGT"):
    lut = np.array(list(letters))
    return ["".join(rng.choice(lut, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def mutate(rng, s, k, letters="ACGT"):
    s = list(s)
    for _ in range(k):
        s[int(rng.integers(0, len(s)))] = str(rng.choice(list(letters)))
    return "".join(s)


def pattern_onehots(ms, patterns, term):
    """(p1h, s1h) exactly as validate.scan.scan_hits builds them, padded to
    a multiple of 8 with zero rows."""
    p1h = ms.encode_primers(patterns)
    s1h = p1h.copy()
    if term > 0:
        s1h[:, :-term, :] = 0
    else:
        s1h[:] = 0
    pad = -p1h.shape[0] % 8
    if pad:
        z = np.zeros((pad,) + p1h.shape[1:], p1h.dtype)
        p1h, s1h = np.concatenate([p1h, z]), np.concatenate([s1h, z])
    return p1h, s1h


def planted_patterns(rng, seqs, n, plen, degenerate=True):
    """Patterns cut from the targets with 0-3 substitutions (some with
    IUPAC codes), so that scans find hits."""
    out = []
    for _ in range(n):
        s = seqs[int(rng.integers(0, len(seqs)))]
        if len(s) < plen:
            out.append(random_seqs(rng, 1, plen, plen)[0])
            continue
        o = int(rng.integers(0, len(s) - plen + 1))
        pat = mutate(rng, s[o:o + plen].upper().replace("N", "A"),
                     int(rng.integers(0, 4)))
        if degenerate and rng.random() < 0.3:
            pat = mutate(rng, pat, 1, letters="RYSWKM")
        out.append(pat)
    return out


# the tile edges of the tensor-core kernels: K = 4 * plen not a multiple of
# 32 (plen 9, 33, 63), P unpadded around the 8-pattern n-tiles and the
# pattern passes, mm at and past plen, rows shorter than a window tile
GRID_PLENS = (8, 9, 18, 20, 32, 33, 63)
GRID_PS = (1, 8, 9, 255, 257, 745, 7, 45, 130)


def edge_grid(rng):
    """(plen, mm, term, P, shortest row, longest row) of the kernel grids:
    every plen with mm 0-4, plen and plen + 1 (below 64, the plain hit
    codes' limit) and term 0, 1, 4 and plen + 1; P cycles through GRID_PS,
    every third case has rows of plen to plen + 12 bases (less than one
    window tile)."""
    out = []
    for plen in GRID_PLENS:
        mms = [mm for mm in (0, 1, 2, 3, 4, plen, plen + 1) if mm < 64]
        for mm in mms:
            for term in (0, 1, 4, plen + 1):
                i = len(out)
                lo, hi = ((plen, plen + 12) if i % 3 == 0
                          else (max(1, plen - 3), 600))
                out.append((plen, mm, term, GRID_PS[i % len(GRID_PS)], lo,
                            hi))
    rng.shuffle(out)
    return out


def grid_patterns(ms, rng, seqs, n_pat, plen, term):
    """n_pat planted patterns (one in five cases led by an all-N pattern,
    which matches nothing), unpadded, as one-hots and suffix one-hots."""
    pats = planted_patterns(rng, seqs, n_pat, plen)
    if n_pat > 1 and rng.random() < 0.2:
        pats[0] = "N" * plen
    p1h, s1h = pattern_onehots(ms, pats, term)
    return p1h[:n_pat], s1h[:n_pat]


def phase_build(args, report):
    from multiprime_tpu_torch.ops import _cuda
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail("nvidia-smi failed: " + smi.stderr)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    report["card"] = card
    t0 = time.time()
    _cuda.build(force=True)
    report["build_s"] = round(time.time() - t0, 3)
    say("phase 1 build: %.2f s for %s" % (report["build_s"],
                                          sorted(_cuda.BUILD_LOG)))
    report["ptxas"] = {}
    for name, log in sorted(_cuda.BUILD_LOG.items()):
        for entry in ptxas_entries(log):
            say("  ptxas %s%s: %d registers, %d B spill stores, %d B spill "
                "loads, %d B static shared memory" % (
                    name, entry["template"], entry["registers"],
                    entry["spill_stores"], entry["spill_loads"],
                    entry["smem"]))
            report["ptxas"].setdefault(name, []).append(entry)


def ptxas_entries(log):
    """One dict per compiled kernel of nvcc's -Xptxas -v output: its
    template argument (the k-steps of a tensor-core kernel), registers,
    spill stores and loads, static shared memory."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            ks = re.search(r"ILi(\d+)E", m.group(1))
            cur = {"template": " KS=%s" % ks.group(1) if ks else "",
                   "registers": 0, "spill_stores": 0, "spill_loads": 0,
                   "smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def phase_kernel(args, report):
    import torch
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(args.seed)
    cases = 0
    for plen, mm, term, n_pat, lo, hi in edge_grid(rng):
        seqs = random_seqs(rng, int(rng.integers(1, 40)), lo, hi,
                           letters="ACGTacgtNRY-")
        p1h, s1h = grid_patterns(ms, rng, seqs, n_pat, plen, term)
        masks, _ = ms.encode_target_masks(seqs)
        tm = torch.from_numpy(masks).to(dev)
        planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
        got = ms.hit_codes(tm, planes, sfx, plen=plen, mm=mm, term=term)
        want = ms.hit_codes_reference(tm, planes, sfx, plen=plen, mm=mm,
                                      term=term)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail("hit_codes differs from the plain version at plen=%d "
                 "mm=%d term=%d N=%d L=%d P=%d" % (
                     plen, mm, term, len(seqs), masks.shape[1],
                     planes.shape[0]))
        cases += 1
    say("phase 2 grid: %d cases equal (exact int8)" % cases)

    # the main path's batch shape: rule-19 scan of a 2000-pattern set
    plen, mm, term, p, length = 18, 1, 1, 2000, 1024
    n = ms.safe_batch_size(2048, length - plen + 1, p)
    seqs = random_seqs(rng, n, 850, 950, letters="ACGTACGTACGTN")
    pats = planted_patterns(rng, seqs, p, plen)
    p1h, s1h = pattern_onehots(ms, pats, term)
    masks, _ = ms.encode_target_masks(seqs, length=length)
    report["hit_codes"] = measure_kernel(ms, masks, p1h, s1h, mm, term,
                                         "phase 2 main shape")
    # the scan cell's batch shape: 744 patterns (742 keys padded to 8), the
    # batch size the scan takes for them (40 launches over the 21k targets)
    p = 744
    n = ms.safe_batch_size(2048, length - plen + 1, p)
    seqs = random_seqs(rng, n, 850, 950, letters="ACGTACGTACGTN")
    p1h, s1h = pattern_onehots(ms, planted_patterns(rng, seqs, p, plen),
                               term)
    masks, _ = ms.encode_target_masks(seqs, length=length)
    report["hit_codes_scan_shape"] = measure_kernel(
        ms, masks, p1h, s1h, mm, term, "phase 2 scan shape")


def bound(n_bytes, ops, ops_per_s):
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the peak rate of their type."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes, "ops": ops}


def measure_kernel(ms, masks, p1h, s1h, mm, term, label):
    """Kernel vs plain version (exact) on one batch, then CUDA-event times
    of the kernel, the plain version and a conv1d yardstick, beside the
    least time the card could take (bytes or int8 operations)."""
    import torch
    dev = torch.device(DEVICE)
    plen = p1h.shape[1]
    tm = torch.from_numpy(masks).to(dev)
    planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
    got = ms.hit_codes(tm, planes, sfx, plen=plen, mm=mm, term=term)
    want = ms.hit_codes_reference(tm, planes, sfx, plen=plen, mm=mm,
                                  term=term)
    torch.cuda.synchronize()
    max_err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    if max_err != 0:
        fail("hit_codes differs from the plain version at the %s" % label)
    n, length = masks.shape
    n_out, p_all = got.shape[1], got.shape[2]
    hits = int((got > 0).sum())
    del got, want
    kernel_ms = cuda_ms(lambda: ms.hit_codes(tm, planes, sfx, plen=plen,
                                             mm=mm, term=term), 20)
    plain_ms = cuda_ms(lambda: ms.hit_codes_reference(
        tm, planes, sfx, plen=plen, mm=mm, term=term), 3)
    # yardstick: one conv1d over the combined weight plus its threshold
    x = ms.expand_masks(tm).permute(0, 2, 1).to(torch.float32).contiguous()
    weight = (ms._unpack_planes(planes, plen)
              + 64 * ms._unpack_planes(sfx, plen)).contiguous()
    thresh = 64 * term + plen - mm

    def library():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            score = torch.nn.functional.conv1d(x, weight)
        return torch.where(score >= thresh, plen + 1 + 64 * term - score,
                           0).to(torch.int8)
    library_ms = cuda_ms(library, 3)
    # each input read once (masks, both plane sets), the codes written once;
    # operations of the int8-matmul form: one [N*O, 4*plen] x [4*plen, P]
    # over the combined weight primers + 64 * suffix, which gives the codes
    in_bytes = n * length + 2 * planes.numel() * 8
    out_bytes = n * n_out * p_all
    ops = 2 * n * n_out * p_all * 4 * plen
    out = {"shape": {"N": n, "L": length, "O": n_out, "P": p_all,
                     "plen": plen, "mm": mm, "term": term},
           "hits": hits, "max_abs_err": max_err, "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           **bound(in_bytes + out_bytes, ops, INT8_OPS_PER_S)}
    say("%s N=%d L=%d O=%d P=%d plen=%d mm=%d term=%d: equal, %d hits; "
        "kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f bound_ms=%.4f (%s)"
        % (label, n, length, n_out, p_all, plen, mm, term, hits, kernel_ms,
           plain_ms, library_ms, out["bound_ms"], out["bound_by"]))
    return out


def phase_find_hits(args, report):
    import torch
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.validate import scan as vscan
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(args.seed + 1)
    plen, mm, term, bs, b = 20, 2, 3, 64, 3
    seqs = random_seqs(rng, bs * b - 5, 100, 1000, letters="ACGTACGTACGTNa")
    pats = planted_patterns(rng, seqs, 250, plen)
    p1h, s1h = pattern_onehots(ms, pats, term)
    masks, lens = ms.encode_target_masks(seqs, length=1024)
    tm = np.zeros((b * bs, 1024), np.uint8)
    lm = np.zeros(b * bs, np.int32)
    tm[:len(seqs)], lm[:len(seqs)] = masks, lens
    planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
    max_hits = 1 << 14
    packs = ms.find_hits_batched(
        torch.from_numpy(tm.reshape(b, bs, -1)).to(dev),
        torch.from_numpy(lm.reshape(b, bs)).to(dev), planes, sfx, plen=plen,
        mm=mm, term=term, max_hits=max_hits, want_mism=True).cpu().numpy()
    n_out, p_all = 1024 - plen + 1, p1h.shape[0]
    got = []
    for bi in range(b):
        seq, pos, pat, mis, n_hits = ms.decode_packed(packs[bi], n_out,
                                                      p_all, max_hits)
        if n_hits > max_hits:
            fail("phase 3 batch overflowed its max_hits")
        got.extend(zip((seq + bi * bs).tolist(), pos.tolist(), pat.tolist(),
                       mis.tolist()))
    t1h, _ = ms.encode_targets(seqs, length=1024)
    want = [tuple(int(v) for v in row) for row in ms.find_hits_numpy(
        t1h, lens, p1h, s1h, mm=mm, term=term)]
    if got != want:
        fail("find_hits_batched differs from find_hits_numpy (%d vs %d hits)"
             % (len(got), len(want)))
    say("phase 3 find_hits_batched == find_hits_numpy: %d hits" % len(got))
    # a scan whose first max_hits (2**17) overflows: the retry path
    # 8 patterns hitting every window of the 40 poly-A rows: 314k hits
    dense = ["A" * 1000] * 40 + random_seqs(rng, 24, 900, 1000)
    pats = ["A" * 18] + ["A" * k + "C" + "A" * (17 - k) for k in range(7)]
    dev_hits = vscan.scan_hits(dense, pats, vscan.ScanParams(
        mm=1, term=1, backend="device", want_mism=True), device=dev)
    host_hits = vscan.scan_hits(dense, pats, vscan.ScanParams(
        mm=1, term=1, backend="numpy"), device=dev)
    if dev_hits != host_hits or len(dev_hits) <= 1 << 17:
        fail("retry scan: %d device hits vs %d host hits"
             % (len(dev_hits), len(host_hits)))
    say("phase 3 retry scan (n_hits > 2**17): %d hits equal to the host"
        % len(dev_hits))
    report["find_hits"] = {"hits": len(got), "retry_hits": len(dev_hits)}


def generate_corpus(fa_path, seed, n_fams, members, singletons):
    """The 21k scale corpus: n_fams families x members (900 bp; divergence
    cycling 1/2/5/8%, every tenth member an exact copy of the family base)
    + singletons random 900 bp sequences."""
    rng = np.random.default_rng(seed)
    lut = np.array(list("ACGT"))
    with open(fa_path, "w") as f:
        divergences = (0.01, 0.02, 0.05, 0.08)
        for fam in range(n_fams):
            div = divergences[fam % len(divergences)]
            base = np.frombuffer(
                "".join(rng.choice(lut, size=900)).encode(), np.uint8).copy()
            for m in range(members):
                if m % 10 == 0:
                    arr = base
                else:
                    arr = base.copy()
                    mut = rng.random(len(arr)) < div
                    arr[mut] = np.frombuffer("".join(
                        rng.choice(lut, size=int(mut.sum()))).encode(),
                        np.uint8)
                f.write(">F%d_%d\n%s\n" % (fam, m, arr.tobytes().decode()))
        for s in range(singletons):
            f.write(">S%d\n%s\n"
                    % (s, "".join(rng.choice(lut, size=900))))


SCAN_SUFFIXES = ("", ".pair.num", ".total.acc.num", ".unmatched.fa")


def same_outputs(a, b):
    for suffix in SCAN_SUFFIXES:
        pa, pb = a + suffix, b + suffix
        if os.path.exists(pa) != os.path.exists(pb):
            return suffix
        if os.path.exists(pa):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    return suffix
    return None


def phase_run(args, report, work):
    import torch
    from multiprime_tpu_torch.validate import scan as vscan
    fa = os.path.join(work, "scale21k.fa")
    t0 = time.time()
    generate_corpus(fa, args.seed, args.families, args.members,
                    args.singletons)
    n_seqs = args.families * args.members + args.singletons
    cut = (args.families, args.members, args.singletons) != (20, 1000, 1000)
    say("phase 4 corpus: %d families x %d members + %d singletons = %d "
        "sequences, 900 bp (%.1f s)%s" % (
            args.families, args.members, args.singletons, n_seqs,
            time.time() - t0, " [CUT from 20 x 1000 + 1000]" if cut else ""))
    res = os.path.join(work, "res")
    log_path = os.path.join(work, "run.log")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    nproc = os.cpu_count() or 1
    cmd = [sys.executable, "-m", "multiprime_tpu_torch.cli.main", "run",
           "-i", fa, "-r", res, "--device", DEVICE, "--pcr-products",
           "summary", "--nproc", str(nproc)]
    # the run is a process of its own: its kernel launch count starts at 0
    # there and comes back in pipeline_metrics.json
    t0 = time.time()
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=HERE, env=env, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    wall = time.time() - t0
    if rc != 0:
        with open(log_path) as log:
            tail = log.read()[-4000:]
        fail("run exited %d:\n%s" % (rc, tail))
    with open(os.path.join(res, "pipeline_metrics.json")) as f:
        metrics = json.load(f)
    backends = metrics["backends"]
    launches = int(backends.get("hit_codes_launches", 0))
    say("phase 4 run: %.1f s wall, nproc=%d, scan_backend=%s, device=%s, "
        "hit_codes launches=%d" % (wall, nproc, backends.get("scan_backend"),
                                   backends.get("device_name"), launches))
    say("phase 4 stages (s): " + json.dumps(metrics["timings_s"]))
    if launches <= 0 or backends.get("scan_backend") != "device":
        fail("run did not scan through the hit_codes kernel")
    # rerun the rule-19 scan on the host backend: byte-identical outputs
    core_fa = os.path.join(res, "Core_primers_set",
                           "core_final_maxprimers_set.fa")
    name = "core_final_maxprimers_set.out"
    if not os.path.exists(core_fa):
        core_fa = os.path.join(res, "Primers_set", "final_maxprimers_set.fa")
        name = "final_maxprimers_set.out"
    dev_out = os.path.join(res, "Core_primers_set", "BWT_coverage", name)
    host_out = os.path.join(work, "host_bwt", name)
    os.makedirs(os.path.dirname(host_out))
    fmt_fa = os.path.join(res, "Total_fa", "scale21k.format.fa")
    with open(os.path.join(res, "Total_fa", "scale21k.format.dict"),
              "rb") as f:
        targets_dict = pickle.load(f)
    params = vscan.ScanParams(term_len=18, term=1, mm=1,
                              product_size=(50, 2000), backend="numpy")
    t0 = time.time()
    vscan.run(core_fa, fmt_fa, host_out, params, targets_dict,
              device=torch.device(DEVICE))
    host_s = time.time() - t0
    diff = same_outputs(dev_out, host_out)
    if diff is not None:
        fail("BWT_coverage %s%s differs between device and host scans"
             % (name, diff))
    with open(dev_out) as f:
        rows = sum(1 for _ in f) - 1
    say("phase 4 BWT_coverage/%s: device == host byte for byte (%d rows; "
        "host rescan %.2f s, device scan stage %.2f s)"
        % (name, rows, host_s, metrics["timings_s"].get("scan", -1)))
    report["run"] = {"wall_s": wall, "nproc": nproc, "n_seqs": n_seqs,
                     "cut": cut, "timings_s": metrics["timings_s"],
                     "launches": launches, "bwt_rows": rows,
                     "host_rescan_s": host_s}
    # the kernel at the shape this run's rule-19 scan gave it: the first
    # target batch of the formatted corpus against the core set's patterns
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    pats, _, keys, _ = vscan.expand_primer_fasta(core_fa, 18, None,
                                                 with_keys=True)
    p1h, s1h = pattern_onehots(ms, keys if keys is not None else pats, 1)
    _, seqs = vscan.parse_fasta(fmt_fa)
    longest = max(map(len, seqs))
    pad_len = max(-longest % 512 + longest, 512)
    bs = ms.safe_batch_size(2048, pad_len - p1h.shape[1] + 1, p1h.shape[0])
    masks, _ = ms.encode_target_masks(seqs[:bs], length=pad_len)
    report["hit_codes_run_shape"] = measure_kernel(
        ms, masks, p1h, s1h, 1, 1, "phase 4 kernel at the run's shape")
    return res, launches


def phase_scan(args, report, work, res):
    import torch
    from multiprime_tpu_torch.cli import main as cli
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.validate import scan as vscan
    dev = torch.device(DEVICE)
    # the candidate sets of the multi-member clusters (file names end in
    # _<members>.candidate.primers.fa); each singleton cluster adds some
    # hundreds of primers of its own single sequence, about 2e5 in all at
    # full size, which is no primer panel a user validates
    primers = os.path.join(work, "candidates.fa")
    n_files = 0
    with open(primers, "w") as out:
        for path in sorted(glob.glob(os.path.join(
                res, "Primers_set", "candidate_primers_sets",
                "*.candidate.primers.fa"))):
            members = int(os.path.basename(path).split(".")[0]
                          .rsplit("_", 1)[1])
            if members > 1:
                n_files += 1
                with open(path) as f:
                    out.write(f.read())
    with open(primers) as f:
        n_primers = sum(1 for line in f if line.startswith(">"))
    if n_primers == 0:
        fail("no candidate primers in the run's multi-member clusters")
    fmt_fa = os.path.join(res, "Total_fa", "scale21k.format.fa")
    ids, seqs = vscan.parse_fasta(fmt_fa)
    flags = ["-i", primers, "-r", fmt_fa, "-l", "18", "-t", "1", "-m", "1",
             "-s", "50,2000"]
    outs, walls, peaks = {}, {}, {}
    for backend in ("device", "numpy"):
        outs[backend] = os.path.join(work, "scan_" + backend, "cov.out")
        os.makedirs(os.path.dirname(outs[backend]))
        ms.HIT_CODES_LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        rc = cli.main(["scan", *flags, "-o", outs[backend], "--backend",
                       backend, "--device", DEVICE])
        torch.cuda.synchronize()
        walls[backend] = time.time() - t0
        peaks[backend] = torch.cuda.max_memory_allocated()
        if rc != 0:
            fail("scan --backend %s exited %d" % (backend, rc))
        if backend == "device" and ms.HIT_CODES_LAUNCHES <= 0:
            fail("scan did not launch the hit_codes kernel")
        launches = ms.HIT_CODES_LAUNCHES if backend == "device" else 0
        say("phase 5 scan --backend %s: %.2f s wall, peak device memory "
            "%.1f MiB, hit_codes launches %d" % (
                backend, walls[backend], peaks[backend] / 2 ** 20,
                launches))
    diff = same_outputs(outs["device"], outs["numpy"])
    if diff is not None:
        fail("scan outputs differ between device and host: cov.out" + diff)
    say("phase 5 scan: %d candidate primers of %d clusters x %d targets, "
        "device == host byte for byte"
        % (n_primers, n_files, len(ids)))
    # -m 4 on 4200 targets, device only; held to the plain version
    sub = os.path.join(work, "targets4200.fa")
    with open(sub, "w") as f:
        for i, s in zip(ids[:4200], seqs[:4200]):
            f.write(">%s\n%s\n" % (i, s))
    out4 = os.path.join(work, "scan_mm4", "cov.out")
    os.makedirs(os.path.dirname(out4))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rc = cli.main(["scan", "-i", primers, "-r", sub, "-l", "18", "-t", "1",
                   "-m", "4", "-s", "50,2000", "-o", out4, "--device",
                   DEVICE])
    torch.cuda.synchronize()
    wall4 = time.time() - t0
    peak4 = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail("scan -m 4 exited %d" % rc)
    pats, _, keys, _ = vscan.expand_primer_fasta(primers, 18, None,
                                                 with_keys=True)
    if keys is not None:
        pats = keys
    p1h, s1h = pattern_onehots(ms, pats, 1)
    planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
    seqs = seqs[:4200]
    pad_len = max(-max(map(len, seqs)) % 512 + max(map(len, seqs)), 512)
    bs = ms.safe_batch_size(2048, pad_len - 18 + 1, p1h.shape[0])
    total = 0
    for lo in range(0, len(seqs), bs):
        masks, lens = ms.encode_target_masks(seqs[lo:lo + bs], pad_len)
        tm = torch.from_numpy(masks).to(dev)
        tl = torch.from_numpy(lens).to(dev)
        got = ms.find_hits(tm, tl, planes, sfx, plen=18, mm=4, term=1,
                           max_hits=1 << 20)
        want = ms.find_hits_from_codes(
            ms.hit_codes_reference(tm, planes, sfx, plen=18, mm=4, term=1),
            tl, plen=18, max_hits=1 << 20)
        if int(got[1]) > 1 << 20 or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            fail("-m 4 find_hits differs from the plain version at rows "
                 "%d..%d" % (lo, lo + bs))
        total += int(got[1])
    say("phase 5 scan -m 4: %d patterns x 4200 targets in %.2f s wall, "
        "peak device memory %.1f MiB; find_hits == plain version (%d hits "
        "forward)" % (len(pats), wall4, peak4 / 2 ** 20, total))
    report["scan"] = {"n_primers": n_primers, "wall_s": walls,
                      "peak_bytes": peaks, "mm4_wall_s": wall4,
                      "mm4_peak_bytes": peak4, "mm4_patterns": len(pats),
                      "mm4_hits_forward": total}
    return primers, pats


def phase_new_kernels(args, report):
    """The match-count and bitmap kernels against their plain versions on
    edge-case grids: exact equality (float32 counts bit for bit, int8
    bitmaps)."""
    import torch
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(args.seed + 2)
    cases = 0
    # plen 5..32 as the ends are, lp up to 64 as the fused path pads them:
    # random 4-bit masks (pure, ambiguous, multi-base, empty), one-hot
    # patterns with zero left-padding columns, N and P off every tile
    for plen in (5, 8, 13, 18, 24, 32, 40, 48, 57, 64):
        for n_pat in (1, 7, 77, 257, 513):
            n = int(rng.integers(1, 40))
            length = int(rng.integers(plen, plen + 300))
            masks = torch.from_numpy(rng.integers(
                0, 16, size=(n, length)).astype(np.uint8)).to(dev)
            p1h = rng.integers(0, 2, size=(n_pat, plen, 4)).astype(np.uint8)
            for row in p1h:
                row[:int(rng.integers(0, plen))] = 0
            planes = ms.pattern_planes(p1h, device=dev)
            got = ms.match_counts_kernel(masks, planes, plen=plen)
            want = ms.match_counts_reference(masks, planes, plen=plen)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                fail("match_counts differs from the plain version at plen=%d"
                     " N=%d L=%d P=%d" % (plen, n, length, n_pat))
            cases += 1
    say("phase 6 match_counts grid: %d cases equal (float32 bit for bit)"
        % cases)
    cases = 0
    for plen, mm, term, n_pat, lo, hi in edge_grid(rng):
        seqs = random_seqs(rng, int(rng.integers(1, 40)), lo, hi,
                           letters="ACGTacgtNRY-")
        p1h, s1h = grid_patterns(ms, rng, seqs, n_pat, plen, term)
        # the raw IUPAC masks: N, R and Y are several bases a position,
        # each counted where the pattern shares it; then the pure masks
        masks, _ = ms.encode_target_masks(seqs)
        tm = torch.from_numpy(masks).to(dev)
        planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
        kw = dict(plen=plen, mm=mm, term=term)
        for t in (tm, ms.pure_masks(tm)):
            got = ms.hit_window_bitmap_kernel(t, planes, sfx, **kw)
            want = ms.hit_window_bitmap_reference(t, planes, sfx, **kw)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                fail("hit_window_bitmap differs from the plain version at "
                     "plen=%d mm=%d term=%d N=%d L=%d P=%d"
                     % (plen, mm, term, len(seqs), masks.shape[1],
                        planes.shape[0]))
            cases += 1
    say("phase 6 hit_window_bitmap grid: %d cases equal (exact int8; "
        "targets with several bases a position)" % cases)


def phase_bitmap(args, report, res, pats):
    """The two-phase scan at full size: find_hits_bitmap on the formatted
    corpus against phase 5's patterns, held to find_hits over the scan's
    batches; then the bitmap kernel timed at that shape."""
    import torch
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.validate import scan as vscan
    dev = torch.device(DEVICE)
    plen, mm, term = 18, 1, 1
    _, seqs = vscan.parse_fasta(os.path.join(res, "Total_fa",
                                             "scale21k.format.fa"))
    longest = max(map(len, seqs))
    pad_len = max(-longest % 512 + longest, 512)
    p1h, s1h = pattern_onehots(ms, pats, term)
    t1h, lens = ms.encode_targets(seqs, length=pad_len)
    # the path: one call, its launches counted from 0
    ms.HIT_WINDOW_BITMAP_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.time()
    got = ms.find_hits_bitmap(t1h, lens, p1h, s1h, mm=mm, term=term,
                              device=dev)
    wall = time.time() - t0
    launches = ms.HIT_WINDOW_BITMAP_LAUNCHES
    if launches <= 0:
        fail("find_hits_bitmap did not launch the hit_window_bitmap kernel")
    del t1h
    # find_hits (the hit-code kernel) over the batches of the scan
    n_out, p_all = pad_len - plen + 1, p1h.shape[0]
    # pure masks: the base sets find_hits_bitmap gives its kernel
    masks, _ = ms.encode_target_codes(seqs, length=pad_len)
    tm = torch.from_numpy(masks).to(dev)
    tl = torch.from_numpy(lens).to(dev)
    planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
    bs = ms.safe_batch_size(2048, n_out, p_all)
    max_hits = 1 << 21
    want = [[], [], [], []]
    t0 = time.time()
    for lo in range(0, len(seqs), bs):
        idx, n_hits, mism = ms.find_hits(tm[lo:lo + bs], tl[lo:lo + bs],
                                         planes, sfx, plen=plen, mm=mm,
                                         term=term, max_hits=max_hits)
        if int(n_hits) > max_hits:
            fail("phase 7 find_hits batch overflowed its max_hits")
        parts = ms.decode_hits(idx.cpu().numpy(), mism.cpu().numpy(), n_out,
                               p_all)
        for dst, part in zip(want, (parts[0] + lo,) + parts[1:]):
            dst.append(part)
    dense_wall = time.time() - t0
    want = [np.concatenate(part) for part in want]
    for name, g, w in zip(("seq", "window", "primer", "mism"), got, want):
        if not np.array_equal(g, w):
            fail("find_hits_bitmap %s differs from find_hits (%d vs %d hits)"
                 % (name, len(got[0]), len(want[0])))
    bm = ms.hit_window_bitmap(tm, tl, planes, sfx, plen=plen, mm=mm,
                              term=term)
    flagged = int(bm.sum())
    say("phase 7 find_hits_bitmap: %d targets x %d patterns, %.2f s wall, "
        "%d launch(es), %d flagged windows, %d hits == find_hits over %d "
        "batches (%.2f s wall)" % (len(seqs), p_all, wall, launches, flagged,
                                   len(got[0]), -(-len(seqs) // bs),
                                   dense_wall))
    report["bitmap_path"] = {"wall_s": wall, "launches": launches,
                             "flagged_windows": flagged, "hits": len(got[0]),
                             "find_hits_wall_s": dense_wall}
    report["hit_window_bitmap"] = measure_bitmap(ms, tm, planes, sfx, plen,
                                                 mm, term, bs)
    report["hit_window_bitmap"]["launches"] = launches


def measure_bitmap(ms, tm, planes, sfx, plen, mm, term, bs):
    """The bitmap kernel on the whole corpus (pure masks) vs its plain
    version (exact), then CUDA-event times of kernel, plain version and a
    conv1d + threshold + amax yardstick (all over the scan's batches: one
    [N, O, P] float32 tensor at full size would not fit), beside the bound.
    The operations counted are those this data needs, from the plain hit
    codes: every pattern for a window with no hit, up to the first hit for
    the others."""
    import torch
    n, length = tm.shape
    n_out, p_all = length - plen + 1, planes.shape[0]
    kw = dict(plen=plen, mm=mm, term=term)
    got = ms.hit_window_bitmap_kernel(tm, planes, sfx, **kw)
    pairs, max_err = 0, 0
    for lo in range(0, n, bs):
        hits = ms.hit_codes_reference(tm[lo:lo + bs], planes, sfx, **kw) > 0
        want = hits.any(dim=2)
        first = hits.to(torch.uint8).argmax(dim=2)
        pairs += int(torch.where(want, first + 1, p_all).sum())
        del hits, want, first
        want = ms.hit_window_bitmap_reference(tm[lo:lo + bs], planes, sfx,
                                              **kw)
        max_err = max(max_err, int((got[lo:lo + bs].int() - want.int())
                                   .abs().max()))
        del want
    if max_err != 0:
        fail("hit_window_bitmap differs from the plain version on the corpus "
             "(max abs error %d)" % max_err)
    kernel_ms = cuda_ms(lambda: ms.hit_window_bitmap_kernel(
        tm, planes, sfx, **kw), 5)

    def plain():
        for lo in range(0, n, bs):
            ms.hit_window_bitmap_reference(tm[lo:lo + bs], planes, sfx, **kw)
    plain_ms = cuda_ms(plain, 1)
    weight = (ms._unpack_planes(planes, plen)
              + 64 * ms._unpack_planes(sfx, plen)).contiguous()
    thresh = 64 * term + plen - mm

    def library():
        for lo in range(0, n, bs):
            x = ms.expand_masks(tm[lo:lo + bs]).permute(0, 2, 1).to(
                torch.float32)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                score = torch.nn.functional.conv1d(x, weight)
            (score >= thresh).amax(dim=1).to(torch.int8)
    library_ms = cuda_ms(library, 1)
    # masks in, both plane sets, the bitmap out; operations: one int8
    # product over the combined weight primers + 64 * suffix (values up to
    # 65; on pure targets counts stay below 64, so the score decodes) for
    # the pairs this data needs
    out = {"shape": {"N": n, "L": length, "O": n_out, "P": p_all,
                     "plen": plen, "mm": mm, "term": term},
           "pairs_needed": pairs, "pairs_all": n * n_out * p_all,
           "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           **bound(n * length + 2 * planes.numel() * 8 + n * n_out,
                   2 * pairs * 4 * plen, INT8_OPS_PER_S)}
    say("phase 7 bitmap kernel N=%d L=%d O=%d P=%d: equal; pairs needed "
        "%d of %d; kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f "
        "bound_ms=%.4f (%s)" % (n, length, n_out, p_all, pairs,
                                out["pairs_all"], kernel_ms, plain_ms,
                                library_ms, out["bound_ms"], out["bound_by"]))
    return out


def phase_dimer(args, report, primers_fa):
    """The dimer matrix at full size on the unique candidate primers: the
    fused and unfused device paths equal to each other and to the host
    search on a seeded sample; then the match-count kernel timed at the
    fused path's first bucket."""
    import torch
    from multiprime_tpu_torch.ops import dimer
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.validate import scan as vscan
    dev = torch.device(DEVICE)
    _, seqs = vscan.parse_fasta(primers_fa)
    uniq = list(dict.fromkeys(seqs))
    primers = uniq[:DIMER_PRIMERS]
    cut = "" if len(primers) == len(uniq) else (
        " [CUT from %d unique primers]" % len(uniq))
    walls, launches = {}, {}
    t_phase = time.time()
    mats = {}
    for fn in ("dimer_hit_matrix_fused", "dimer_hit_matrix"):
        ms.MATCH_COUNTS_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.time()
        mats[fn] = getattr(dimer, fn)(primers, device=dev)
        torch.cuda.synchronize()
        walls[fn] = time.time() - t0
        launches[fn] = ms.MATCH_COUNTS_LAUNCHES
        if launches[fn] <= 0:
            fail("%s did not launch the match_counts kernel" % fn)
    if not np.array_equal(mats["dimer_hit_matrix_fused"],
                          mats["dimer_hit_matrix"]):
        fail("dimer_hit_matrix_fused and dimer_hit_matrix differ")
    hit = mats["dimer_hit_matrix_fused"]
    rng = np.random.default_rng(args.seed + 3)
    sample = np.sort(rng.choice(len(primers), size=min(120, len(primers)),
                                replace=False))
    t0 = time.time()
    host = dimer.verify_against_host([primers[i] for i in sample])
    host_s = time.time() - t0
    if not np.array_equal(hit[np.ix_(sample, sample)], host):
        fail("dimer matrix differs from verify_against_host on the sample")
    lay = dimer.fused_layout(primers)
    n_t, n_e = lay["masks"].shape[0], lay["p1h"].shape[0]
    say("phase 8 dimer: P=%d primers%s, T=%d expanded targets, E=%d ends; "
        "fused %.2f s (%d launches), unfused %.2f s (%d launches); equal, "
        "%d dimer pairs; sample of %d == verify_against_host (%.2f s)"
        % (len(primers), cut, n_t, n_e, walls["dimer_hit_matrix_fused"],
           launches["dimer_hit_matrix_fused"], walls["dimer_hit_matrix"],
           launches["dimer_hit_matrix"], int(hit.sum()), len(sample),
           host_s))
    report["dimer"] = {"P": len(primers), "unique": len(uniq), "T": n_t,
                       "E": n_e, "wall_s": walls, "launches": launches,
                       "pairs": int(hit.sum()), "sample": len(sample),
                       "host_sample_s": host_s,
                       "phase_s": time.time() - t_phase}
    report["match_counts"] = measure_counts(ms, dimer, lay, dev)
    report["match_counts"]["launches"] = sum(launches.values())


def measure_counts(ms, dimer, lay, dev):
    """The match-count kernel at the fused path's first bucket vs its plain
    version (exact), then CUDA-event times of kernel, plain version, a
    conv1d yardstick and the whole fused pass (kernel + torch epilogue),
    beside the bound."""
    import torch
    lp, z = lay["lp"], lay["z"]
    t_len = lay["masks"].shape[1]
    tb = min(1024, ms.safe_batch_size(1024, t_len - lp + 1, 4096))
    masks = torch.from_numpy(lay["masks"][:tb]).to(dev)
    planes = ms.pattern_planes(lay["p1h"][:4096], device=dev)
    n, p_all = masks.shape[0], planes.shape[0]
    n_out = t_len - lp + 1
    got = ms.match_counts_kernel(masks, planes, plen=lp)
    want = ms.match_counts_reference(masks, planes, plen=lp)
    torch.cuda.synchronize()
    max_err = float((got - want).abs().max())
    if max_err != 0:
        fail("match_counts differs from the plain version at the fused "
             "bucket")
    del got, want
    kernel_ms = cuda_ms(lambda: ms.match_counts_kernel(masks, planes,
                                                       plen=lp), 20)
    plain_ms = cuda_ms(lambda: ms.match_counts_reference(masks, planes,
                                                         plen=lp), 3)
    m = masks.to(torch.int64)
    x = ((m[:, None, :] >> torch.arange(4, device=dev)[None, :, None])
         & 1).to(torch.float32).contiguous()
    weight = ms._unpack_planes(planes, lp).contiguous()

    def library():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return torch.nn.functional.conv1d(x, weight)
    library_ms = cuda_ms(library, 3)
    e_sl = slice(0, p_all)
    args = [torch.from_numpy(lay[k][e_sl]).to(dev).long()
            for k in ("lns", "shifts")]
    lens = torch.from_numpy(lay["lengths"][:tb]).to(dev).long()
    trig = torch.from_numpy(lay["trig"][e_sl]).to(dev)
    fused_ms = cuda_ms(lambda: dimer._fused_kernel(
        masks, lens, planes, lp, z, *args, trig), 5)
    # masks and planes in, float32 counts out; the bf16-matmul form's
    # operations
    out = {"shape": {"T": n, "L": t_len, "O": n_out, "E": p_all, "lp": lp},
           "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "fused_pass_ms": fused_ms,
           **bound(n * t_len + p_all * 32 + 4 * n * n_out * p_all,
                   2 * n * n_out * p_all * 4 * lp, BF16_OPS_PER_S)}
    say("phase 8 match_counts kernel T=%d L=%d O=%d E=%d lp=%d: equal; "
        "kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f bound_ms=%.4f (%s); "
        "whole fused pass (kernel + torch epilogue) %.4f ms"
        % (n, t_len, n_out, p_all, lp, kernel_ms, plain_ms, library_ms,
           out["bound_ms"], out["bound_by"], fused_ms))
    return out


def tree_diff(a, b):
    """The first relative path whose presence or bytes differ between the
    trees a and b (pipeline_metrics.json and *.log left out), else None."""
    def files(root):
        out = set()
        for d, _, names in os.walk(root):
            for n in names:
                if n != "pipeline_metrics.json" and not n.endswith(".log"):
                    out.add(os.path.relpath(os.path.join(d, n), root))
        return out
    fa, fb = files(a), files(b)
    if fa != fb:
        return sorted(fa ^ fb)[0]
    for rel in sorted(fa):
        if not filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False):
            return rel
    return None


def phase_device_run(args, report, work, res):
    """`run` with device Stage A and the device Gotoh into phase 4's path
    (some outputs embed it), phase 4's tree moved aside first."""
    host_res = res + "_host"
    os.rename(res, host_res)
    cfg = os.path.join(work, "device_align.yaml")
    with open(cfg, "w") as f:
        f.write("align_backend: centerstar-device\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    nproc = os.cpu_count() or 1
    cmd = [sys.executable, "-m", "multiprime_tpu_torch.cli.main", "run",
           "-c", cfg, "-i", os.path.join(work, "scale21k.fa"), "-r", res,
           "--device", DEVICE, "--pcr-products", "summary", "--nproc",
           str(nproc), "--stage-a", "device"]
    log_path = os.path.join(work, "run_device.log")
    t0 = time.time()
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=HERE, env=env, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    wall = time.time() - t0
    if rc != 0:
        with open(log_path) as log:
            fail("device run exited %d:\n%s" % (rc, log.read()[-4000:]))
    with open(os.path.join(res, "pipeline_metrics.json")) as f:
        metrics = json.load(f)
    backends = metrics["backends"]
    stage_a, align = backends["stage_a_served"], backends["align_served"]
    say("phase 9 device run: %.1f s wall, nproc=%d, device=%s, Stage A "
        "served %s, align served %s, hit_codes launches=%d"
        % (wall, nproc, backends.get("device_name"), json.dumps(stage_a),
           json.dumps(align), backends.get("hit_codes_launches", 0)))
    if set(stage_a) != {"device"} or set(align) - {"device", "none"} \
            or align.get("device", 0) <= 0:
        fail("the device run's Stage A or align DP did not run on the card")
    diff = tree_diff(host_res, res)
    if diff is not None:
        fail("device run output %s differs from phase 4's host run" % diff)
    n_files = sum(len(names) for _, _, names in os.walk(res))
    say("phase 9 device run tree == host run tree byte for byte (%d files)"
        % n_files)
    host_t = report["run"]["timings_s"]
    dev_t = metrics["timings_s"]
    say("phase 9 stage seconds (align/design/pair summed over workers), "
        "host run | device run:")
    for stage in sorted(set(host_t) | set(dev_t)):
        say("  %-16s %10s | %s" % (stage, host_t.get(stage), dev_t.get(stage)))
    report["device_run"] = {"wall_s": wall, "nproc": nproc,
                            "timings_s": dev_t, "stage_a_served": stage_a,
                            "align_served": align, "files": n_files,
                            "host_wall_s": report["run"]["wall_s"],
                            "host_timings_s": host_t}
    shutil.rmtree(host_res, ignore_errors=True)


def device_profile(fn):
    """(CUDA activities launched, device busy ms) of one fn() call from
    torch.profiler, or None where the profiler gives no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]
    except (RuntimeError, AttributeError) as e:
        say("  torch.profiler gave no device events: %s" % e)
        return None
    if not events:
        return None
    busy_us = sum(e.time_range.end - e.time_range.start for e in events)
    return len(events), busy_us / 1e3


def timed(fn, reps=1):
    """(result, mean host-clock ms, peak device MiB) of fn() after one
    warm-up call, synchronised."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    return out, ms, torch.cuda.max_memory_allocated() / 2 ** 20


def with_indels(rng, seq):
    """seq with 0-3 seeded indels of 1-12 bases (deletions, or insertions
    of random bases)."""
    s = list(seq)
    for _ in range(int(rng.integers(0, 4))):
        n = int(rng.integers(1, 13))
        at = int(rng.integers(0, len(s) - n))
        if rng.random() < 0.5:
            del s[at:at + n]
        else:
            s[at:at] = list(rng.choice(list("ACGT"), size=n))
    return "".join(s)


def phase_device_ops(args, report, res):
    """The device torch ops of Stage A and the DPs on the largest cluster of
    the device run, each held to its counterpart and timed."""
    import torch
    from multiprime_tpu_torch import native
    from multiprime_tpu_torch.align import centerstar, refine
    from multiprime_tpu_torch.align import device as adev
    from multiprime_tpu_torch.models import mcdpd
    from multiprime_tpu_torch.ops import design_scan
    from multiprime_tpu_torch.utils import iupac
    from multiprime_tpu_torch.validate import scan as vscan
    dev = torch.device(DEVICE)
    with open(os.path.join(res, "cluster.txt")) as f:
        sizes = [(int(n), name) for name, n in
                 (line.split("\t") for line in f.read().splitlines()[1:])]
    params = mcdpd.DesignParams(coverage=0.7, min_product=150,
                                coordinate="2,3,-1")
    eng = mcdpd.DesignEngine(params)
    # Stage-A blocks of the whole run: ceil(W / 512) per designed cluster
    design_blocks = gotoh_blocks = 0
    for n, name in sizes:
        _, chars = mcdpd.parse_msa(os.path.join(res, "Clusters_msa",
                                                name + ".tmsa"))
        try:
            start, stop = eng.usable_span(chars)
        except ValueError:
            continue
        design_blocks += -(-max(stop - 18 - start, 0) // 512)
        if chars.shape[0] > 1:
            gotoh_blocks += -(-(chars.shape[0] - 1) // 512)
    _, name = max(sizes)
    ids, chars = mcdpd.parse_msa(os.path.join(res, "Clusters_msa",
                                              name + ".tmsa"))
    start, stop = eng.usable_span(chars)
    positions = np.arange(start, stop - 18)
    masks = iupac.bytes_to_masks(chars)
    out = {"cluster": name, "design_blocks_per_run": design_blocks,
           "gotoh_blocks_per_run": gotoh_blocks}

    def stage_a(device):
        return list(design_scan.design_stats_blocks(
            masks, positions, plen=18, variation=1, device=device))
    got, dev_ms, peak = timed(lambda: stage_a(dev), reps=3)
    t0 = time.perf_counter()
    want = stage_a("cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if len(got) != len(want):
        fail("design_stats_blocks gave %d blocks on the card, %d on the CPU"
             % (len(got), len(want)))
    for (gp, gs), (wp, ws) in zip(got, want):
        for key in ws:
            if not (np.array_equal(gp, wp) and gs[key].dtype == ws[key].dtype
                    and np.array_equal(gs[key], ws[key])):
                fail("design_stats_blocks %s differs between the card and "
                     "the CPU on %s" % (key, name))
    prof = device_profile(lambda: list(design_scan.design_stats_blocks(
        masks, positions[:512], plen=18, variation=1, device=dev)))
    walls = {}
    for backend in ("host", "device"):
        e = mcdpd.DesignEngine(mcdpd.DesignParams(
            coverage=0.7, min_product=150, coordinate="2,3,-1",
            stage_a=backend, device=dev))
        t0 = time.perf_counter()
        rows = e.design(ids, chars)
        walls[backend] = time.perf_counter() - t0
        if backend == "host":
            host_rows = [(r.position, r.primer, r.coverage) for r in rows]
        elif [(r.position, r.primer, r.coverage) for r in rows] != host_rows:
            fail("design rows of %s differ between host and device Stage A"
                 % name)
    nb = len(got)
    out["design_stats_blocks"] = {
        "N": int(masks.shape[0]), "W": len(positions), "blocks": nb,
        "ms_per_block": dev_ms / nb, "cpu_torch_ms_per_block": cpu_ms / nb,
        "peak_mib": peak, "profile_one_block": prof,
        "design_wall_s": walls}
    say("phase 10 design_stats_blocks on %s (N=%d, W=%d, %d blocks of 512): "
        "card == CPU; %.3f ms a block on the card, %.1f ms on the CPU; peak "
        "%.1f MiB; one block: %s (launches, device busy ms); design wall "
        "host Stage A %.2f s, device Stage A %.2f s, rows equal"
        % (name, masks.shape[0], len(positions), nb, dev_ms / nb,
           cpu_ms / nb, peak, prof, walls["host"], walls["device"]))

    # the center-star DP: the run's members (the sampled .tfa) against
    # native, then one block of 512 members of the whole cluster timed; the
    # corpus has substitutions only, so each member gets 0-3 seeded indels
    # of 1-12 bases, which the affine states and the refine moves need
    rng = np.random.default_rng(args.seed + 4)
    _, seqs = vscan.parse_fasta(os.path.join(res, "Clusters_fa",
                                             name + ".tfa"))
    seqs = [with_indels(rng, s) for s in seqs]
    codes = [centerstar._encode(s) for s in seqs]
    center = centerstar.pick_center(seqs)
    members = [codes[m] for m in range(len(seqs)) if m != center]
    got = adev.align_ops_batch_device(codes[center], members,
                                      as_codes=True, device=dev)
    nat = native.gotoh_ops_batch(codes[center], members)
    if nat is None:
        fail("native.gotoh_ops_batch is unavailable")
    s_min = min(got.shape[1], nat.shape[1])
    if not (np.array_equal(got[:, :s_min], nat[:, :s_min])
            and (got[:, s_min:] == 3).all() and (nat[:, s_min:] == 3).all()):
        fail("align_ops_batch_device differs from native.gotoh_ops_batch on "
             "%s" % name)
    _, all_seqs = vscan.parse_fasta(os.path.join(res, "Clusters_fa",
                                                 name + ".fa"))
    block = [centerstar._encode(with_indels(rng, s)) for s in all_seqs[:512]]
    c = codes[center]
    _, gotoh_ms, gotoh_peak = timed(lambda: adev.align_ops_batch_device(
        c, block, as_codes=True, device=dev))
    t0 = time.perf_counter()
    native.gotoh_ops_batch(c, block)
    native_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(lambda: adev.align_ops_batch_device(
        c, block, as_codes=True, device=dev))
    lbs = [len(b) for b in block]
    out["align_ops_batch_device"] = {
        "members_checked": len(members), "la": len(c), "M": len(block),
        "lb_max": max(lbs), "ms_per_block": gotoh_ms,
        "native_ms_per_block": native_ms, "peak_mib": gotoh_peak,
        "profile_one_block": prof}
    say("phase 10 align_ops_batch_device: %d members == native; one block "
        "la=%d M=%d lb_max=%d: %.1f ms on the card, native %.1f ms (%d host "
        "threads); peak %.1f MiB; %s (launches, device busy ms)"
        % (len(members), len(c), len(block), max(lbs), gotoh_ms, native_ms,
           os.cpu_count() or 1, gotoh_peak, prof))

    # the refine DP: one pass over the cluster's center-star rows
    rows = centerstar._merge_rows_vec(
        seqs, center, [m for m in range(len(seqs)) if m != center], got)
    got_rows, ref_ms, ref_peak = timed(lambda: refine.refine_pass(
        rows, backend="device", device=dev))
    t0 = time.perf_counter()
    nat_rows = refine.refine_pass(rows, backend="native")
    ref_native_ms = (time.perf_counter() - t0) * 1e3
    if got_rows != nat_rows:
        fail("refine_pass_device differs from native.refine_realign on %s"
             % name)
    n_blocks = -(-len(rows) // 256)
    prof = device_profile(lambda: refine.refine_pass(
        rows[:256], backend="device", device=dev))
    out["refine_pass_device"] = {
        "M": len(rows), "C": len(rows[0]), "blocks": n_blocks,
        "ms_per_block": ref_ms / n_blocks,
        "native_ms_per_block": ref_native_ms / n_blocks,
        "peak_mib": ref_peak, "profile_256_rows": prof,
        "moved_rows": sum(a != b for a, b in zip(got_rows, rows))}
    say("phase 10 refine_pass_device: M=%d C=%d, %d blocks of 256 == native "
        "(%d rows moved); %.1f ms a block on the card, native %.1f ms; peak "
        "%.1f MiB; 256 rows: %s (launches, device busy ms)"
        % (len(rows), len(rows[0]), n_blocks, out["refine_pass_device"][
            "moved_rows"], ref_ms / n_blocks, ref_native_ms / n_blocks,
           ref_peak, prof))
    say("phase 10 blocks a run: %d Stage-A blocks, %d Gotoh blocks, 0 refine "
        "blocks (refine_msa takes native)" % (design_blocks, gotoh_blocks))
    report["device_ops"] = out


# the specificity background: BACKGROUND_SEQS sequences of BACKGROUND_LEN
# bases, about a set of 16 bacterial genomes, the last one a few segment
# strides shorter so that the scan's last batch is part padding; PLANTS
# amplicons planted in it, STRADDLES of them across a multiple of the
# segment stride
BACKGROUND_SEQS = 16
BACKGROUND_LEN = 4000000
PLANTS = 200
STRADDLES = 30
MIN_PLANTS_FOUND = 150

# runs one subcommand of the port's CLI in this interpreter, then writes a
# side file: exit code, wall, each scan_hits_long call's seconds and hits,
# hit_codes launches, peak device memory and the scan backend
CLI_DRIVER = r"""
import json, sys, time
import torch
from multiprime_tpu_torch.cli import main as cli
from multiprime_tpu_torch.ops import mismatch_scan as ms
from multiprime_tpu_torch.validate import scan as vscan
calls = []
scan_long = vscan.scan_hits_long
def timed(*a, **kw):
    t0 = time.time()
    out = scan_long(*a, **kw)
    calls.append({"s": time.time() - t0, "hits": len(out),
                  "targets": len(a[0]), "patterns": len(a[1])})
    return out
vscan.scan_hits_long = timed
t0 = time.time()
rc = cli.main(sys.argv[2:])
side = {"rc": rc, "wall_s": time.time() - t0, "scans": calls,
        "launches": ms.HIT_CODES_LAUNCHES, "backend": vscan.LAST_BACKEND,
        "peak_bytes": torch.cuda.max_memory_allocated()
        if torch.cuda.is_initialized() else 0}
with open(sys.argv[1], "w") as f:
    json.dump(side, f)
sys.exit(rc)
"""


def run_cli(argv, work, name, host=False):
    """One subcommand of the port's CLI in a subprocess (CLI_DRIVER), on
    the card, or on the host backend with MPTPU_FORCE_BACKEND=host; the
    hash seed fixed (update's dimer report follows set order).  -> the
    side file's dict with the subprocess's wall ("process_s")."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONHASHSEED"] = "0"
    env.pop("MPTPU_FORCE_BACKEND", None)
    if host:
        env["MPTPU_FORCE_BACKEND"] = "host"
    side = os.path.join(work, name + ".side.json")
    log_path = os.path.join(work, name + ".log")
    t0 = time.time()
    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, "-c", CLI_DRIVER, side, *argv],
                            cwd=HERE, env=env, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    wall = time.time() - t0
    if rc != 0:
        with open(log_path) as log:
            fail("%s exited %d:\n%s" % (" ".join(argv[:1] + [name]), rc,
                                        log.read()[-4000:]))
    with open(side) as f:
        out = json.load(f)
    out["process_s"] = wall
    return out


def candidate_pairs(primers_fa):
    """(F, R) of a candidate FASTA, whose records come in F, R pairs."""
    from multiprime_tpu_torch.validate import scan as vscan
    ids, seqs = vscan.parse_fasta(primers_fa)
    return [(seqs[i], seqs[i + 1]) for i in range(0, len(seqs) - 1, 2)
            if ids[i].endswith("F") and ids[i + 1].endswith("R")]


def substitute(rng, s, lo, hi):
    """s with one substitution at a position in [lo, hi)."""
    at = int(rng.integers(max(lo, 0), hi))
    return s[:at] + str(rng.choice([c for c in "ACGT" if c != s[at]])) \
        + s[at + 1:]


def plant_amplicons(rng, genomes, pairs, stride):
    """Plants PLANTS amplicons in the uint8 genomes: one expansion of F,
    the reverse complement of one expansion of R 150-1,400 bases after F's
    3' 18-mer, each site with 0-1 substitutions in its scanned 18-mer
    outside its last 4 bases; the first STRADDLES put F's 18-mer across a
    multiple of the segment stride.  -> [(genome, 18-mer start, R site
    start)], the rows a planted amplicon gives."""
    from multiprime_tpu_torch.utils import iupac
    boundaries = [(g, k * stride) for g in range(len(genomes))
                  for k in range(1, (len(genomes[g]) - 1500) // stride + 1)]
    picks = rng.choice(len(boundaries), size=STRADDLES, replace=False)
    taken = {g: [] for g in range(len(genomes))}
    sites = []
    while len(sites) < PLANTS:
        f, r = pairs[int(rng.integers(0, len(pairs)))]
        fx = iupac.expand(f)
        fx = fx[int(rng.integers(0, len(fx)))]
        rx = iupac.expand(r)
        rx = rx[int(rng.integers(0, len(rx)))]
        if rng.random() < 0.5:
            fx = substitute(rng, fx, len(fx) - 18, len(fx) - 4)
        if rng.random() < 0.5:       # R's 3' 14 bases: the site's first 14
            rx = substitute(rng, rx, len(rx) - 14, len(rx))
        if len(sites) < STRADDLES:
            g, b = boundaries[picks[len(sites)]]
            start = b - int(rng.integers(1, 18))
        else:
            g = int(rng.integers(0, len(genomes)))
            start = int(rng.integers(100, len(genomes[g]) - 1600))
        at = start - max(len(fx) - 18, 0)
        stop = start + int(rng.integers(150, 1401))
        site = iupac.rc(rx)
        if at < 0 or stop + len(site) > len(genomes[g]) or any(
                abs(start - t) < 3000 for t in taken[g]):
            continue
        genomes[g][at:at + len(fx)] = np.frombuffer(fx.encode(), np.uint8)
        genomes[g][stop:stop + len(site)] = np.frombuffer(site.encode(),
                                                          np.uint8)
        taken[g].append(start)
        sites.append((g, start, stop))
    return sites


def segment_count(n, seg_len, stride):
    """Segments scan_hits_long cuts a target of n bases into."""
    return 1 + max(0, -(-(n - seg_len) // stride))


def background_lengths(seg_len, stride, bs):
    """BACKGROUND_SEQS lengths: BACKGROUND_LEN each, the last five or more
    strides shorter, until the segments do not fill whole batches of bs."""
    lengths = [BACKGROUND_LEN] * BACKGROUND_SEQS
    lengths[-1] -= 5 * stride
    while sum(segment_count(n, seg_len, stride) for n in lengths) % bs == 0:
        lengths[-1] -= stride
    return lengths


def write_background(args, work, primers, lengths):
    """The seeded background FASTA (80 columns) with the planted
    amplicons -> (path, planted rows)."""
    rng = np.random.default_rng(args.seed + 5)
    lut = np.frombuffer(b"ACGT", np.uint8)
    genomes = [lut[rng.integers(0, 4, size=n)] for n in lengths]
    sites = plant_amplicons(rng, genomes, candidate_pairs(primers),
                            (1 << 16) - 17)
    path = os.path.join(work, "background.fa")
    with open(path, "wb") as f:
        for g, arr in enumerate(genomes):
            f.write(b">bg%d synthetic genome %d\n" % (g, g))
            lines = arr[:len(arr) // 80 * 80].reshape(-1, 80)
            body = np.concatenate([lines, np.full((len(lines), 1), 10,
                                                  np.uint8)], axis=1)
            f.write(body.tobytes())
            if len(arr) % 80:
                f.write(arr[len(arr) // 80 * 80:].tobytes() + b"\n")
    return path, sites


def phase_specificity(args, report, work, primers):
    """`specificity` through the CLI against the seeded background, on the
    card and on the host backend, with and without --exhaustive-join: the
    four output files byte-identical between the backends, the planted
    amplicons found; then the hit-code kernel and the compaction timed at
    the background's batch shape."""
    import torch
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.validate import scan as vscan
    t0 = time.time()
    # the scan's batch: the 18-base keys of the primers' 3' 18-mers
    pats, _, keys, _ = vscan.expand_primer_fasta(primers, 18, None,
                                                 with_keys=True)
    keys = [k for k in (keys if keys is not None else pats) if len(k) == 18]
    p1h, s1h = pattern_onehots(ms, keys, 4)
    seg_len = vscan.ScanParams().seg_len
    stride = seg_len - 17
    bs = ms.safe_batch_size(vscan.ScanParams().device_batch_seqs,
                            seg_len - 17, p1h.shape[0])
    lengths = background_lengths(seg_len, stride, bs)
    bg, sites = write_background(args, work, primers, lengths)
    n_segs = sum(segment_count(n, seg_len, stride) for n in lengths)
    say("phase 11 background: %d x %d bases and 1 x %d (%.6f Mb), %d "
        "segments of %d in %d batches of %d (the last %d segments and %d "
        "padding rows), %d planted amplicons (%d across a stride multiple) "
        "(%.1f s)" % (len(lengths) - 1, lengths[0], lengths[-1],
                      sum(lengths) / 1e6, n_segs, seg_len, -(-n_segs // bs),
                      bs, n_segs % bs, -n_segs % bs, len(sites), STRADDLES,
                      time.time() - t0))
    out = {"background_bases": sum(lengths), "lengths": lengths,
           "segments": n_segs, "batch_size": bs,
           "batches_per_scan": -(-n_segs // bs),
           "padding_rows": -n_segs % bs, "planted": len(sites), "runs": {}}
    for join in ("early-exit", "exhaustive"):
        dirs = {}
        for backend in ("device", "host"):
            name = "spec_%s_%s" % (join, backend)
            d = dirs[backend] = os.path.join(work, name)
            os.makedirs(d)
            shutil.copy(primers, os.path.join(d, "primers.fa"))
            side = run_cli(["specificity", "-i", os.path.join(d, "primers.fa"),
                            "-r", bg, "-l", "18", "-t", "4", "-m", "1", "-s",
                            "100,1500", "-o", os.path.join(d, "s.out"),
                            "--device", DEVICE]
                           + (["--exhaustive-join"] if join == "exhaustive"
                              else []), work, name, host=backend == "host")
            want = "device" if backend == "device" else "host"
            if side["backend"] != want or (backend == "device"
                                           and side["launches"] <= 0):
                fail("specificity %s ran the %s scan with %d hit_codes "
                     "launches" % (name, side["backend"], side["launches"]))
            with open(os.path.join(d, "s.out")) as f:
                side["rows"] = sum(1 for _ in f) - 1
            out["runs"][name] = side
            say("phase 11 specificity %s on the %s backend: %.2f s wall "
                "(process %.2f s), scans %s s, hits %s, hit_codes launches "
                "%d, peak device memory %.1f MiB, %d rows" % (
                    join, backend, side["wall_s"], side["process_s"],
                    [round(c["s"], 2) for c in side["scans"]],
                    [c["hits"] for c in side["scans"]], side["launches"],
                    side["peak_bytes"] / 2 ** 20, side["rows"]))
        diff = tree_diff(dirs["device"], dirs["host"])
        if diff is not None:
            fail("specificity (%s join) %s differs between the card and the "
                 "host backend" % (join, diff))
        say("phase 11 specificity %s: device == host byte for byte (%s)"
            % (join, ", ".join(sorted(os.listdir(dirs["device"])))))
    with open(os.path.join(work, "spec_exhaustive_device", "s.out")) as f:
        rows = {(r[0], int(r[1]), int(r[2])) for r in
                (line.split("\t") for line in f.read().splitlines()[1:])}
    found = sum(("bg%d" % g, a, b) in rows for g, a, b in sites)
    straddled = sum(("bg%d" % g, a, b) in rows for g, a, b in
                    sites[:STRADDLES])
    say("phase 11 planted amplicons in the exhaustive .out: %d of %d (%d of "
        "the %d across a stride multiple)" % (found, len(sites), straddled,
                                              STRADDLES))
    if found < MIN_PLANTS_FOUND:
        fail("specificity found %d planted amplicons, fewer than %d"
             % (found, MIN_PLANTS_FOUND))
    out.update(found=found, straddled_found=straddled)
    # the kernel and the compaction at the scan's batch shape, on the scan's
    # last batch: the last genome's last segments (its final one shorter
    # than the rest), then zero padding rows, as scan_hits stacks them
    _, seqs = vscan.parse_fasta(bg)
    last = seqs[-1]
    del seqs
    offs = [k * stride for k in range(segment_count(len(last), seg_len,
                                                    stride))]
    segs = [last[o:o + seg_len] for o in offs[-(n_segs % bs):]]
    masks = np.zeros((bs, seg_len), np.uint8)
    lens = np.zeros(bs, np.int32)
    masks[:len(segs)], lens[:len(segs)] = ms.encode_target_masks(
        segs, length=seg_len)
    report["hit_codes_background_shape"] = measure_kernel(
        ms, masks, p1h, s1h, 1, 4, "phase 11 kernel at the background's "
        "last batch (%d segments, %d padding rows)" % (len(segs),
                                                       bs - len(segs)))
    dev = torch.device(DEVICE)
    tm = torch.from_numpy(masks).to(dev)
    tl = torch.from_numpy(lens).to(dev)
    planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
    codes = ms.hit_codes(tm, planes, sfx, plen=18, mm=1, term=4)
    compaction_ms = cuda_ms(lambda: ms.find_hits_from_codes(
        codes, tl, plen=18, max_hits=1 << 17), 10)
    compaction_bound = codes.numel() / HBM_BYTES_PER_S * 1e3
    out["compaction"] = {"ms": compaction_ms, "bound_ms": compaction_bound,
                         "bytes": codes.numel()}
    say("phase 11 compaction (find_hits_from_codes) of one batch %s: "
        "%.4f ms, bytes bound %.4f ms; %d batches of %d segments a scan"
        % (list(codes.shape), compaction_ms, compaction_bound,
           out["batches_per_scan"], bs))
    del codes
    report["specificity"] = out


def phase_update(args, report, work, res):
    """`update -f DO` (phase 4's final set as the core, the candidate pairs
    of two family clusters outside it as the new set, the formatted 21k
    targets as the reference DB) and `nondimer-filter`, on the card and on
    the host backend: every output byte-identical."""
    core = os.path.join(res, "Core_primers_set",
                        "core_final_maxprimers_set.fa")
    if not os.path.exists(core):
        core = os.path.join(res, "Primers_set", "final_maxprimers_set.fa")
    from multiprime_tpu_torch.validate import scan as vscan
    core_seqs = set(vscan.parse_fasta(core)[1])
    # the family clusters with none of their primers in the panel first,
    # the smallest candidate sets first among them
    clusters = []
    for path in glob.glob(os.path.join(res, "Primers_set",
                                       "candidate_primers_sets",
                                       "*.candidate.primers.fa")):
        members = int(os.path.basename(path).split(".")[0].rsplit("_", 1)[1])
        ids, seqs = vscan.parse_fasta(path)
        if members > 1 and seqs:
            clusters.append((bool(core_seqs & set(seqs)), len(seqs),
                             os.path.basename(path), ids, seqs))
    if len(clusters) < 2:
        fail("fewer than two family clusters have candidate primers")
    lines, picked = [], []
    for in_panel, _, name, ids, seqs in sorted(clusters)[:2]:
        picked.append((name, in_panel))
        lines += [">%s\n%s\n" % (i, s) for i, s in zip(ids, seqs)
                  if s not in core_seqs]
    if not lines:
        fail("the two family clusters' candidates are all in the core set")
    ref = os.path.join(res, "Total_fa", "scale21k.format.fa")
    dirs, out = {}, {"new_primers": len(lines), "clusters": picked}
    for backend in ("device", "host"):
        d = dirs[backend] = os.path.join(work, "update_" + backend)
        for sub in ("core", "new"):
            os.makedirs(os.path.join(d, sub))
        shutil.copy(core, os.path.join(d, "core", "core.fa"))
        with open(os.path.join(d, "new", "new.fa"), "w") as f:
            f.write("".join(lines))
        host = backend == "host"
        side = run_cli(["update", "-i", os.path.join(d, "new", "new.fa"),
                        "-c", os.path.join(d, "core", "core.fa"), "-r", ref,
                        "-f", "DO", "-o", os.path.join(d, "upd"), "--device",
                        DEVICE], work, "update_" + backend, host=host)
        if side["backend"] != ("host" if host else "device") or (
                not host and side["launches"] <= 0):
            fail("update on the %s backend ran the %s scan" % (
                backend, side["backend"]))
        flt = run_cli(["nondimer-filter", "-i",
                       os.path.join(d, "new", "new.fa"), "-p",
                       os.path.join(d, "core", "core.fa"), "-o",
                       os.path.join(d, "clean.fa")], work,
                      "nondimer_" + backend, host=host)
        counts = {}
        for n in ("upd.dimer", "upd.offtargets", "clean.fa"):
            with open(os.path.join(d, n)) as f:
                counts[n] = sum(1 for _ in f)
        out[backend] = {"update": side, "nondimer_filter": flt,
                        "lines": counts}
        say("phase 12 update -f DO on the %s backend: %.2f s wall, scans %s "
            "s, hit_codes launches %d, peak device memory %.1f MiB; "
            "nondimer-filter %.2f s; lines %s" % (
                backend, side["wall_s"],
                [round(c["s"], 2) for c in side["scans"]], side["launches"],
                side["peak_bytes"] / 2 ** 20, flt["wall_s"],
                json.dumps(counts)))
    diff = tree_diff(dirs["device"], dirs["host"])
    if diff is not None:
        fail("update / nondimer-filter output %s differs between the card "
             "and the host backend" % diff)
    say("phase 12 update (%d core, %d new primers of %s) and "
        "nondimer-filter: device == host byte for byte (%s)" % (
            len(core_seqs), len(lines),
            ", ".join("%s%s" % (n, " (in the panel)" if p else "")
                      for n, p in picked), "every file"))
    report["update"] = out


def phase_onestep(args, report, work, res):
    """`onestep` on the largest family cluster's .tmsa and .tfa, on the
    card and on the host backend, into the same path (the candidate .txt
    embeds it): every file byte-identical."""
    with open(os.path.join(res, "cluster.txt")) as f:
        _, name = max((int(n), name) for name, n in
                      (line.split("\t") for line in f.read().splitlines()[1:]))
    d = os.path.join(work, "onestep")
    walls, sides = {}, {}
    for backend in ("device", "host"):
        os.makedirs(d)
        side = run_cli([
            "onestep", "-i", os.path.join(res, "Clusters_msa", name + ".tmsa"),
            "-r", os.path.join(res, "Clusters_fa", name + ".tfa"), "-s",
            "250,500", "--out1", os.path.join(d, name + ".top.primer.out"),
            "-o", os.path.join(d, name + ".candidate.primers.txt"),
            "--device", DEVICE], work, "onestep_" + backend,
            host=backend == "host")
        if side["backend"] != ("host" if backend == "host" else "device") \
                or (backend == "device" and side["launches"] <= 0):
            fail("onestep on the %s backend ran the %s scan"
                 % (backend, side["backend"]))
        walls[backend], sides[backend] = side["wall_s"], side
        if backend == "device":
            os.rename(d, d + "_device")
    diff = tree_diff(d + "_device", d)
    if diff is not None:
        fail("onestep output %s differs between the card and the host "
             "backend" % diff)
    n_files = sum(len(n) for _, _, n in os.walk(d))
    say("phase 13 onestep on %s: %d files, device == host byte for byte; "
        "%.2f s on the card (%d hit_codes launches), %.2f s on the host "
        "backend" % (name, n_files, walls["device"],
                     sides["device"]["launches"], walls["host"]))
    report["onestep"] = {"cluster": name, "files": n_files, "runs": sides}


def kernel_entry(m, name, source, replaces):
    """One kernel's entry of the kernels line, from its measurements."""
    return {"name": name, "route": "cuda",
            "source": "multiprime_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": m["launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "matches_plain": True}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--families", type=int, default=20)
    ap.add_argument("--members", type=int, default=1000)
    ap.add_argument("--singletons", type=int, default=1000)
    ap.add_argument("--report", help="also write the measurements as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "multiprime_tpu_torch")):
        fail("multiprime_tpu_torch/ is not beside chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, HERE)
    import multiprime_tpu_torch
    if not os.path.abspath(multiprime_tpu_torch.__file__).startswith(HERE):
        fail("imported multiprime_tpu_torch from outside this checkout")
    say("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    report = {"phase_s": {}}
    t_start = time.time()

    def phase(n, fn, *a):
        t0 = time.time()
        out = fn(args, report, *a)
        report["phase_s"][n] = round(time.time() - t0, 1)
        say("phase %d took %.1f s (%.1f s in all)" % (
            n, report["phase_s"][n], time.time() - t_start))
        return out
    phase(1, phase_build)
    phase(2, phase_kernel)
    phase(3, phase_find_hits)
    work = tempfile.mkdtemp(prefix="mptpu_smoke_")
    try:
        res, launches = phase(4, phase_run, work)
        primers, keys = phase(5, phase_scan, work, res)
        phase(6, phase_new_kernels)
        phase(7, phase_bitmap, res, keys)
        phase(8, phase_dimer, primers)
        phase(9, phase_device_run, work, res)
        phase(10, phase_device_ops, res)
        phase(11, phase_specificity, work, primers)
        phase(12, phase_update, work, res)
        phase(13, phase_onestep, work, res)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["hit_codes"]["launches"] = launches
    # the launches of every path that drove the kernel, each its own process
    spec = report["specificity"]["runs"]
    by_path = {"run": launches,
               "specificity": sum(spec[n]["launches"] for n in spec
                                  if n.endswith("_device")),
               "update": report["update"]["device"]["update"]["launches"],
               "onestep": report["onestep"]["runs"]["device"]["launches"]}
    kernels = {"kernels": [
        dict(kernel_entry(report["hit_codes"], "hit_codes", "hit_codes.cu",
                          "multiprime_tpu/ops/mismatch_scan.py:173"),
             launches_by_path=by_path),
        kernel_entry(report["match_counts"], "match_counts",
                     "match_counts.cu",
                     "multiprime_tpu/ops/mismatch_scan.py:150"),
        kernel_entry(report["hit_window_bitmap"], "hit_window_bitmap",
                     "hit_window_bitmap.cu",
                     "multiprime_tpu/ops/mismatch_scan.py:315")]}
    report["kernels"] = kernels
    report["total_s"] = time.time() - t_start
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    say("total %.1f s" % report["total_s"])
    say(report["card"])
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
