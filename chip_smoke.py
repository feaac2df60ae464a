#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (multiprime_tpu_torch).

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 chip_smoke.py [--report PATH] [--families F --members M
                           --singletons S]

Phases (each prints one line or more; any failure exits non-zero before
the final line):

1. card and build: the card's name and power limit, then nvcc builds every
   kernel in multiprime_tpu_torch/csrc from the checkout's sources (one
   nvcc a source, all started together), and each compiled kernel's
   registers, spills and static shared memory (the three of
   design_stage_a.cu, the count, scan and write kernels of find_hits.cu
   and dimer_fired.cu's must be there);
2. the hit-code kernel against its plain PyTorch version, exact int8
   equality, on an edge-case grid (plen 8-63 with K = 4 * plen off the
   32-byte k-step, P unpadded from 1 to 745, mm up to plen + 1, rows
   shorter than a window tile) and at the main path's batch shape and the
   scan cell's, with CUDA-event times of kernel, plain version and a conv1d
   yardstick;
3. the find_hits kernels (csrc/find_hits.cu) against their plain version
   (hit_idx, n_hits, mism equal) on phase 2's edge grid with zero-length
   padding rows and max_hits below, at and above the hits, and on dense
   cases: blocks of more than 1,024 hits (whole-row rounds and a row alone
   in pattern slices), max_hits inside a block, a flat size no multiple of
   64, rows shorter than plen, term 0 and above plen; then
   find_hits_batched on the card against find_hits_numpy on the host, and
   a device scan whose hits overflow the first max_hits (the retry);
4. `run` through the CLI in a subprocess on the seeded 21k-sequence corpus
   (20 families x 1000 members + 1000 singletons, 900 bp), its find_hits
   launches (its backends' ``launches``) equal to its scan's device
   batches (``counted_batches`` in CLI_DRIVER), then the rule-19 scan
   rerun on the host backend: BWT_coverage outputs byte-identical; the
   hit-code and find_hits kernels timed at the run's batch shape;
5. `scan` through the CLI on the run's aggregated candidate set against
   the 21k targets, device vs host byte-identical, find_hits once a
   device batch (``counted_batches``); then -m 4 on 4200
   targets on the device, held to the plain version through find_hits;
6. the match-count and bitmap kernels against their plain versions, exact,
   on edge-case grids (the bitmap on phase 2's grid, with raw IUPAC masks
   of several bases a position and with pure masks);
7. find_hits_bitmap (the two-phase scan) on the 21k targets against phase
   5's patterns, equal tuple for tuple to find_hits over the scan's
   batches; the bitmap kernel timed at that shape beside its plain version
   and a conv1d yardstick;
8. dimer_hit_matrix_fused (the dimer_fired kernel of csrc/dimer_fired.cu,
   one launch a bucket) and dimer_hit_matrix (the match-count kernel) on
   the unique candidate primers (the first DIMER_PRIMERS of them), equal to
   each other and to verify_against_host on a seeded sample; dimer_fired
   against its plain version on the fused path's first bucket and on an
   edge grid (first hits at the first and the last window, d2 clipped at
   both ends, padding rows, lp 8-64), both count kernels timed at the
   first bucket;
9. `run` again on the same corpus with device Stage A (--stage-a device)
   and the device Gotoh (align_backend: centerstar-device), into phase 4's
   results path: every output file byte-identical to phase 4's (but
   pipeline_metrics.json and logs), Stage A and the align DP served by the
   card, the Stage-A windows kernel launched once for each of the run's
   Stage-A blocks, the Gotoh kernel once for each of its Gotoh blocks (the
   warp kernel for every block no wider than its limit), find_hits as
   often as phase 4's run of the same scan; both runs' stage seconds;
10. the device ops on the largest cluster of that run, each equal to its
   counterpart and timed: design_stats_blocks on the card vs the CPU (and
   the cluster's design with host vs device Stage A, the three Stage-A
   kernels of csrc/design_stage_a.cu launched once a call and once a
   block); those kernels against their plain versions on the card on
   every block of the cluster and on an edge grid (gap runs longer than
   plen, all-gap rows, N-heavy windows, N = 1, plen 8-40, sums past 2**31
   and 2**63, a plen too long for the shared sums), each kernel timed on
   one 512-window block beside the plain torch ops, the bound and the
   block's launches (torch.profiler);
   align_ops_batch_device vs native.gotoh_ops_batch and
   refine_pass_device vs native.refine_realign on its members with seeded
   indels; the Gotoh and refine DP kernels (csrc/gotoh_dp.cu,
   csrc/refine_dp.cu) against their plain versions on the card on one
   512-member Gotoh block (both Gotoh kernels: the warp kernel its width
   takes, and the CTA kernel forced; each also against native, with its
   ptxas registers and spills), one 256-row refine block and a tie-heavy
   grid,
   with CUDA-event times of kernel and plain version, the trace's share
   (the kernels' clock64 counters), the native DP's time, the bound, and
   the launches of one block at full depth (torch.profiler), peak device
   memory; all of it in a process of its own, which starts no other;
11. `specificity` through the CLI against a seeded background of about
   64 Mb (15 x 4 Mb and one shorter sequence, so that the scan's last
   batch holds padding rows) holding 200 planted amplicons of phase 5's
   candidate pairs, 30 of them across a multiple of the segment stride:
   on the card and on the host backend (MPTPU_FORCE_BACKEND=host), with
   and without --exhaustive-join, every output byte-identical between the
   two, at least 150 plants in the exhaustive .out, each card run's
   find_hits launches equal to its scan's device batches, its peak device
   memory against the prediction; the hit-code kernel and the find_hits
   kernels held to their plain versions on the scan's last batch (padding
   rows included, 16 segments of 65,536 bases x the 18-base keys) and
   timed there beside hit_codes + the torch compaction and a
   torch.nonzero yardstick, with the bound, the device time by CUDA
   kernel and each path's peak memory;
12. `update -f DO` (phase 4's final set as the core; the candidate pairs of
   two family clusters not in the panel, the smallest such candidate sets,
   as the new set; the formatted 21k targets as the reference DB) and
   `nondimer-filter`, card vs host backend, byte-identical, find_hits once
   a device batch;
13. `onestep` on the largest family cluster, card vs host backend, into the
   same path, every file byte-identical, find_hits once a device batch;
14. the mesh on one card (a 2 x 2 Mesh of cuda:0): design_stats_blocks_
   sharded on phase 10's cluster equal block for block to
   design_stats_blocks (the windows kernel once a shard and block, the
   Viterbi kernel once a column and block), coverage_counts_sharded equal to an unsharded sum
   of match_counts, scan_hits under use_mesh on phase 5's inputs equal
   tuple for tuple to the unsharded device scan (find_hits once a batch
   shard), and `run` in process under the mesh with --stage-a device on a
   cut corpus (2 families x 1000 members + 20 singletons) equal byte for
   byte to the same run without it;
15. `run --profile` through the CLI on the cut corpus: the tree equal to
   phase 14's unprofiled run, a trace written, and the share of the run
   during which a CUDA kernel ran;
16. the crossover: the constants of utils/link.py fitted on this card, and
   the side "auto" picks for phases 4, 5 and 11's scans, the 21k design
   stage and each cluster of the design sample beside the measured time of
   both sides;
17. the clusterer's banded identities (csrc/banded_identity.cu): the
   kernels against their plain version and the native DP, exact, on 32
   pairs at whole-genome length (8.2-8.4 kb), at CDS length (850-950 bp)
   and of partial genomes (6.8-7.3 kb) beside complete ones (the wide
   kernel), related and not, with N codes, and on pairs on both sides of
   the 32-bit key's limit; CUDA-event times of one pair alone, the 32
   pairs and a full window of 2,112 beside the bound (cells x 20 int32
   operations over 16.7 Tops/s), the plain version's and native's (one
   thread); the identity constants of utils/link.py fitted from them;
   then one clustering job of each shape (about 900 genomes, about 3,800
   CDS) on both sides, the serial walk on 8 threads and the windowed walk
   on the card, equal clusters, and the side the job's estimate picks in a
   fresh process and in this warm one;
18. the kernels line: all nine kernel sources; the two DP kernels carry
   the native DP's ms a block beside their plain version's, design Stage A
   the host Stage A's design wall; find_hits's launches are the `run`'s
   (its main path), hit_codes's those of the phase 11 call whose codes
   are held to find_hits's list.

Every phase that drives the card's path holds its scans to the device
(MPTPU_FORCE_BACKEND=device, or an explicit backend): the crossover may
give them to the host.

The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is available or the package is not beside this script.
"""

import argparse
import contextlib
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

from multiprime_tpu_torch.ops import _cuda

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# H100 SXM CUDA-core rates: 132 SMs x lanes x the 1.98 GHz boost clock; an
# SM has 64 int32 lanes and 128 fp32 lanes, each one add, max or compare a
# clock (the data sheet's 67 TFLOP/s counts an fp32 FMA as two)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 132 * 128 * 1.98e9
# operations a DP cell that the function needs, read from the rows of the
# JAX programs (loads, stores and loop control not counted), in int32 for
# multiprime_tpu/align/device.py _build's row: the substitution 2 (compare,
# select), F and fcont 4 (2 adds, max, compare), diag, vert, p, t, the
# cummax, E, econt and V 1 each, E > vert and its select 2, the pointer
# byte 4 (csrc/gotoh_dp.cu's CTA kernel does 28, computing t and the
# running max in both of its passes and packing the byte in two steps; its
# warp kernel about 23 instructions a cell); in fp32 for
# _build_refine's col: a cell the open add, compare, max and add, the
# diagonal's add, the skip compare and select; a column and member the six
# profile terms s4[k] - occ2 (JAX subtracts once a cell, but a term depends
# only on the residue code; csrc/refine_dp.cu's warp kernel stages six) and
# the end column's compare and select
GOTOH_OPS_PER_CELL = 20
# the banded-identity kernel's int32 operations a band cell (both passes)
IDENTITY_OPS_PER_CELL = 20
# the clusterer's pair shapes: (name, lengths lo..hi): whole genomes as
# run.genome's, viral CDS as run.device's
IDENTITY_SHAPES = (("genome", 8200, 8400), ("cds", 850, 950))
IDENTITY_WINDOW = 2112
REFINE_OPS_PER_CELL = 7
REFINE_OPS_PER_COLUMN = 8
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


# the banded-identity launchers: the register kernel and the wide one
IDENTITY = ("banded_identity", "banded_identity_wide")


def launched(before, *prefixes):
    """The launches of ``prefixes``, summed, since ``before`` (a
    ``_cuda.launches()``)."""
    now = _cuda.launches()
    return sum(now[p] - before[p] for p in prefixes)


@contextlib.contextmanager
def counted_batches():
    """Count, in the one-item list it yields, the device batches the scans
    inside the block hand the find_hits kernels: each batch of
    ``find_hits_batched``, each shard of a ``find_hits_sharded`` call.
    A scan launches find_hits once a batch, retries included."""
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.parallel import mesh as pmesh
    n = [0]
    batched, sharded = ms.find_hits_batched, pmesh.find_hits_sharded

    def count_batched(target_masks, *a, **kw):
        n[0] += target_masks.shape[0]
        return batched(target_masks, *a, **kw)

    def count_sharded(mesh, *a, **kw):
        n[0] += mesh.devices.size
        return sharded(mesh, *a, **kw)
    ms.find_hits_batched, pmesh.find_hits_sharded = (count_batched,
                                                     count_sharded)
    try:
        yield n
    finally:
        ms.find_hits_batched, pmesh.find_hits_sharded = batched, sharded


def device_env():
    """This checkout first on the path, and every auto scan policy held to
    the device (MPTPU_FORCE_BACKEND): the crossover may give a run's scan
    to the host, and a phase that drives the card's path must not."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env["MPTPU_FORCE_BACKEND"] = "device"
    return env


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
            say("  ptxas %s %s: %d registers, %d B spill stores, %d B spill "
                "loads, %d B static shared memory" % (
                    name, entry["kernel"], entry["registers"],
                    entry["spill_stores"], entry["spill_loads"],
                    entry["smem"]))
            report["ptxas"].setdefault(name, []).append(entry)
    want = {"design_stage_a": ["stage_a_rows_kernel",
                               "stage_a_viterbi_kernel",
                               "stage_a_windows_kernel"],
            "find_hits": sorted(["find_hits_scan_kernel"] + [
                "find_hits_%s_kernel<%d>" % (k, ks)
                for k in ("count", "write") for ks in range(1, 9)]),
            "dimer_fired": ["dimer_fired_kernel"]}
    for name, kernels in want.items():
        got = sorted(e["kernel"] for e in report["ptxas"].get(name, []))
        if got != kernels:
            fail("ptxas reported %s for %s.cu" % (got, name))


def kernel_label(mangled):
    """``name<N>`` (or ``name``) of a mangled kernel: the identifier that
    ends in ``_kernel``, and its integer template argument (the k-steps of
    a tensor-core kernel, the columns a lane of the Gotoh warp kernel)."""
    name = mangled
    for m in re.finditer(r"\d+", mangled):
        run = m.group(0)
        for i in range(len(run)):
            ident = mangled[m.end():m.end() + int(run[i:])]
            if ident.endswith("_kernel") and ident.isidentifier():
                name = ident
    arg = re.search(r"ILi(\d+)E", mangled)
    return name + ("<%s>" % arg.group(1) if arg else "")


def ptxas_entries(log):
    """One dict per compiled kernel of nvcc's -Xptxas -v output: its name
    with its template argument, registers, spill stores and loads, static
    shared memory."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": kernel_label(m.group(1)),
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


def find_hits_equal(ms, dev, masks, lens, p1h, s1h, mm, term, max_hits,
                    what):
    """find_hits (the kernels) against find_hits_reference on the card,
    with int32 and int64 lengths: hit_idx, n_hits and mism equal.
    -> n_hits."""
    import torch
    tm = torch.from_numpy(masks).to(dev)
    planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
    kw = dict(plen=p1h.shape[1], mm=mm, term=term, max_hits=max_hits)
    for dtype in (torch.int32, torch.int64):
        tl = torch.from_numpy(lens).to(dev, dtype)
        got = ms.find_hits(tm, tl, planes, sfx, **kw)
        want = ms.find_hits_reference(tm, tl, planes, sfx, **kw)
        torch.cuda.synchronize()
        if not all(g.dtype == torch.int64 and torch.equal(g, w)
                   for g, w in zip(got, want)):
            fail("find_hits differs from its plain version (%s) at plen=%d "
                 "mm=%d term=%d N=%d L=%d P=%d max_hits=%d lengths %s: "
                 "n_hits %d vs %d" % (
                     what, kw["plen"], mm, term, masks.shape[0],
                     masks.shape[1], p1h.shape[0], max_hits, dtype,
                     int(got[1]), int(want[1])))
    return int(want[1])


def dense_find_hits_cases(rng):
    """(name, masks, lens, p1h, s1h, mm, term) of the dense find_hits
    cases: poly-A rows whose 64-window tiles hold 1,152 hits (past the
    kernel's 1,024-entry list: rounds of whole rows), rows of 1,504 hits
    (a row alone, in pattern slices), many short all-hit rows, and a flat
    size N * O * P that is no multiple of 64 with unpadded P."""
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    lut = np.array(list("ACGT"))
    out = []
    for name, seqs, pats, mm, term in (
            ("poly_a", ["A" * 1000] * 6 + random_seqs(rng, 1, 900, 900),
             ["A" * 18] + ["A" * k + "C" + "A" * (17 - k)
                           for k in range(18)], 1, 1),
            ("row_of_1504", random_seqs(rng, 3, 60, 120),
             ["".join(rng.choice(lut, size=18)) for _ in range(1500)],
             18, 0),
            ("all_hit_rows", random_seqs(rng, 40, 60, 120),
             ["".join(rng.choice(lut, size=18)) for _ in range(40)], 18,
             0),
            ("odd_flat", random_seqs(rng, 3, 60, 101), None, 3, 1)):
        if pats is None:
            pats = planted_patterns(rng, seqs, 5, 18)
            p1h, s1h = pattern_onehots(ms, pats, term)
            p1h, s1h = p1h[:5], s1h[:5]
        else:
            p1h, s1h = pattern_onehots(ms, pats, term)
        masks, lens = ms.encode_target_masks(seqs)
        out.append((name, masks, lens, p1h, s1h, mm, term))
    return out


def call_peak_mib(fn):
    """MiB that one synchronised fn() call allocates above what was
    allocated before it (the peak of torch's allocator)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def measure_find_hits(ms, masks, lens, p1h, s1h, mm, term, max_hits, label):
    """The find_hits kernels vs their plain version (exact) on one batch;
    the hit-code kernel's codes (one call of the entry point ``hit_codes``,
    counted), masked by the window lengths, through torch.nonzero equal to
    the kernels' list; then CUDA-event times of the kernels, the plain
    version, hit_codes + find_hits_from_codes (the path before the
    kernels), the compaction alone and one torch.nonzero of the masked
    codes (the library yardstick, never used by the port), beside the
    bound; each path's peak MiB above its inputs."""
    import torch
    dev = torch.device(DEVICE)
    plen = p1h.shape[1]
    tm = torch.from_numpy(masks).to(dev)
    tl = torch.from_numpy(lens).to(dev)
    planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
    kw = dict(plen=plen, mm=mm, term=term, max_hits=max_hits)
    before = _cuda.launches()
    got = ms.find_hits(tm, tl, planes, sfx, **kw)
    n_launches = launched(before, "find_hits")
    want = ms.find_hits_reference(tm, tl, planes, sfx, **kw)
    torch.cuda.synchronize()
    max_err = max(int((g - w).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
    if max_err != 0 or n_launches != 1:
        fail("find_hits differs from its plain version at the %s (%d "
             "launches)" % (label, n_launches))
    n_hits = int(got[1])
    del want
    before = _cuda.launches()
    codes = ms.hit_codes(tm, planes, sfx, plen=plen, mm=mm, term=term)
    codes_launches = launched(before, "hit_codes")
    n, n_out, p_all = codes.shape
    inside = (torch.arange(n_out, device=dev)[None, :] + plen) \
        <= tl.long()[:, None]
    masked = torch.where(inside[:, :, None], codes, 0).reshape(-1)
    flat = torch.nonzero(masked)[:, 0]
    k = min(n_hits, max_hits)
    if len(flat) != n_hits or not torch.equal(flat[:k], got[0][:k]) \
            or not torch.equal(masked[flat[:k]].long() - 1, got[2][:k]):
        fail("the hit_codes kernel's masked codes differ from the find_hits "
             "kernels' list at the %s" % label)
    kernel_ms = cuda_ms(lambda: ms.find_hits(tm, tl, planes, sfx, **kw), 20)
    plain_ms = cuda_ms(lambda: ms.find_hits_reference(tm, tl, planes, sfx,
                                                      **kw), 3)
    codes_path_ms = cuda_ms(lambda: ms.find_hits_from_codes(
        ms.hit_codes(tm, planes, sfx, plen=plen, mm=mm, term=term), tl,
        plen=plen, max_hits=max_hits), 10)
    compaction_ms = cuda_ms(lambda: ms.find_hits_from_codes(
        codes, tl, plen=plen, max_hits=max_hits), 10)
    library_ms = cuda_ms(lambda: torch.nonzero(masked), 10)
    del codes, masked, flat
    peak_mib = call_peak_mib(lambda: ms.find_hits(tm, tl, planes, sfx, **kw))
    codes_peak_mib = call_peak_mib(lambda: ms.find_hits_from_codes(
        ms.hit_codes(tm, planes, sfx, plen=plen, mm=mm, term=term), tl,
        plen=plen, max_hits=max_hits))
    # the bytes: masks, lengths and both plane sets in, the two lists and
    # n_hits out; the operations: the int8 window product of the windows
    # inside their rows (padding rows need none), 2 * 4 * plen a pair
    windows = int(torch.clamp(tl.long() - plen + 1, 0, n_out).sum())
    in_bytes = masks.nbytes + lens.nbytes + 2 * planes.numel() * 8
    out_bytes = 2 * max_hits * 8 + 8
    out = {"shape": {"N": n, "L": masks.shape[1], "O": n_out, "P": p_all,
                     "plen": plen, "mm": mm, "term": term,
                     "max_hits": max_hits, "windows_inside": windows},
           "hits": n_hits, "max_abs_err": max_err, "launches": n_launches,
           "hit_codes_launches": codes_launches, "ms": kernel_ms,
           "plain_ms": plain_ms, "codes_path_ms": codes_path_ms,
           "compaction_ms": compaction_ms, "library_ms": library_ms,
           "peak_mib": peak_mib,
           "codes_path_peak_mib": codes_peak_mib,
           **bound(in_bytes + out_bytes, 2 * windows * p_all * 4 * plen,
                   INT8_OPS_PER_S)}
    say("%s find_hits N=%d L=%d P=%d plen=%d mm=%d term=%d max_hits=%d: "
        "equal, %d hits, == hit_codes' masked nonzero; kernels_ms=%.4f "
        "plain_ms=%.4f hit_codes+compaction_ms=%.4f (compaction alone "
        "%.4f) library_ms=%.4f (torch.nonzero) bound_ms=%.4f (%s, %.1f%%); "
        "peak MiB %.1f (hit_codes+compaction %.1f)"
        % (label, n, masks.shape[1], p_all, plen, mm, term, max_hits,
           n_hits, kernel_ms, plain_ms, codes_path_ms, compaction_ms,
           library_ms, out["bound_ms"], out["bound_by"],
           100 * out["bound_ms"] / kernel_ms, peak_mib, codes_peak_mib))
    return out


def phase_find_hits(args, report):
    import torch
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.validate import scan as vscan
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(args.seed + 1)
    # the kernels against their plain version: phase 2's edge grid with a
    # zero-length padding row after the first and three after the last,
    # max_hits cycling below, far above, at 1 and at 0 hits
    cases = hits = 0
    for i, (plen, mm, term, n_pat, lo, hi) in enumerate(edge_grid(rng)):
        seqs = random_seqs(rng, int(rng.integers(1, 40)), lo, hi,
                           letters="ACGTacgtNRY-")
        p1h, s1h = grid_patterns(ms, rng, seqs, n_pat, plen, term)
        masks, lens = ms.encode_target_masks(seqs)
        pad = np.zeros((4, masks.shape[1]), np.uint8)
        masks = np.concatenate([masks[:1], pad[:1], masks[1:], pad[1:]])
        lens = np.concatenate([lens[:1], [0], lens[1:], [0, 0, 0]]).astype(
            np.int32)
        hits += find_hits_equal(ms, dev, masks, lens, p1h, s1h, mm, term,
                                (7, 1 << 14, 1, 0)[i % 4], "edge grid")
        cases += 1
    dense = []
    for name, masks, lens, p1h, s1h, mm, term in dense_find_hits_cases(rng):
        counts = [find_hits_equal(ms, dev, masks, lens, p1h, s1h, mm, term,
                                  max_hits, name)
                  for max_hits in (100, 5000, 1 << 16, 1 << 20)]
        if len(set(counts)) != 1 or counts[0] <= (
                0 if name == "odd_flat" else 5000):
            fail("find_hits case %s: n_hits %s" % (name, counts))
        dense.append("%s %d" % (name, counts[0]))
        cases += 4
    say("phase 3 find_hits kernels == plain version: %d cases (%d edge-grid "
        "hits; dense: %s)" % (cases, hits, ", ".join(dense)))
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
    report["find_hits_checks"] = {"cases": cases, "hits": len(got),
                                  "retry_hits": len(dev_hits)}


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
    nproc = os.cpu_count() or 1
    # the run is a process of its own (CLI_DRIVER): its kernel launches
    # come back in pipeline_metrics.json, its scan's device batches in the
    # side file
    side = run_cli(["run", "-i", fa, "-r", res, "--device", DEVICE,
                    "--pcr-products", "summary", "--nproc", str(nproc)],
                   work, "run")
    wall = side["process_s"]
    with open(os.path.join(res, "pipeline_metrics.json")) as f:
        metrics = json.load(f)
    backends = metrics["backends"]
    n_launches = backends["launches"]["find_hits"]
    say("phase 4 run: %.1f s wall, nproc=%d, scan_backend=%s, device=%s, "
        "find_hits launches=%d for %d device batches of its scan"
        % (wall, nproc, backends.get("scan_backend"),
           backends.get("device_name"), n_launches, side["batches"]))
    say("phase 4 stages (s): " + json.dumps(metrics["timings_s"]))
    if n_launches <= 0 or n_launches != side["batches"] \
            or backends.get("scan_backend") != "device":
        fail("run did not scan through the find_hits kernels once a batch")
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
                     "launches": n_launches, "batches": side["batches"],
                     "bwt_rows": rows,
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
    masks, lens = ms.encode_target_masks(seqs[:bs], length=pad_len)
    report["hit_codes_run_shape"] = measure_kernel(
        ms, masks, p1h, s1h, 1, 1, "phase 4 kernel at the run's shape")
    report["find_hits_run_shape"] = measure_find_hits(
        ms, masks, lens, p1h, s1h, 1, 1, 1 << 17, "phase 4 at the run's "
        "shape")
    return res, n_launches


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
    outs, walls, peaks, scan_launches = {}, {}, {}, {}
    for backend in ("device", "numpy"):
        outs[backend] = os.path.join(work, "scan_" + backend, "cov.out")
        os.makedirs(os.path.dirname(outs[backend]))
        before = _cuda.launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with counted_batches() as batches:
            rc = cli.main(["scan", *flags, "-o", outs[backend], "--backend",
                           backend, "--device", DEVICE])
        torch.cuda.synchronize()
        walls[backend] = time.time() - t0
        peaks[backend] = torch.cuda.max_memory_allocated()
        if rc != 0:
            fail("scan --backend %s exited %d" % (backend, rc))
        n = scan_launches[backend] = launched(before, "find_hits")
        if (n > 0) != (backend == "device") or n != batches[0]:
            fail("scan --backend %s made %d find_hits launches for %d "
                 "device batches" % (backend, n, batches[0]))
        say("phase 5 scan --backend %s: %.2f s wall, peak device memory "
            "%.1f MiB, find_hits launches %d" % (
                backend, walls[backend], peaks[backend] / 2 ** 20, n))
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
                   "-m", "4", "-s", "50,2000", "-o", out4, "--backend",
                   "device", "--device", DEVICE])
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
                      "find_hits_launches": scan_launches["device"],
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
    # the path: one call, its launches counted
    before = _cuda.launches()
    torch.cuda.synchronize()
    t0 = time.time()
    got = ms.find_hits_bitmap(t1h, lens, p1h, s1h, mm=mm, term=term,
                              device=dev)
    wall = time.time() - t0
    n_launches = launched(before, "hit_window_bitmap")
    if n_launches <= 0:
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
        "batches (%.2f s wall)" % (len(seqs), p_all, wall, n_launches,
                                   flagged, len(got[0]), -(-len(seqs) // bs),
                                   dense_wall))
    report["bitmap_path"] = {"wall_s": wall, "launches": n_launches,
                             "flagged_windows": flagged, "hits": len(got[0]),
                             "find_hits_wall_s": dense_wall}
    report["hit_window_bitmap"] = measure_bitmap(ms, tm, planes, sfx, plen,
                                                 mm, term, bs)
    report["hit_window_bitmap"]["launches"] = n_launches


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
    fused (dimer_fired kernel) and unfused (match-count kernel) device
    paths equal to each other and to the host search on a seeded sample;
    then the match-count kernel timed at the fused path's first bucket,
    the dimer_fired kernel held to its plain version on an edge grid and
    timed at that bucket."""
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
    walls, path_launches = {}, {}
    t_phase = time.time()
    mats = {}
    # the fused path through the dimer_fired kernel alone, the unfused one
    # through the match-count kernel alone
    for fn, kernel in (("dimer_hit_matrix_fused", "dimer_fired"),
                       ("dimer_hit_matrix", "match_counts")):
        before = _cuda.launches()
        torch.cuda.synchronize()
        t0 = time.time()
        mats[fn] = getattr(dimer, fn)(primers, device=dev)
        torch.cuda.synchronize()
        walls[fn] = time.time() - t0
        counts = {k: launched(before, k)
                  for k in ("dimer_fired", "match_counts")}
        path_launches[fn] = counts[kernel]
        if counts[kernel] <= 0 or sum(counts.values()) != counts[kernel]:
            fail("%s launched %s, not the %s kernel alone"
                 % (fn, counts, kernel))
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
           path_launches["dimer_hit_matrix_fused"],
           walls["dimer_hit_matrix"], path_launches["dimer_hit_matrix"],
           int(hit.sum()), len(sample),
           host_s))
    report["dimer"] = {"P": len(primers), "unique": len(uniq), "T": n_t,
                       "E": n_e, "wall_s": walls, "launches": path_launches,
                       "pairs": int(hit.sum()), "sample": len(sample),
                       "host_sample_s": host_s,
                       "phase_s": time.time() - t_phase}
    report["match_counts"] = measure_counts(ms, dimer, lay, dev)
    report["match_counts"]["launches"] = path_launches["dimer_hit_matrix"]
    cases = dimer_grid_equal(dimer, ms, dev, rng)
    report["dimer_fired"] = measure_dimer_fired(ms, dimer, lay, dev)
    report["dimer_fired"].update(
        launches=path_launches["dimer_hit_matrix_fused"], grid_cases=cases)


def dimer_edge_inputs(ms, rng, lp, width=None, n_t=37, n_e=300):
    """Fused-pass inputs: targets of 0-40 bases left-padded by z = lp - 5
    (every 7th a zero-length padding row), ends of 5..lp bases cut from a
    target's first window, its last, or one between (every 4th random),
    trigger rows of W columns with columns 0 and W - 1 set, so that d2
    clips at both ends."""
    z = lp - 5
    lut = np.array(list("ACGT"))
    seqs = [("".join(rng.choice(lut, size=int(rng.integers(5, 41))))
             if t % 7 else "") for t in range(n_t)]
    lns = rng.integers(5, min(lp, 40) + 1, size=n_e)
    lns[0] = 5
    ends = []
    for e, ln in enumerate(lns):
        s = seqs[int(rng.integers(0, n_t))]
        if len(s) >= ln and e % 4:
            at = (0, len(s) - ln, int(rng.integers(0, len(s) - ln + 1)))[
                e % 3]
            ends.append(s[at:at + ln])
        else:
            ends.append("".join(rng.choice(lut, size=int(ln))))
    t_len = z + 40
    t_len += -t_len % 16
    masks = np.zeros((n_t, t_len), np.uint8)
    codes, lens = ms.encode_target_codes(seqs)
    masks[:, z:z + codes.shape[1]] = codes
    p1h = np.zeros((n_e, lp, 4), np.uint8)
    for k, e in enumerate(ends):
        p1h[k, lp - len(e):] = ms.encode_primers([e])[0]
    width = width or int(rng.integers(3, 30))
    trig = rng.random((n_e, width)) < 0.5
    trig[:, 0] = True
    trig[1::2, -1] = True
    return (masks, lens.astype(np.int64), p1h, lns.astype(np.int64),
            (lp - lns).astype(np.int64), z, trig)


def fused_args(ms, dev, masks, lens, p1h, lns, shifts, z, trig):
    """The arguments of dimer._fused_kernel on the card."""
    import torch
    return [torch.from_numpy(masks).to(dev), torch.from_numpy(lens).to(dev),
            ms.pattern_planes(p1h, device=dev), p1h.shape[1], z,
            torch.from_numpy(lns).to(dev), torch.from_numpy(shifts).to(dev),
            torch.from_numpy(trig).to(dev)]


def dimer_grid_equal(dimer, ms, dev, rng):
    """The dimer_fired kernel against its plain version on the edge grid
    (lp 8, 24, 40, 64; trigger rows of 1, 2, 65 and a random number of
    columns) -> cases."""
    import torch
    cases = 0
    for lp in (8, 24, 40, 64):
        for width in (None, 1, 2, 65):
            args = fused_args(ms, dev, *dimer_edge_inputs(ms, rng, lp,
                                                          width))
            got = dimer._fused_kernel(*args)
            want = dimer._fused_kernel_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or not bool(want.any()):
                fail("dimer_fired differs from its plain version at lp=%d "
                     "W=%d (%d vs %d fired)" % (
                         lp, args[-1].shape[1], int(got.sum()),
                         int(want.sum())))
            cases += 1
    say("phase 8 dimer_fired grid: %d cases equal (lp 8-64, d2 clipped at "
        "both ends, padding rows)" % cases)
    return cases


def measure_dimer_fired(ms, dimer, lay, dev):
    """The dimer_fired kernel at the fused path's first bucket vs its plain
    version (exact), then CUDA-event times of kernel and plain version
    (match counts + torch epilogue) beside the bound: the operations are a
    dozen int32 operations for each window this data tests (from the
    first skipped window to the first hit or the last window inside the
    target), the bytes each input once and the verdicts."""
    import torch
    lp, z = lay["lp"], lay["z"]
    t_len = lay["masks"].shape[1]
    tb = min(1024, ms.safe_batch_size(1024, t_len - lp + 1, 4096))
    args = fused_args(ms, dev, lay["masks"][:tb], lay["lengths"][:tb].astype(
        np.int64), lay["p1h"][:4096], lay["lns"][:4096].astype(np.int64),
        lay["shifts"][:4096].astype(np.int64), z, lay["trig"][:4096])
    masks, lens, planes, _, _, ln_vec, shift_vec, trig = args
    got = dimer._fused_kernel(*args)
    want = dimer._fused_kernel_reference(*args)
    torch.cuda.synchronize()
    max_err = int((got.int() - want.int()).abs().max())
    if max_err != 0:
        fail("dimer_fired differs from its plain version at the fused "
             "bucket")
    fired = int(want.sum())
    # the windows a thread tests: o from max(0, z - shift) to the first
    # hit, or to its last window inside the target when none hits
    counts = ms.match_counts_reference(masks, planes, plen=lp)
    n_out = counts.shape[1]
    o = torch.arange(n_out, device=dev)[None, :, None]
    real_o = o + (shift_vec - z)[None, None, :]
    ok = (counts >= ln_vec[None, None, :]) & (real_o >= 0) \
        & ((real_o + ln_vec[None, None, :]) <= lens[:, None, None])
    del counts, real_o
    start = (z - shift_vec).clamp(min=0)[None, :]
    last = torch.minimum(lens[:, None] - ln_vec[None, :]
                         - (shift_vec - z)[None, :],
                         torch.full_like(start, n_out - 1))
    exists = ok.any(dim=1)
    first = ok.to(torch.uint8).argmax(dim=1)
    tested = int(torch.where(exists, first - start + 1,
                             (last - start + 1).clamp(min=0)).sum())
    del ok
    kernel_ms = cuda_ms(lambda: dimer._fused_kernel(*args), 20)
    plain_ms = cuda_ms(lambda: dimer._fused_kernel_reference(*args), 5)
    n, e_all = masks.shape[0], planes.shape[0]
    in_bytes = masks.numel() + 8 * n + e_all * (32 + 16) + trig.numel()
    out = {"shape": {"T": n, "L": t_len, "O": n_out, "E": e_all, "lp": lp,
                     "W": trig.shape[1]},
           "fired": fired, "windows_tested": tested,
           "windows_all": n * n_out * e_all, "max_abs_err": max_err,
           "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
           **bound(in_bytes + n * e_all, 12 * tested, INT32_OPS_PER_S)}
    say("phase 8 dimer_fired kernel T=%d L=%d E=%d lp=%d: equal, %d fired; "
        "windows tested %d of %d; kernel_ms=%.4f plain_ms=%.4f (match "
        "counts + torch epilogue) bound_ms=%.4f (%s, %.1f%%)"
        % (n, t_len, e_all, lp, fired, tested, out["windows_all"],
           kernel_ms, plain_ms, out["bound_ms"], out["bound_by"],
           100 * out["bound_ms"] / kernel_ms))
    return out


def measure_counts(ms, dimer, lay, dev):
    """The match-count kernel at the fused path's first bucket vs its plain
    version (exact), then CUDA-event times of kernel, plain version and a
    conv1d yardstick beside the bound."""
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
    # masks and planes in, float32 counts out; the bf16-matmul form's
    # operations
    out = {"shape": {"T": n, "L": t_len, "O": n_out, "E": p_all, "lp": lp},
           "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           **bound(n * t_len + p_all * 32 + 4 * n * n_out * p_all,
                   2 * n * n_out * p_all * 4 * lp, BF16_OPS_PER_S)}
    say("phase 8 match_counts kernel T=%d L=%d O=%d E=%d lp=%d: equal; "
        "kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f bound_ms=%.4f (%s)"
        % (n, t_len, n_out, p_all, lp, kernel_ms, plain_ms, library_ms,
           out["bound_ms"], out["bound_by"]))
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
    env = device_env()
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
    run_launches = backends["launches"]
    find_launches = run_launches["find_hits"]
    say("phase 9 device run: %.1f s wall, nproc=%d, device=%s, Stage A "
        "served %s, align served %s, find_hits launches=%d"
        % (wall, nproc, backends.get("device_name"), json.dumps(stage_a),
           json.dumps(align), find_launches))
    if set(stage_a) != {"device"} or set(align) - {"device", "none"} \
            or align.get("device", 0) <= 0:
        fail("the device run's Stage A or align DP did not run on the card")
    if find_launches <= 0 or find_launches != report["run"]["launches"]:
        fail("the device run made %d find_hits launches, phase 4's run of "
             "the same scan %d" % (find_launches, report["run"]["launches"]))
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
    # the Gotoh kernel's launches in the run's cluster workers, against the
    # blocks the run's MSAs call for
    from multiprime_tpu_torch.align import device as adev
    _, design_blocks, gotoh_blocks, wide_blocks = run_blocks(res)
    stage_a_launches = run_launches["stage_a_windows"]
    say("phase 9 Stage-A windows kernel launches %d for the run's %d "
        "Stage-A blocks (design stage %s s summed over workers, host run %s "
        "s)" % (stage_a_launches, design_blocks, dev_t.get("design"),
                host_t.get("design")))
    if stage_a_launches != design_blocks:
        fail("the device run made %d Stage-A kernel launches for %d Stage-A "
             "blocks" % (stage_a_launches, design_blocks))
    gotoh_launches = run_launches["gotoh_dp"] + run_launches["gotoh_dp_warp"]
    warp_launches = run_launches["gotoh_dp_warp"]
    refine_launches = run_launches["refine_dp"] + run_launches["refine_dp_warp"]
    say("phase 9 align stage %s s summed over workers (host run %s s); "
        "gotoh_dp launches %d for gotoh_blocks_per_run %d, %d of them of "
        "gotoh_dp_warp_kernel (%d blocks of MSAs wider than its %d "
        "columns); refine_dp launches %d (refine_msa takes native)"
        % (dev_t.get("align"), host_t.get("align"), gotoh_launches,
           gotoh_blocks, warp_launches, wide_blocks, adev._GOTOH_WARP_MAX_COLS,
           refine_launches))
    if gotoh_launches != gotoh_blocks:
        fail("the device run made %d gotoh_dp launches for %d Gotoh blocks"
             % (gotoh_launches, gotoh_blocks))
    if not gotoh_blocks - wide_blocks <= warp_launches <= gotoh_blocks:
        fail("the device run's warp-kernel launches (%d) do not match its "
             "%d Gotoh blocks, %d of them possibly wide"
             % (warp_launches, gotoh_blocks, wide_blocks))
    report["device_run"] = {"wall_s": wall, "nproc": nproc,
                            "timings_s": dev_t, "stage_a_served": stage_a,
                            "align_served": align, "files": n_files,
                            "host_wall_s": report["run"]["wall_s"],
                            "host_timings_s": host_t,
                            "gotoh_dp_launches": gotoh_launches,
                            "gotoh_dp_warp_launches": warp_launches,
                            "refine_dp_launches": refine_launches,
                            "refine_dp_warp_launches": run_launches[
                                "refine_dp_warp"],
                            "stage_a_kernel_launches": stage_a_launches,
                            "find_hits_launches": find_launches,
                            "design_blocks_per_run": design_blocks,
                            "gotoh_blocks_per_run": gotoh_blocks}
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


def kernel_breakdown(fn, top=8):
    """{CUDA kernel name (cut to 60 characters): [device ms, launches]} of
    one fn() call from torch.profiler, the top kernels by time, or None
    where the profiler gives no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except (RuntimeError, AttributeError) as e:
        say("  torch.profiler gave no device events: %s" % e)
        return None
    out = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            k = e.name[:60]
            ms_, n = out.get(k, (0.0, 0))
            out[k] = (ms_ + (e.time_range.end - e.time_range.start) / 1e3,
                      n + 1)
    ranked = sorted(out.items(), key=lambda kv: -kv[1][0])[:top]
    return {k: [round(v[0], 4), v[1]] for k, v in ranked} or None


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


def run_blocks(res):
    """(cluster sizes and names, Stage-A blocks, Gotoh blocks, wide Gotoh
    blocks) of the run in res: ceil(W / 512) Stage-A blocks a designed
    cluster, ceil((rows - 1) / 512) Gotoh blocks a cluster of more than one
    row, wide ones those of a cluster whose MSA is wider than the Gotoh
    warp kernel's limit (any of its blocks may take the CTA kernel)."""
    from multiprime_tpu_torch.align import device as adev
    from multiprime_tpu_torch.models import mcdpd
    with open(os.path.join(res, "cluster.txt")) as f:
        sizes = [(int(n), name) for name, n in
                 (line.split("\t") for line in f.read().splitlines()[1:])]
    eng = mcdpd.DesignEngine(mcdpd.DesignParams(
        coverage=0.7, min_product=150, coordinate="2,3,-1"))
    design_blocks = gotoh_blocks = wide_blocks = 0
    for n, name in sizes:
        _, chars = mcdpd.parse_msa(os.path.join(res, "Clusters_msa",
                                                name + ".tmsa"))
        if chars.shape[0] > 1:
            blocks = -(-(chars.shape[0] - 1) // 512)
            gotoh_blocks += blocks
            if chars.shape[1] + 1 > adev._GOTOH_WARP_MAX_COLS:
                wide_blocks += blocks
        try:
            start, stop = eng.usable_span(chars)
        except ValueError:
            continue
        design_blocks += -(-max(stop - 18 - start, 0) // 512)
    return sizes, design_blocks, gotoh_blocks, wide_blocks


def same_op_codes(a, b):
    """Forward op-code matrices equal up to their pad widths (3 past)."""
    s = min(a.shape[1], b.shape[1])
    return (np.array_equal(a[:, :s], b[:, :s]) and (a[:, s:] == 3).all()
            and (b[:, s:] == 3).all())


def dp_grid_equal(dev):
    """The GPU tests' tie-heavy DP cases at 8 times their lengths (members
    of more than 256 bases give a thread two columns, 33 members in blocks
    of 32 leave a block of one): gotoh_block (the warp kernel, then the
    CTA kernel forced) and refine_block (the warp kernel, then the CTA
    kernel forced) on the card equal to their plain versions on the card
    -> blocks checked."""
    from multiprime_tpu_torch.align import device as adev
    from tests import test_torch_gpu as gpu_tests
    blocks = 0
    limit = adev._GOTOH_WARP_MAX_COLS
    ref_limit = adev._REFINE_WARP_MAX_POS
    for name in gpu_tests.DP_CASES:
        c, members, block = gpu_tests.dp_case(name, scale=8)
        rows = gpu_tests.dp_case_rows(c, members)
        try:
            blocks += gpu_tests.dp_blocks_equal_plain(
                dev, c, members, block, rows)
            adev._GOTOH_WARP_MAX_COLS = 0
            adev._REFINE_WARP_MAX_POS = 0
            blocks += gpu_tests.gotoh_blocks_equal_plain(
                dev, c, members, block, "cta")
            blocks += gpu_tests.refine_blocks_equal_plain(
                dev, rows, block, "cta")
        except AssertionError as e:
            fail("a DP kernel differs from its plain version on the %s case "
                 "(%s)" % (name, e))
        finally:
            adev._GOTOH_WARP_MAX_COLS = limit
            adev._REFINE_WARP_MAX_POS = ref_limit
    return blocks


def measure_dp(name, kernel, plain, args, m, n_bytes, ops, ops_per_s):
    """One block of a DP kernel on the card: equal to its plain version
    (so max_abs_err 0), CUDA-event times of both (mean after one warm-up), the
    trace's share of the CTAs' clock64 cycles, and the bound."""
    import torch
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        fail("%s differs from its plain version on phase 10's block" % name)
    clocks = torch.zeros((m, 3), dtype=torch.int64, device=got.device)
    kernel(*args, clocks=clocks)
    torch.cuda.synchronize()
    ck = clocks.cpu().numpy().astype(np.float64)
    share = float((ck[:, 2] - ck[:, 1]).sum()
                  / max((ck[:, 2] - ck[:, 0]).sum(), 1.0))
    ms = cuda_ms(lambda: kernel(*args), 10)
    plain_ms = cuda_ms(lambda: plain(*args), 1)
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                trace_share=share, trace_ms=ms * share,
                **bound(n_bytes, ops, ops_per_s))


def profiled_launches(fn, kernel_name):
    """(launches of the named kernel, CUDA activities, device busy ms, the
    breakdown) of one fn() call from torch.profiler at full size; fails
    where the profiler gives no device events."""
    prof = kernel_breakdown(fn, top=50)
    if prof is None:
        fail("torch.profiler gave no device events for one %s block"
             % kernel_name)
    n = sum(v[1] for k, v in prof.items() if kernel_name in k)
    return (n, sum(v[1] for v in prof.values()),
            sum(v[0] for v in prof.values()), prof)


def stage_a_counts(before):
    """The launches of the three Stage-A kernels since ``before`` (a
    ``_cuda.launches()``)."""
    return {k: launched(before, "stage_a_" + k)
            for k in ("rows", "windows", "viterbi")}


def stage_a_grid_equal(dev):
    """The GPU tests' Stage-A edge grid (gap runs longer than plen, all-gap
    rows, N-heavy windows, N = 1, plen 8-40, windows at the rows' ends),
    the wrap cases (sums past 2**31, expansion counts past 2**63, plen 18,
    31, 32, 40) and a plen too long for the shared sums: the kernels on
    the card equal to their plain versions on the card and on the CPU ->
    windows checked."""
    from tests import test_torch_gpu as gpu_tests
    cases = [(gpu_tests.stage_a_edge_masks(seed, n, length, plen),
              np.arange(0, length - plen + 1), plen, variation)
             for seed, n, length, plen, variation
             in gpu_tests.STAGE_A_EDGE_CASES]
    cases += [gpu_tests.stage_a_wrap_masks(plen) + (plen, 1)
              for plen in (18, 31, 32, 40)]
    long_rows = np.random.default_rng(5).choice(
        np.array([0, 1, 2, 4, 8, 5, 15], np.int32), size=(3, 1400))
    cases.append((long_rows, np.array([0, 7, 99]), 1300, 1300))
    windows = 0
    for masks, positions, plen, variation in cases:
        try:
            windows += gpu_tests.stage_a_equal_plain(dev, masks, positions,
                                                     plen, variation)
        except AssertionError as e:
            fail("a Stage-A kernel differs from its plain version on the "
                 "edge grid at plen %d, N %d, L %d (%s)"
                 % (plen, masks.shape[0], masks.shape[1], e))
    return len(cases), windows


def measure_stage_a(dev, masks, positions, nb, report):
    """The three Stage-A kernels (csrc/design_stage_a.cu) on the largest
    cluster: every block equal to the plain version on the card; one
    512-window block timed (CUDA events, mean of 20 launches after a
    warm-up, each kernel alone), its launches and each kernel's device
    time (torch.profiler), the plain version's time and launches, and the
    block's bound; then the edge grid."""
    import torch
    from multiprime_tpu_torch.ops import design_scan as ds
    plen, variation = 18, 1
    masks_d = torch.from_numpy(np.ascontiguousarray(masks, np.int32)).to(dev)
    rows = ds.stage_a_rows(masks_d)
    for b0 in range(0, len(positions), 512):
        pos = positions[b0:b0 + 512]
        got = ds._stats(masks_d, pos, plen, variation, True, rows)
        want = ds.design_stats_full_reference(masks_d, pos, plen=plen,
                                              variation=variation, device=dev)
        torch.cuda.synchronize()
        for key in want:
            if got[key].dtype != want[key].dtype \
                    or not torch.equal(got[key], want[key]):
                fail("the Stage-A kernels' %s differs from the plain "
                     "version on the card at the block at %d" % (key, b0))
    lib = _cuda.load("design_stage_a")
    pos = positions[:512]
    pos_d = torch.from_numpy(np.asarray(pos, np.int64)).to(dev)
    stats = ds.window_stats_from_masks(masks_d, pos, plen=plen,
                                       variation=variation, with_win=True,
                                       rows=rows)
    win = stats.pop("win")
    path = ds.viterbi_batch(stats["freq"], stats["nn"], device=dev)
    n, length = masks_d.shape
    w = len(pos)
    ms = {"rows": cuda_ms(lambda: ds.launch_rows(lib, masks_d, *rows), 20),
          "windows": cuda_ms(lambda: ds.launch_windows(
              lib, masks_d, rows, pos_d, stats, win, plen, variation), 20),
          "viterbi": cuda_ms(lambda: ds.launch_viterbi(
              lib, stats["freq"], stats["nn"], path), 20)}
    block_ms = ms["windows"] + ms["viterbi"] + ms["rows"] / nb
    plain_ms = cuda_ms(lambda: ds.design_stats_full_reference(
        masks_d, pos, plen=plen, variation=variation, device=dev), 3)
    kern = kernel_breakdown(lambda: list(ds.design_stats_blocks(
        masks, pos, plen=plen, variation=variation, device=dev)), top=50)
    plain_prof = kernel_breakdown(lambda: ds.design_stats_full_reference(
        masks_d, pos, plen=plen, variation=variation, device=dev), top=500)
    if kern is None or plain_prof is None:
        fail("torch.profiler gave no device events for one Stage-A block")
    by_kernel = {k: v for k, v in kern.items() if "stage_a_" in k}
    if sorted(v[1] for v in by_kernel.values()) != [1, 1, 1]:
        fail("one Stage-A block launched %s" % json.dumps(by_kernel))
    # the bound: the block's mask columns read once, its outputs written
    # once; the operations its data needs (int32 rate): a cell's mc, gap
    # compare and count, product, pair product and the two floor
    # divisions (7), one add a member base and a pair of bases of the
    # alive rows, and 3 a Viterbi transition (two adds, a compare)
    win_h = win.cpu().numpy()
    pop = np.array([bin(i).count("1") for i in range(16)])[win_h & 15]
    alive = ((win_h == 0).sum(axis=2) <= variation)[:, :, None]
    adds = int((pop * alive).sum() + (pop[:, :, :-1] * pop[:, :, 1:]
                                      * alive).sum())
    cells = n * w * plen
    n_bytes = (4 * n * (w + plen - 1) + 8 * w + cells
               + 8 * w * (4 * plen + 16 * (plen - 1)) + 16 * w + 4 * w * plen)
    ops = 7 * cells + adds + 3 * 16 * w * (plen - 1)
    b = bound(n_bytes, ops, INT32_OPS_PER_S)
    grid_cases, grid_windows = stage_a_grid_equal(dev)
    res = dict(ms=block_ms, kernel_ms=ms, plain_ms=plain_ms,
               profile_one_block=kern, launches_per_block=sum(
                   v[1] for v in by_kernel.values()),
               activities_per_block=sum(v[1] for v in kern.values()),
               busy_ms_per_block=sum(v[0] for v in kern.values()),
               plain_launches_per_block=sum(v[1] for v in plain_prof.values()),
               plain_busy_ms_per_block=sum(v[0] for v in plain_prof.values()),
               max_abs_err=0, N=n, L=length, W=w, cells=cells, adds=adds,
               grid_cases=grid_cases, grid_windows=grid_windows,
               ptxas=report["ptxas"].get("design_stage_a"), **b)
    say("phase 10 Stage-A kernels (csrc/design_stage_a.cu) == their plain "
        "versions on the card on all %d blocks of the cluster and on the "
        "edge grid (%d cases, %d windows, max_abs_err 0); one block (N=%d, "
        "L=%d, W=%d): rows %.4f ms a call, windows %.4f ms, viterbi %.4f "
        "ms, %.4f ms a block (the rows' call shared by %d blocks); the "
        "plain torch ops %.3f ms (%d CUDA activities, %.3f device ms); "
        "bound %.4f ms (%s, %.1f%%); torch.profiler, one block's call: %d "
        "kernel launches of %d CUDA activities, %.4f device ms: %s"
        % (nb, grid_cases, grid_windows, n, length, w, ms["rows"],
           ms["windows"], ms["viterbi"], block_ms, nb, plain_ms,
           res["plain_launches_per_block"], res["plain_busy_ms_per_block"],
           b["bound_ms"], b["bound_by"], 100 * b["bound_ms"] / block_ms,
           res["launches_per_block"], res["activities_per_block"],
           res["busy_ms_per_block"], json.dumps(kern)))
    return res


def phase_device_ops(args, report, res):
    """The device torch ops of Stage A and the DP kernels on the largest
    cluster of the device run, each held to its counterpart and timed."""
    import torch
    from multiprime_tpu_torch import native
    from multiprime_tpu_torch.align import centerstar, refine
    from multiprime_tpu_torch.align import device as adev
    from multiprime_tpu_torch.models import mcdpd
    from multiprime_tpu_torch.ops import design_scan
    from multiprime_tpu_torch.utils import iupac
    from multiprime_tpu_torch.validate import scan as vscan
    dev = torch.device(DEVICE)
    sizes, design_blocks, gotoh_blocks, _ = run_blocks(res)
    params = mcdpd.DesignParams(coverage=0.7, min_product=150,
                                coordinate="2,3,-1")
    eng = mcdpd.DesignEngine(params)
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
    nb = len(got)
    walls = {}
    for backend in ("host", "device"):
        e = mcdpd.DesignEngine(mcdpd.DesignParams(
            coverage=0.7, min_product=150, coordinate="2,3,-1",
            stage_a=backend, device=dev))
        before = _cuda.launches()
        t0 = time.perf_counter()
        rows = e.design(ids, chars)
        walls[backend] = time.perf_counter() - t0
        counts = stage_a_counts(before)
        if backend == "host":
            host_rows = [(r.position, r.primer, r.coverage) for r in rows]
        elif [(r.position, r.primer, r.coverage) for r in rows] != host_rows:
            fail("design rows of %s differ between host and device Stage A"
                 % name)
        want = {"rows": 1, "windows": nb, "viterbi": nb} \
            if backend == "device" else dict.fromkeys(counts, 0)
        if counts != want:
            fail("the design of %s with %s Stage A launched the Stage-A "
                 "kernels %s times, not %s" % (name, backend, counts, want))
    out["design_stats_blocks"] = {
        "N": int(masks.shape[0]), "W": len(positions), "blocks": nb,
        "ms_per_block": dev_ms / nb, "cpu_torch_ms_per_block": cpu_ms / nb,
        "peak_mib": peak, "profile_one_block": prof,
        "design_wall_s": walls}
    say("phase 10 design_stats_blocks on %s (N=%d, W=%d, %d blocks of 512): "
        "card == CPU; %.3f ms a block on the card (the wall, copies "
        "included), %.1f ms on the CPU; peak %.1f MiB; one block: %s "
        "(CUDA activities, device busy ms); design wall host Stage A %.2f "
        "s, device Stage A %.2f s (the three kernels launched 1, %d, %d "
        "times), rows equal"
        % (name, masks.shape[0], len(positions), nb, dev_ms / nb,
           cpu_ms / nb, peak, prof, walls["host"], walls["device"], nb, nb))
    out["stage_a"] = measure_stage_a(dev, masks, positions, nb, report)

    # the center-star DP: the run's members (the sampled .tfa) against
    # native, then one block of 512 members of the whole cluster; the
    # corpus has substitutions only, so each member gets 0-3 seeded indels
    # of 1-12 bases, which the affine states and the refine moves need
    rng = np.random.default_rng(args.seed + 4)
    _, seqs = vscan.parse_fasta(os.path.join(res, "Clusters_fa",
                                             name + ".tfa"))
    seqs = [with_indels(rng, s) for s in seqs]
    codes = [centerstar._encode(s) for s in seqs]
    center = centerstar.pick_center(seqs)
    members = [codes[m] for m in range(len(seqs)) if m != center]
    before = _cuda.launches()
    got = adev.align_ops_batch_device(codes[center], members,
                                      as_codes=True, device=dev)
    cluster_launches = launched(before, "gotoh_dp", "gotoh_dp_warp")
    cluster_warp = launched(before, "gotoh_dp_warp")
    nat = native.gotoh_ops_batch(codes[center], members)
    if nat is None:
        fail("native.gotoh_ops_batch is unavailable")
    if not same_op_codes(got, nat):
        fail("align_ops_batch_device differs from native.gotoh_ops_batch on "
             "%s" % name)
    if cluster_launches != -(-len(members) // 512):
        fail("align_ops_batch_device made %d gotoh_dp launches for %d "
             "members" % (cluster_launches, len(members)))
    warp_blocks = sum(
        adev.gotoh_kernel_plan(max(max(len(b) for b in members[lo:lo + 512]),
                                   1))[0] == "gotoh_dp_warp"
        for lo in range(0, len(members), 512))
    if cluster_warp != warp_blocks:
        fail("align_ops_batch_device made %d warp-kernel launches for %d "
             "blocks of its width" % (cluster_warp, warp_blocks))
    _, all_seqs = vscan.parse_fasta(os.path.join(res, "Clusters_fa",
                                                 name + ".fa"))
    block = [centerstar._encode(with_indels(rng, s)) for s in all_seqs[:512]]
    c = codes[center]
    t0 = time.perf_counter()
    nat_block = native.gotoh_ops_batch(c, block)
    native_ms = (time.perf_counter() - t0) * 1e3
    c_dev = torch.from_numpy(c.astype(np.int32)).to(dev)
    bmat, lbs = adev.gotoh_block_inputs(block, device=dev)
    lbs_h = lbs.cpu().numpy().astype(np.int64)
    la, lb, mb = len(c), bmat.shape[1], len(block)
    cells = la * int((lbs_h + 1).sum())
    # both Gotoh kernels on the block: the warp kernel (the one the block's
    # width takes), then the CTA kernel forced by the dispatch limit, then
    # both timed again in the other order
    limits = {"gotoh_dp_warp_kernel": adev._GOTOH_WARP_MAX_COLS,
              "gotoh_dp_kernel": 0}
    if adev.gotoh_kernel_plan(lb)[0] != "gotoh_dp_warp":
        fail("phase 10's block (lb %d) is too wide for the warp kernel" % lb)
    ptxas = {e["kernel"]: e for e in report["ptxas"].get("gotoh_dp", [])}

    def forced(kernel, fn):
        saved = adev._GOTOH_WARP_MAX_COLS
        adev._GOTOH_WARP_MAX_COLS = limits[kernel]
        try:
            return fn()
        finally:
            adev._GOTOH_WARP_MAX_COLS = saved

    def one_kernel(kernel):
        _, call_ms, peak = timed(lambda: adev.align_ops_batch_device(
            c, block, as_codes=True, device=dev))
        if not same_op_codes(adev.align_ops_batch_device(
                c, block, as_codes=True, device=dev), nat_block):
            fail("align_ops_batch_device (%s) differs from "
                 "native.gotoh_ops_batch on the 512-member block" % kernel)
        m = measure_dp(
            "gotoh_block (%s)" % kernel, adev.gotoh_block,
            lambda c_, b_, l_: adev.gotoh_block_reference(c, b_, l_, dev),
            (c_dev, bmat, lbs), mb, 4 * la + 4 * mb * lb + 4 * mb
            + mb * (la + int(lbs_h.max())), GOTOH_OPS_PER_CELL * cells,
            INT32_OPS_PER_S)
        n, acts, busy, prof = profiled_launches(
            lambda: adev.align_ops_batch_device(c, block, as_codes=True,
                                                device=dev), kernel)
        other = sum(v[1] for k, v in prof.items()
                    if "gotoh_dp" in k and kernel not in k)
        if n != 1 or other:
            fail("one Gotoh block made %d %s launches and %d of the other "
                 "Gotoh kernel" % (n, kernel, other))
        name_k = kernel
        if kernel == "gotoh_dp_warp_kernel":
            name_k += "<%d>" % adev.gotoh_kernel_plan(lb)[1]
        pt = ptxas.get(name_k, {})
        m.update(kernel=name_k, launches_per_block=n,
                 activities_per_block=acts, busy_ms_per_block=busy,
                 profile_per_block=prof, call_ms=call_ms, peak_mib=peak,
                 registers=pt.get("registers"),
                 spill_bytes=pt.get("spill_stores", 0)
                 + pt.get("spill_loads", 0) if pt else None)
        return m
    gotoh = {k: forced(k, lambda: one_kernel(k)) for k in limits}
    for k in reversed(list(limits)):
        gotoh[k]["ms_again"] = forced(k, lambda: cuda_ms(
            lambda: adev.gotoh_block(c_dev, bmat, lbs), 10))
    gk = dict(gotoh["gotoh_dp_warp_kernel"], native_ms=native_ms,
              cluster_launches=cluster_launches,
              cluster_warp_launches=cluster_warp, la=la, M=mb,
              lb_max=int(lbs_h.max()), cells=cells,
              cta=gotoh["gotoh_dp_kernel"])
    out["gotoh_dp"] = gk
    say("phase 10 align_ops_batch_device: %d members == native in %d "
        "gotoh_dp launches (%d of gotoh_dp_warp_kernel); one block la=%d "
        "M=%d lb_max=%d, native %.1f ms (%d host threads):"
        % (len(members), cluster_launches, cluster_warp, la, mb,
           gk["lb_max"], native_ms, os.cpu_count() or 1))
    for k, m in gotoh.items():
        say("  %s: gotoh_block == its plain version and native (max_abs_err "
            "%d); kernel %.4f ms, again %.4f ms (trace %.1f%% of its cycles, "
            "%.4f ms), plain %.1f ms, bound %.4f ms (%s, %.1f%%); ptxas %s "
            "registers, %s B spilled; the call %.1f ms, peak %.1f MiB; "
            "torch.profiler, full depth: %s launch(es) of %s CUDA "
            "activities, %s device ms: %s"
            % (m["kernel"], m["max_abs_err"], m["ms"], m["ms_again"],
               100 * m["trace_share"], m["trace_ms"], m["plain_ms"],
               m["bound_ms"], m["bound_by"], 100 * m["bound_ms"] / m["ms"],
               m["registers"], m["spill_bytes"], m["call_ms"], m["peak_mib"],
               m["launches_per_block"], m["activities_per_block"],
               m["busy_ms_per_block"], json.dumps(m["profile_per_block"])))

    # the refine DP: one pass over the cluster's center-star rows (every
    # block on the warp kernel), then one block of 256 rows under each
    # refine kernel
    rows = centerstar._merge_rows_vec(
        seqs, center, [m for m in range(len(seqs)) if m != center], got)
    before = _cuda.launches()
    got_rows = refine.refine_pass(rows, backend="device", device=dev)
    refine_launches = launched(before, "refine_dp", "refine_dp_warp")
    refine_warp = launched(before, "refine_dp_warp")
    _, ref_ms, ref_peak = timed(lambda: refine.refine_pass(
        rows, backend="device", device=dev))
    t0 = time.perf_counter()
    nat_rows = refine.refine_pass(rows, backend="native")
    ref_native_ms = (time.perf_counter() - t0) * 1e3
    if got_rows != nat_rows:
        fail("refine_pass_device differs from native.refine_realign on %s"
             % name)
    n_blocks = -(-len(rows) // 256)
    if refine_launches != n_blocks or refine_warp != n_blocks:
        fail("refine_pass_device made %d refine_dp launches (%d of the warp "
             "kernel) for %d blocks" % (refine_launches, refine_warp,
                                        n_blocks))
    res_chars, res_codes, lens, f6, occ, n_cols = refine.device_pass_inputs(
        rows)
    blk = adev.refine_block_inputs(res_codes, lens, f6, occ, slice(0, 256),
                                   device=dev)
    mr, lmax = blk[0].shape
    rcells = n_cols * int((lens[:256].astype(np.int64) + 1).sum())
    # both refine kernels on the block: the warp kernel (the one the
    # block's width takes), then the CTA kernel forced by the dispatch
    # limit, then both timed again in the other order
    ref_limits = {"refine_dp_warp_kernel": adev._REFINE_WARP_MAX_POS,
                  "refine_dp_kernel": 0}
    if adev.refine_kernel_plan(lmax)[0] != "refine_dp_warp":
        fail("phase 10's refine block (lmax %d) is too wide for the warp "
             "kernel" % lmax)
    rptxas = {e["kernel"]: e for e in report["ptxas"].get("refine_dp", [])}
    spilled = {k: e["spill_stores"] + e["spill_loads"]
               for k, e in rptxas.items()
               if k.startswith("refine_dp_warp_kernel<")}
    if len(spilled) != len(adev._WARP_KS) or any(spilled.values()):
        fail("ptxas spilled in refine_dp_warp_kernel (bytes by K): %s"
             % spilled)

    def ref_forced(kernel, fn):
        saved = adev._REFINE_WARP_MAX_POS
        adev._REFINE_WARP_MAX_POS = ref_limits[kernel]
        try:
            return fn()
        finally:
            adev._REFINE_WARP_MAX_POS = saved

    def one_refine(kernel):
        # the whole cluster's pass on this kernel against native
        if refine.refine_pass(rows, backend="device", device=dev) \
                != nat_rows:
            fail("refine_pass_device (%s) differs from native.refine_realign "
                 "on %s" % (kernel, name))
        m = measure_dp(
            "refine_block (%s)" % kernel, adev.refine_block,
            lambda *a: adev.refine_block_reference(*a, dev), blk, mr,
            8 * mr * lmax + 8 * mr + 4 * n_cols * mr * 6
            + 3 * 4 * n_cols * mr + 8 * mr * n_cols,
            REFINE_OPS_PER_CELL * rcells
            + REFINE_OPS_PER_COLUMN * n_cols * mr, FP32_OPS_PER_S)
        _, call_ms, peak = timed(lambda: adev.refine_block(*blk))
        n, acts, busy, prof = profiled_launches(
            lambda: refine.refine_pass(rows[:256], backend="device",
                                       device=dev), kernel)
        other = sum(v[1] for k, v in prof.items()
                    if "refine_dp" in k and kernel not in k)
        if n != 1 or other:
            fail("one refine block made %d %s launches and %d of the other "
                 "refine kernel" % (n, kernel, other))
        name_k = kernel
        if kernel == "refine_dp_warp_kernel":
            name_k += "<%d>" % adev.refine_kernel_plan(lmax)[1]
        pt = rptxas.get(name_k, {})
        m.update(kernel=name_k, launches_per_block=n,
                 activities_per_block=acts, busy_ms_per_block=busy,
                 profile_per_block=prof, call_ms=call_ms, peak_mib=peak,
                 registers=pt.get("registers"),
                 spill_bytes=pt.get("spill_stores", 0)
                 + pt.get("spill_loads", 0) if pt else None)
        return m
    refine_k = {k: ref_forced(k, lambda: one_refine(k)) for k in ref_limits}
    for k in reversed(list(ref_limits)):
        refine_k[k]["ms_again"] = ref_forced(k, lambda: cuda_ms(
            lambda: adev.refine_block(*blk), 10))
    rk = dict(refine_k["refine_dp_warp_kernel"],
              native_ms=ref_native_ms / n_blocks,
              pass_ms_per_block=ref_ms / n_blocks, pass_peak_mib=ref_peak,
              pass_launches=refine_launches, pass_warp_launches=refine_warp,
              M=len(rows), C=n_cols, blocks=n_blocks, lmax=lmax,
              cells=rcells, warp_spill_bytes=spilled,
              moved_rows=sum(a != b for a, b in zip(got_rows, rows)),
              cta=refine_k["refine_dp_kernel"])
    out["refine_dp"] = rk
    say("phase 10 refine_pass_device: M=%d C=%d, %d blocks of 256 == native "
        "(%d rows moved) in %d refine_dp launches (%d of "
        "refine_dp_warp_kernel), and again == native on the CTA kernel "
        "forced; the pass %.1f ms a block, peak %.1f MiB, native %.1f ms a "
        "block; one block of %d rows (lmax %d), ptxas spill bytes of "
        "refine_dp_warp_kernel by K %s:"
        % (len(rows), n_cols, n_blocks, rk["moved_rows"], refine_launches,
           refine_warp, rk["pass_ms_per_block"], ref_peak, rk["native_ms"],
           mr, lmax, json.dumps(spilled)))
    for k, m in refine_k.items():
        say("  %s: refine_block == its plain version (max_abs_err %d); "
            "kernel %.4f ms, again %.4f ms (trace %.1f%% of its cycles, "
            "%.4f ms), plain %.1f ms, bound %.4f ms (%s, %.1f%%); ptxas %s "
            "registers, %s B spilled; the call %.1f ms, peak %.1f MiB; "
            "torch.profiler, full depth: %s launch(es) of %s CUDA "
            "activities, %s device ms: %s"
            % (m["kernel"], m["max_abs_err"], m["ms"], m["ms_again"],
               100 * m["trace_share"], m["trace_ms"], m["plain_ms"],
               m["bound_ms"], m["bound_by"], 100 * m["bound_ms"] / m["ms"],
               m["registers"], m["spill_bytes"], m["call_ms"], m["peak_mib"],
               m["launches_per_block"], m["activities_per_block"],
               m["busy_ms_per_block"], json.dumps(m["profile_per_block"])))
    blocks = dp_grid_equal(dev)
    say("phase 10 tie grid: gotoh_block and refine_block (both kernels of "
        "each) == their plain versions on the card on %d blocks "
        "(homopolymers, "
        "tandem repeats, "
        "members equal to the center, codes 4 and up, empty members, a "
        "one-base center, one member, 33 members in blocks of 32)" % blocks)
    say("phase 10 blocks a run: %d Stage-A blocks, %d Gotoh blocks, 0 refine "
        "blocks (refine_msa takes native)" % (design_blocks, gotoh_blocks))
    report["device_ops"] = out
    report["gotoh_dp"] = gk
    report["refine_dp"] = rk


def json_plain(o):
    """JSON for the NumPy values in the report."""
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError("%r is not JSON serializable" % (o,))


# phase 10 in a process of its own (argv: its input JSON, the results path,
# the JSON file for the report keys it writes)
DEVICE_OPS_CHILD = r"""
import argparse, json, sys
import chip_smoke
with open(sys.argv[1]) as f:
    given = json.load(f)
report = {"ptxas": given["ptxas"]}
chip_smoke.phase_device_ops(argparse.Namespace(**given["args"]), report,
                            sys.argv[2])
with open(sys.argv[3], "w") as f:
    json.dump({k: report[k] for k in ("device_ops", "gotoh_dp", "refine_dp")},
              f, default=chip_smoke.json_plain)
"""


def phase_device_ops_apart(args, report, work, res):
    """phase_device_ops in a fresh process that starts no other: in this
    one, after the CUDA processes of phases 4, 5 and 9 have come and gone,
    a torch.profiler session may see no device events, and phase 10 holds
    launches to the profiler's count (on an H100 with torch 2.11, a loop
    of sessions in one process lost about half of them once other CUDA
    processes started and ended between them, and none of 236 without)."""
    given = os.path.join(work, "device_ops_in.json")
    got = os.path.join(work, "device_ops_out.json")
    with open(given, "w") as f:
        json.dump({"args": vars(args), "ptxas": report["ptxas"]}, f,
                  default=json_plain)
    rc = subprocess.run([sys.executable, "-c", DEVICE_OPS_CHILD, given, res,
                         got], cwd=HERE).returncode
    if rc != 0:
        fail("phase 10's process exited %d" % rc)
    with open(got) as f:
        report.update(json.load(f))


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
# written before the card's runs (PERF.md): the find_hits kernels' ms on
# one [16, 65,536] x 744 batch, and specificity's peak MiB without the
# codes tensor
FIND_HITS_PREDICTED_MS = (0.2, 0.6)
PEAK_PREDICTED_MIB = (200, 400)

# runs one subcommand of the port's CLI in this interpreter, then writes a
# side file: exit code, wall, each scan_hits_long call's seconds and hits,
# find_hits launches and the scans' device batches, peak device memory and
# the scan backend
CLI_DRIVER = r"""
import json, sys, time
import torch
import chip_smoke
from multiprime_tpu_torch.cli import main as cli
from multiprime_tpu_torch.ops import _cuda
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
with chip_smoke.counted_batches() as batches:
    rc = cli.main(sys.argv[2:])
side = {"rc": rc, "wall_s": time.time() - t0, "scans": calls,
        "launches": _cuda.launches()["find_hits"], "batches": batches[0],
        "backend": vscan.LAST_BACKEND,
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
    # the card side held to the device: the crossover may give these
    # scans to the host
    env["MPTPU_FORCE_BACKEND"] = "host" if host else "device"
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


# one find_hits call's device time by CUDA kernel, in a process of its own
# (argv: the batch's .npz, find_hits's keywords as JSON)
BREAKDOWN_CHILD = r"""
import json, sys
import numpy as np
import torch
import chip_smoke
from multiprime_tpu_torch.ops import mismatch_scan as ms
d = np.load(sys.argv[1])
dev = torch.device(chip_smoke.DEVICE)
tm, tl = (torch.from_numpy(d[k]).to(dev) for k in ("masks", "lens"))
planes, sfx = ms.pack_patterns(d["p1h"], d["s1h"], device=dev)
kw = json.loads(sys.argv[2])
print(json.dumps(chip_smoke.kernel_breakdown(
    lambda: ms.find_hits(tm, tl, planes, sfx, **kw))))
"""


def find_hits_breakdown(work, masks, lens, p1h, s1h, **kw):
    """kernel_breakdown of one find_hits call on this batch, in a fresh
    process: here, after phase 10's torch.profiler sessions, a session
    gives no device events for these launches; the first session of a
    process does."""
    path = os.path.join(work, "find_hits_batch.npz")
    np.savez(path, masks=masks, lens=lens, p1h=p1h, s1h=s1h)
    got = subprocess.run([sys.executable, "-c", BREAKDOWN_CHILD, path,
                          json.dumps(kw)], cwd=HERE, env=device_env(),
                         capture_output=True, text=True)
    if got.returncode != 0:
        fail("the find_hits breakdown exited %d: %s"
             % (got.returncode, got.stderr[-2000:]))
    return json.loads(got.stdout.strip().splitlines()[-1])


def phase_specificity(args, report, work, primers):
    """`specificity` through the CLI against the seeded background, on the
    card and on the host backend, with and without --exhaustive-join: the
    four output files byte-identical between the backends, the planted
    amplicons found, find_hits once a device batch; then the hit-code and
    find_hits kernels held to their plain versions and timed at the
    background's batch shape."""
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
            if side["backend"] != want or (backend == "device" and (
                    side["launches"] <= 0
                    or side["launches"] != side["batches"])):
                fail("specificity %s ran the %s scan with %d find_hits "
                     "launches for %d device batches" % (
                         name, side["backend"], side["launches"],
                         side["batches"]))
            with open(os.path.join(d, "s.out")) as f:
                side["rows"] = sum(1 for _ in f) - 1
            out["runs"][name] = side
            say("phase 11 specificity %s on the %s backend: %.2f s wall "
                "(process %.2f s), scans %s s, hits %s, find_hits launches "
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
    fh = measure_find_hits(
        ms, masks, lens, p1h, s1h, 1, 4, 1 << 17, "phase 11 at the "
        "background's last batch (%d segments, %d padding rows)"
        % (len(segs), bs - len(segs)))
    fh["predicted_ms"] = FIND_HITS_PREDICTED_MS
    fh["by_kernel"] = find_hits_breakdown(work, masks, lens, p1h, s1h, plen=18,
                                          mm=1, term=4, max_hits=1 << 17)
    if not fh["by_kernel"]:
        fail("torch.profiler gave no device events for one find_hits call")
    say("phase 11 find_hits by CUDA kernel (device ms, launches): %s"
        % json.dumps(fh["by_kernel"]))
    report["find_hits"] = fh
    say("phase 11 find_hits kernels %.4f ms a batch (predicted %.1f-%.1f; "
        "hit_codes + compaction %.4f), %d batches of %d segments a scan"
        % (fh["ms"], *FIND_HITS_PREDICTED_MS, fh["codes_path_ms"],
           out["batches_per_scan"], bs))
    peaks = [out["runs"][n]["peak_bytes"] / 2 ** 20 for n in out["runs"]
             if n.endswith("_device")]
    out["peak_mib_predicted"] = PEAK_PREDICTED_MIB
    say("phase 11 specificity peak device memory %s MiB (predicted "
        "%d-%d)" % ([round(p, 1) for p in peaks], *PEAK_PREDICTED_MIB))
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
                not host and (side["launches"] <= 0
                              or side["launches"] != side["batches"])):
            fail("update on the %s backend ran the %s scan (%d find_hits "
                 "launches for %d device batches)" % (
                     backend, side["backend"], side["launches"],
                     side["batches"]))
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
            "s, find_hits launches %d, peak device memory %.1f MiB; "
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
                or (backend == "device" and (
                    side["launches"] <= 0
                    or side["launches"] != side["batches"])):
            fail("onestep on the %s backend ran the %s scan (%d find_hits "
                 "launches for %d device batches)" % (
                     backend, side["backend"], side["launches"],
                     side["batches"]))
        walls[backend], sides[backend] = side["wall_s"], side
        if backend == "device":
            os.rename(d, d + "_device")
    diff = tree_diff(d + "_device", d)
    if diff is not None:
        fail("onestep output %s differs between the card and the host "
             "backend" % diff)
    n_files = sum(len(n) for _, _, n in os.walk(d))
    say("phase 13 onestep on %s: %d files, device == host byte for byte; "
        "%.2f s on the card (%d find_hits launches), %.2f s on the host "
        "backend" % (name, n_files, walls["device"],
                     sides["device"]["launches"], walls["host"]))
    report["onestep"] = {"cluster": name, "files": n_files, "runs": sides}


class forced_device:
    """MPTPU_FORCE_BACKEND=device in this process for the block."""

    def __enter__(self):
        self.prev = os.environ.get("MPTPU_FORCE_BACKEND")
        os.environ["MPTPU_FORCE_BACKEND"] = "device"

    def __exit__(self, *exc):
        os.environ.pop("MPTPU_FORCE_BACKEND", None)
        if self.prev is not None:
            os.environ["MPTPU_FORCE_BACKEND"] = self.prev


# the mesh and profile phases' corpus: families, members, singletons of
# phase 4's generator (real 900 bp members at full family size, fewer
# families)
CUT_CORPUS = (2, 1000, 20)


def cut_corpus(args, work):
    fa = os.path.join(work, "cut.fa")
    if not os.path.exists(fa):
        generate_corpus(fa, args.seed, *CUT_CORPUS)
    return fa


def phase_mesh(args, report, work, res, keys):
    """A 2 x 2 Mesh of cuda:0: Stage A, the coverage counts and the sparse
    scan sharded over it, each equal to its unsharded run; then `run` in
    process under the mesh with device Stage A on the cut corpus, its tree
    equal byte for byte to the same run without a mesh (kept for phase
    15)."""
    import torch
    from multiprime_tpu_torch.models import mcdpd
    from multiprime_tpu_torch.ops import design_scan
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.parallel import mesh as pmesh
    from multiprime_tpu_torch.pipeline.driver import run_pipeline
    from multiprime_tpu_torch.utils import iupac
    from multiprime_tpu_torch.validate import scan as vscan
    dev = torch.device(DEVICE)
    mesh = pmesh.Mesh([[DEVICE + ":0"] * 2] * 2)
    out = {"mesh": mesh.spec(), "shards": int(mesh.devices.size)}
    # Stage A on phase 10's cluster
    name = report["device_ops"]["cluster"]
    _, chars = mcdpd.parse_msa(os.path.join(res, "Clusters_msa",
                                            name + ".tmsa"))
    start, stop = mcdpd.DesignEngine(mcdpd.DesignParams(
        coverage=0.7, min_product=150, coordinate="2,3,-1")).usable_span(
            chars)
    positions = np.arange(start, stop - 18)
    masks = iupac.bytes_to_masks(chars)
    t0 = time.perf_counter()
    single = list(design_scan.design_stats_blocks(masks, positions,
                                                  device=dev))
    single_s = time.perf_counter() - t0
    before = _cuda.launches()
    t0 = time.perf_counter()
    sharded = list(pmesh.design_stats_blocks_sharded(mesh, masks, positions))
    sharded_s = time.perf_counter() - t0
    counts = stage_a_counts(before)
    if len(single) != len(sharded):
        fail("design_stats_blocks_sharded gave %d blocks, unsharded %d"
             % (len(sharded), len(single)))
    shards, cols = int(mesh.devices.size), mesh.shape["win"]
    want = {"rows": shards, "windows": shards * len(sharded),
            "viterbi": cols * len(sharded)}
    if counts != want:
        fail("the mesh's Stage A launched the Stage-A kernels %s times, not "
             "%s" % (counts, want))
    for (pa, a), (pb, b) in zip(single, sharded):
        if not np.array_equal(pa, pb) or sorted(a) != sorted(b) or any(
                a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])
                for k in a):
            fail("design_stats_blocks_sharded differs from "
                 "design_stats_blocks on %s" % name)
    out["stage_a"] = {"cluster": name, "N": int(masks.shape[0]),
                      "W": len(positions), "blocks": len(single),
                      "single_s": single_s, "sharded_s": sharded_s,
                      "kernel_launches": counts}
    say("phase 14 mesh %s (%d shards): design_stats_blocks_sharded == "
        "design_stats_blocks on %s (N=%d, W=%d, %d blocks; %.3f s sharded, "
        "%.3f s unsharded); Stage-A kernel launches %s"
        % (mesh.spec(), mesh.devices.size, name, masks.shape[0],
           len(positions), len(single), sharded_s, single_s,
           json.dumps(counts)))
    # coverage counts: 512 targets x phase 5's keys
    _, seqs = vscan.parse_fasta(os.path.join(res, "Total_fa",
                                             "scale21k.format.fa"))
    p1h, s1h = pattern_onehots(ms, keys, 1)
    t1h, lens = ms.encode_targets(seqs[:512])
    before = _cuda.launches()
    hits, covered = pmesh.coverage_counts_sharded(mesh, t1h, lens, p1h, s1h,
                                                  mm=1, term=1)
    torch.cuda.synchronize()
    cov_launches = launched(before, "match_counts")
    counts = ms.match_counts(t1h, p1h, device=dev)
    ok = (18 - counts) <= 1
    del counts
    ok &= ms.match_counts(t1h, s1h, device=dev) >= 1
    o_idx = torch.arange(ok.shape[1], device=dev)
    ok &= ((o_idx[None, :] + 18) <= torch.from_numpy(lens).to(dev)[
        :, None])[:, :, None]
    want_hits = ok.sum(dim=(0, 1), dtype=torch.int64)
    want_cov = ok.any(dim=2).any(dim=1).sum(dtype=torch.int64)
    del ok
    if not (torch.equal(hits, want_hits) and int(covered) == int(want_cov)):
        fail("coverage_counts_sharded differs from the unsharded sum of "
             "match_counts")
    out["coverage"] = {"targets": 512, "patterns": int(p1h.shape[0]),
                       "hits": int(hits.sum()), "covered": int(covered),
                       "match_counts_launches": cov_launches}
    say("phase 14 coverage_counts_sharded == unsharded match_counts sum: "
        "512 targets x %d patterns, %d hits, %d targets covered; "
        "match_counts launches %d" % (p1h.shape[0], int(hits.sum()),
                                      int(covered), cov_launches))
    # the sparse scan: phase 5's keys against the 21k targets, -m 1
    params = dict(term_len=18, term=1, mm=1, backend="device")
    t0 = time.time()
    want = vscan.scan_hits(seqs, keys, vscan.ScanParams(**params), dev)
    single_s = time.time() - t0
    before = _cuda.launches()
    t0 = time.time()
    with pmesh.use_mesh(mesh), counted_batches() as batches:
        got = vscan.scan_hits(seqs, keys, vscan.ScanParams(**params), dev)
    torch.cuda.synchronize()
    sharded_s = time.time() - t0
    scan_launches = launched(before, "find_hits")
    if vscan.LAST_BACKEND != "device-sharded" or scan_launches <= 0 \
            or scan_launches != batches[0]:
        fail("the scan under the mesh ran %s with %d find_hits launches for "
             "%d batch shards" % (vscan.LAST_BACKEND, scan_launches,
                                  batches[0]))
    if got != want:
        fail("scan_hits under the mesh differs from the unsharded device "
             "scan (%d vs %d hits)" % (len(got), len(want)))
    out["scan"] = {"targets": len(seqs), "patterns": len(keys),
                   "hits": len(got), "sharded_s": sharded_s,
                   "single_s": single_s, "find_hits_launches": scan_launches}
    say("phase 14 scan_hits under the mesh == unsharded device scan: %d "
        "targets x %d keys, %d hits; %.2f s sharded, %.2f s unsharded; "
        "find_hits launches %d, one a batch shard (%s)"
        % (len(seqs), len(keys), len(got), sharded_s, single_s,
           scan_launches, vscan.LAST_BACKEND))
    # `run` in process on the cut corpus, with and without the mesh
    fa = cut_corpus(args, work)
    cut_res = os.path.join(work, "cut_res")
    kw = dict(input_fa=fa, results_dir=cut_res, device=DEVICE,
              stage_a="device", pcr_products="summary",
              nproc=os.cpu_count() or 1)
    with forced_device():
        # the clustering and the scan run in this process: their launches
        # in each run are what its backends print
        before = _cuda.launches()
        t0 = time.time()
        single, _ = run_pipeline(None, **kw)
        single_s = time.time() - t0
        identity_launches = launched(before, *IDENTITY)
        # a run's backends count from its start: read before the next run
        printed = sum(single._backends()["launches"][k] for k in IDENTITY)
        os.rename(cut_res, cut_res + "_single")
        before = _cuda.launches()
        t0 = time.time()
        with pmesh.use_mesh(mesh), counted_batches() as batches:
            pipe, _ = run_pipeline(None, **kw)
        mesh_s = time.time() - t0
        run_launches = launched(before, "find_hits")
    backends = pipe._backends()
    served = backends["stage_a_served"]
    stage_a_run = backends["launches"]["stage_a_windows"]
    if set(served) != {"device-sharded"} or run_launches <= 0 \
            or run_launches != batches[0] \
            or backends["launches"]["find_hits"] != run_launches \
            or stage_a_run <= 0 \
            or backends.get("scan_backend") != "device-sharded":
        fail("the run under the mesh: Stage A served %s, scan %s, %d "
             "find_hits launches for %d batch shards (its backends print "
             "%d), %d Stage-A kernel launches"
             % (served, backends.get("scan_backend"), run_launches,
                batches[0], backends["launches"]["find_hits"], stage_a_run))
    if identity_launches <= 0 or printed != identity_launches:
        fail("the run without the mesh made %d banded_identity launches; "
             "its backends print %s" % (identity_launches, printed))
    say("phase 14 run without the mesh: its clustering made %d "
        "banded_identity launches, as its backends print"
        % identity_launches)
    diff = tree_diff(cut_res + "_single", cut_res)
    if diff is not None:
        fail("the run under the mesh wrote %s unlike the run without" % diff)
    n_files = sum(len(n) for _, _, n in os.walk(cut_res))
    shutil.rmtree(cut_res)
    out["run"] = {"files": n_files, "mesh_s": mesh_s, "single_s": single_s,
                  "stage_a_served": served,
                  "find_hits_launches": run_launches,
                  "stage_a_kernel_launches": stage_a_run,
                  "identity_launches": identity_launches}
    say("phase 14 run under the mesh (--stage-a device, nproc=%d, the "
        "workers handed the mesh): tree == the run without it (%d files); "
        "%.1f s with the mesh, %.1f s without; Stage A served %s, scan %s, "
        "find_hits launches %d, Stage-A windows kernel launches %d (one a "
        "shard and block)" % (kw["nproc"], n_files, mesh_s, single_s,
                              json.dumps(served), backends["scan_backend"],
                              run_launches, stage_a_run))
    report["mesh"] = out


def busy_share(trace_path):
    """From a torch.profiler trace: (the run's span in s: its
    "run_pipeline" range, else the span of all events; the union of CUDA
    kernel intervals in s, the same with memory copies and sets,
    kernels)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if "ts" in e and "dur" in e]

    def union(spans):
        total, end = 0.0, None
        for a, b in sorted(spans):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "kernel"]
    dev = kern + [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    runs = [e["dur"] for e in events if e.get("name") == "run_pipeline"]
    span = runs[0] if runs else (max(e["ts"] + e["dur"] for e in events)
                                 - min(e["ts"] for e in events))
    return span / 1e6, union(kern) / 1e6, union(dev) / 1e6, len(kern)


def phase_profile(args, report, work):
    """`run --profile` through the CLI on the cut corpus into phase 14's
    path: the tree equal to phase 14's run without a mesh (but
    pipeline_metrics.json), a trace written, and the share of the run
    during which a CUDA kernel ran."""
    fa = cut_corpus(args, work)
    cut_res = os.path.join(work, "cut_res")
    trace = os.path.join(work, "trace")
    cmd = [sys.executable, "-m", "multiprime_tpu_torch.cli.main", "run",
           "-i", fa, "-r", cut_res, "--device", DEVICE, "--stage-a",
           "device", "--pcr-products", "summary", "--profile", trace]
    log_path = os.path.join(work, "run_profile.log")
    t0 = time.time()
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=HERE, env=device_env(), stdout=log,
                            stderr=subprocess.STDOUT).returncode
    wall = time.time() - t0
    if rc != 0:
        with open(log_path) as log:
            fail("run --profile exited %d:\n%s" % (rc, log.read()[-4000:]))
    diff = tree_diff(cut_res + "_single", cut_res)
    if diff is not None:
        fail("run --profile wrote %s unlike the run without it" % diff)
    traces = glob.glob(os.path.join(trace, "*.pt.trace.json"))
    if not traces:
        fail("run --profile wrote no trace under %s" % trace)
    span, kern_s, dev_s, n_kern = busy_share(traces[0])
    with open(os.path.join(cut_res, "pipeline_metrics.json")) as f:
        timings = json.load(f)["timings_s"]
    out = {"process_s": wall, "trace_bytes": os.path.getsize(traces[0]),
           "trace_span_s": span, "kernel_busy_s": kern_s,
           "device_busy_s": dev_s, "kernels": n_kern,
           "kernel_share": kern_s / span if span else 0.0,
           "device_share": dev_s / span if span else 0.0,
           "timings_s": timings}
    say("phase 15 run --profile (nproc 1): tree == the unprofiled run's; "
        "trace %s (%.1f MB); process %.1f s, trace span %.2f s; %d CUDA "
        "kernels busy %.3f s = %.2f%% of the run (with copies and sets "
        "%.3f s = %.2f%%); stages %s" % (
            os.path.basename(traces[0]), out["trace_bytes"] / 1e6, wall,
            span, n_kern, kern_s, 100 * out["kernel_share"], dev_s,
            100 * out["device_share"], json.dumps(timings)))
    report["profile"] = out


class Sized:
    """A target of n bases, for the estimators (they read len only)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def phase_crossover(args, report, work, res, keys):
    """The constants of utils/link.py measured on this card: the link,
    a CUDA context's start, the host scans and encode, the device scan of
    a resident corpus, and the design call with host and device Stage A;
    then, for the scans and the design stage of the earlier phases, the
    side the committed constants pick beside the measured time of both."""
    import torch
    from multiprime_tpu_torch import native
    from multiprime_tpu_torch.models import mcdpd
    from multiprime_tpu_torch.ops import mismatch_scan as ms
    from multiprime_tpu_torch.utils import link as linkmod
    from multiprime_tpu_torch.validate import scan as vscan
    dev = torch.device(DEVICE)
    fit, link = {}, {}
    # the link: 64 MiB each way, pageable host memory; a synced tiny copy
    host = np.ones(64 << 20, np.uint8)
    torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    link["up_mbps"] = host.nbytes / (time.perf_counter() - t0) / 1e6
    t0 = time.perf_counter()
    d.cpu()
    link["down_mbps"] = host.nbytes / (time.perf_counter() - t0) / 1e6
    tiny = torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    for _ in range(200):
        tiny.add_(1).item()
    link["rtt_ms"] = link["dispatch_ms"] = (time.perf_counter() - t0) / 200 \
        * 1e3
    del d
    # a CUDA context and the scan's library in a fresh process
    code = ("import time, torch\nt0 = time.perf_counter()\n"
            "torch.zeros(1, device='cuda')\ntorch.cuda.synchronize()\n"
            "t1 = time.perf_counter()\n"
            "from multiprime_tpu_torch.ops import _cuda\n"
            "_cuda.load('find_hits')\n"
            "print(t1 - t0, time.perf_counter() - t1)\n")
    starts = []
    for _ in range(2):
        got = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                             env=device_env(), capture_output=True,
                             text=True)
        if got.returncode != 0:
            fail("the CUDA start probe exited %d: %s" % (got.returncode,
                                                         got.stderr[-2000:]))
        starts.append([float(v) for v in got.stdout.split()[-2:]])
    fit["cuda_init_s"] = sum(s[0] for s in starts) / len(starts)
    fit["kernel_load_s"] = sum(s[1] for s in starts) / len(starts)
    fit["kernel_build_s"] = report["build_s"]
    # host scans of the 21k targets: the seed scan (phase 5's 742 keys),
    # the mask walk (the run's core set) and the NumPy scan (a subset)
    _, seqs = vscan.parse_fasta(os.path.join(res, "Total_fa",
                                             "scale21k.format.fa"))
    bases = sum(map(len, seqs))
    core_fa = os.path.join(res, "Core_primers_set",
                           "core_final_maxprimers_set.fa")
    if not os.path.exists(core_fa):
        core_fa = os.path.join(res, "Primers_set", "final_maxprimers_set.fa")
    pats, _, core_keys, _ = vscan.expand_primer_fasta(core_fa, 18, None,
                                                      with_keys=True)
    core = core_keys if core_keys is not None else pats

    def host_scan(targets, patterns):
        t0 = time.perf_counter()
        vscan.scan_hits(targets, patterns, vscan.ScanParams(
            mm=1, term=1, backend="numpy"), dev)
        return time.perf_counter() - t0
    seed_s = host_scan(seqs, keys)
    spec = report["specificity"]
    bg_bases = sum(background_segments(spec["lengths"]))
    host_runs = [r for n, r in spec["runs"].items() if n.endswith("_host")]
    seed_parts = [(bases, seed_s)] + [(bg_bases, c["s"]) for r in host_runs
                                      for c in r["scans"]]
    fit["host_seed_bases_per_s"] = (sum(b for b, _ in seed_parts)
                                    / sum(s for _, s in seed_parts))
    mask_s = host_scan(seqs, core)
    fit["host_mask_basepatterns_per_s"] = bases * len(core) / mask_s
    available = native.available
    native.available = lambda: False
    try:
        sub = seqs[:1000]
        numpy_s = host_scan(sub, core)
    finally:
        native.available = available
    fit["numpy_basepatterns_per_s"] = sum(map(len, sub)) * len(core) / numpy_s
    # the corpus's preparation before its first device scan: phase 11's
    # first (F) scan less its second (R, on the uploaded corpus) and a
    # fresh process's CUDA start; encoding alone is printed beside it
    longest = max(map(len, seqs))
    pad_len = max(-longest % 512 + longest, 512)
    t0 = time.perf_counter()
    for lo in range(0, len(seqs), 2048):
        ms.encode_target_masks(seqs[lo:lo + 2048], length=pad_len)
    encode_alone = bases / (time.perf_counter() - t0)
    dev_runs = [r for n, r in spec["runs"].items() if n.endswith("_device")]
    prep_s = [r["scans"][0]["s"] - r["scans"][1]["s"] - fit["cuda_init_s"]
              - fit["kernel_load_s"] for r in dev_runs]
    fit["host_encode_bases_per_s"] = bg_bases * len(prep_s) / sum(prep_s)
    say("phase 16 corpus preparation %s s before the first scan of %d "
        "bases; encoding alone %.4g bases/s" % (
            [round(s, 3) for s in prep_s], bg_bases, encode_alone))
    # the device scan of a resident corpus (21k x 742 keys, and phase 11's
    # second scans, which reuse the uploaded background)
    params = vscan.ScanParams(mm=1, term=1, backend="device")
    with vscan.shared_corpus(params):
        t0 = time.perf_counter()
        vscan.scan_hits(seqs, keys, params, dev)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        vscan.scan_hits(seqs, keys, params, dev)
        warm_s = time.perf_counter() - t0
    sync_s = link["dispatch_ms"] / 1e3
    dev_parts = [(2.0 * bases * len(keys) * 72, warm_s - sync_s)]
    dev_parts += [(2.0 * bg_bases * r["scans"][1]["patterns"] * 72,
                   r["scans"][1]["s"] - sync_s) for r in dev_runs]
    fit["device_macs_per_s"] = (sum(m for m, _ in dev_parts)
                                / sum(s for _, s in dev_parts))
    say("phase 16 device scan of the 21k targets x %d keys: %.3f s with "
        "the corpus's encode and upload, %.3f s resident" % (
            len(keys), cold_s, warm_s))
    # the design call with host and device Stage A (CUDA warm): the three
    # largest family clusters, three mid ones and 30 singletons
    with open(os.path.join(res, "cluster.txt")) as f:
        sizes = sorted((int(n), name) for name, n in
                       (line.split("\t") for line in f.read().splitlines()[1:]))
    fams = [s for s in sizes if s[0] > 1]
    sample = fams[-3:] + fams[len(fams) // 2:len(fams) // 2 + 3] + [
        s for s in sizes if s[0] == 1][:30]
    rows = []
    for _, name in sample:
        ids, chars = mcdpd.parse_msa(os.path.join(res, "Clusters_msa",
                                                  name + ".tmsa"))
        walls = {}
        for side in ("host", "device"):
            eng = mcdpd.DesignEngine(mcdpd.DesignParams(stage_a=side,
                                                        device=dev))
            try:
                start, stop = eng.usable_span(chars)
            except ValueError:
                break
            t0 = time.perf_counter()
            eng.design(ids, chars)
            walls[side] = time.perf_counter() - t0
        if len(walls) == 2:
            w = max(stop - 18 - start, 0)
            rows.append((chars.shape[0], w, walls["host"], walls["device"]))
    cells = sum(n * w * 18 for n, w, _, _ in rows)
    blocks = sum(max(1, -(-w // 512)) for _, w, _, _ in rows)
    fit["host_stagea_cells_per_s"] = cells / sum(r[2] for r in rows)
    fit["device_stagea_block_s"] = report["device_ops"][
        "design_stats_blocks"]["ms_per_block"] / 1e3
    rest = (sum(r[3] for r in rows) - blocks * (
        sync_s + fit["device_stagea_block_s"])
        - cells / (link["down_mbps"] * 1e6))
    fit["device_stagea_cells_per_s"] = cells / max(rest, 1e-6)
    say("phase 16 fitted RATES " + json.dumps(fit))
    say("phase 16 fitted LINK " + json.dumps(link))
    say("phase 16 committed RATES " + json.dumps(linkmod.RATES))
    # the split of the device run's extra design time
    host_design = report["run"]["timings_s"].get("design", 0.0)
    dev_design = report["device_run"]["timings_s"].get("design", 0.0)
    nproc = report["device_run"]["nproc"]
    starts_s = nproc * fit["cuda_init_s"]
    say("phase 16 design stage summed over workers: host Stage A %.1f s, "
        "device %.1f s; of the %.1f s more, %d spawned workers' CUDA "
        "starts %.1f s, per-window work %.1f s (sample: %d clusters, "
        "device %.3f s against host %.3f s)" % (
            host_design, dev_design, dev_design - host_design, nproc,
            starts_s, dev_design - host_design - starts_s, len(rows),
            sum(r[3] for r in rows), sum(r[2] for r in rows)))
    # the side "auto" picks with the committed constants, beside both times
    fresh = linkmod.RATES["cuda_init_s"] + linkmod.RATES["kernel_load_s"]
    real_startup = linkmod.device_startup_s

    def pick(targets, patterns, startup, resident=False):
        p = vscan.ScanParams(mm=1, term=1)
        if resident:
            p.corpus_cache = {"resident": True}
        longest = max(map(len, targets))
        pad = max(-longest % 512 + longest, 512)
        linkmod.device_startup_s = lambda **kw: startup
        try:
            side = vscan._auto_backend(targets, patterns, 18, pad,
                                       -(-len(patterns) // 8) * 8, p)
        finally:
            linkmod.device_startup_s = real_startup
        return "host" if side == "numpy" else side
    picks = {}
    picks["phase 4 scan (core set)"] = (
        pick(seqs, core, fresh), report["run"]["timings_s"].get("scan"),
        report["run"]["host_rescan_s"])
    picks["phase 5 scan"] = (pick(seqs, keys, fresh),
                             report["scan"]["wall_s"]["device"],
                             report["scan"]["wall_s"]["numpy"])
    bg = [Sized(seg) for seg in background_segments(spec["lengths"])]
    exh = spec["runs"]
    picks["64 Mb F scan"] = (pick(bg, keys, fresh),
                             exh["spec_exhaustive_device"]["scans"][0]["s"],
                             exh["spec_exhaustive_host"]["scans"][0]["s"])
    picks["64 Mb R scan"] = (pick(bg, keys, 0.0, resident=True),
                             exh["spec_exhaustive_device"]["scans"][1]["s"],
                             exh["spec_exhaustive_host"]["scans"][1]["s"])
    n_dev = 0
    for n, name in sizes:
        _, chars = mcdpd.parse_msa(os.path.join(res, "Clusters_msa",
                                                name + ".tmsa"))
        try:
            start, stop = mcdpd.DesignEngine(
                mcdpd.DesignParams()).usable_span(chars)
        except ValueError:
            continue
        linkmod.device_startup_s = lambda **kw: 0.0
        try:
            n_dev += mcdpd.resolve_stage_a(
                chars.shape[0], max(stop - 18 - start, 0), 18) == "device"
        finally:
            linkmod.device_startup_s = real_startup
    picks["21k design Stage A"] = (
        "device on %d of %d clusters" % (n_dev, len(sizes)), dev_design,
        host_design)
    # each shape of the sample (its clusters' summed walls: clusters of one
    # shape differ by more than the two sides do) beside the committed
    # constants' pick, the card warm as in the sample
    shapes = {}
    for n, w, host_s, dev_s in rows:
        s = shapes.setdefault((n, w), [0, 0.0, 0.0, 0])
        s[0] += 1
        s[1] += host_s
        s[2] += dev_s
        s[3] += dev_s < host_s
    linkmod.device_startup_s = lambda **kw: 0.0
    try:
        against = []
        for (n, w), (k, host_s, dev_s, dev_wins) in sorted(shapes.items()):
            side = mcdpd.resolve_stage_a(n, w, 18)
            faster = "device" if dev_s < host_s else "host"
            say("phase 16 design sample N=%d W=%d: %d clusters, host %.4f s, "
                "device %.4f s (the device faster on %d of them); auto picks "
                "%s, the faster side in sum %s"
                % (n, w, k, host_s, dev_s, dev_wins, side, faster))
            if side != faster:
                against.append((n, w, k, host_s, dev_s, dev_wins))
    finally:
        linkmod.device_startup_s = real_startup
    say("phase 16 auto picks against the faster side in sum on %d of the "
        "sample's %d shapes" % (len(against), len(shapes)))
    for what, (side, dev_t, host_t) in picks.items():
        say("phase 16 auto picks %s for the %s: measured device %s s, host "
            "%s s" % (side, what, dev_t, host_t))
    report["crossover"] = {"fit": fit, "link": link,
                           "committed": dict(linkmod.RATES),
                           "picks": picks, "design_sample": rows,
                           "design_sample_against": against,
                           "design_split": {"host_s": host_design,
                                            "device_s": dev_design,
                                            "cuda_starts_s": starts_s}}


def identity_pairs(rng, n, lo, hi, short=None):
    """-> (codes, meta) of n (query, representative) pairs of lo..hi
    bases as the clusterer meets them: two in three related (2-40%
    substitutions, a few indels, Ns), the rest unrelated; the
    representative never shorter.  ``short`` (lo, hi): each query a piece
    of that length instead (a partial genome)."""
    codes, meta, at = [], [], 0
    for k in range(n):
        b = rng.integers(0, 4, size=int(rng.integers(lo, hi + 1)))
        if short is not None:
            la = int(rng.integers(short[0], short[1] + 1))
            start = int(rng.integers(0, len(b) - la + 1))
            a = (b[start:start + la].copy() if k % 3 != 2
                 else rng.integers(0, 4, size=la))
            hit = rng.random(la) < rng.uniform(0.02, 0.2)
            a[hit] = rng.integers(0, 5, size=int(hit.sum()))
        elif k % 3 == 2:
            a = rng.integers(0, 4, size=int(rng.integers(lo, len(b) + 1)))
        else:
            a = b.copy()
            hit = rng.random(len(a)) < rng.uniform(0.02, 0.4)
            a[hit] = rng.integers(0, 5, size=int(hit.sum()))
            a = np.delete(a, rng.integers(0, len(a), size=int(
                rng.integers(0, 30))))
            a = a[:len(b)]
        for s in (a, b):
            codes.append(s.astype(np.int8))
        meta.append((at, len(a), at + len(a), len(b)))
        at += len(a) + len(b)
    return np.concatenate(codes), np.array(meta, np.int64).T


def identity_native(codes, meta, band=64):
    """The native DP's identities of the pairs and its seconds."""
    from multiprime_tpu_torch import native
    t0 = time.perf_counter()
    got = [native.banded_identity(codes[q:q + lq], codes[r:r + lr], band)
           for q, lq, r, lr in meta.T.tolist()]
    return got, time.perf_counter() - t0


def identity_cells(meta, band=64):
    from multiprime_tpu_torch.cluster import identity
    return int(identity.band_cells(meta[1], meta[3], band).sum())


def phase_identity(args, report):
    """The banded-identity kernels against their plain version and native
    on 32 pairs of each shape, partial genomes beside complete ones and
    the 32-bit key's limit, their times, the constants, and one job of
    each shape on both sides."""
    import torch
    from multiprime_tpu_torch.cluster import identity
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(args.seed + 17)
    before = _cuda.launches()
    out = {}
    errs = []

    def check(label, cd, codes, meta):
        """The kernels' matches against the plain version's and their
        identities against native's -> (matches, native's identities)."""
        got = identity.banded_matches(cd, meta, 64).cpu().numpy()
        plain = identity.banded_matches_reference(cd, meta, 64).cpu().numpy()
        want, native_s = identity_native(codes, meta)
        ident = identity.identities(got, meta)
        errs.append(max(int(np.abs(got.astype(np.int64) - plain).max()),
                        max(abs(x - y) for x, y in zip(ident, want))))
        if errs[-1] != 0:
            fail("phase 17 %s: the kernels differ from the plain version or "
                 "native (max_abs_err %s)" % (label, errs[-1]))
        return got, want, native_s

    for name, lo, hi in IDENTITY_SHAPES:
        codes, meta = identity_pairs(rng, 32, lo, hi)
        cd = torch.from_numpy(codes).to(dev)
        t0 = time.perf_counter()
        identity.banded_matches_reference(cd, meta, 64)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        _, want, native_s = check(name, cd, codes, meta)
        plan = identity.identity_plan(meta[1], meta[3], 64)
        one = meta[:, :1]
        full = np.tile(meta, IDENTITY_WINDOW // 32 + 1)[:, :IDENTITY_WINDOW]
        m = {"pairs": 32, "plan": plan, "cells": identity_cells(meta),
             "rows": int(np.minimum(meta[1], meta[3]).max()),
             "related_at_threshold": int(sum(w >= 0.7 for w in want)),
             "one_ms": cuda_ms(lambda: identity.banded_matches(cd, one, 64),
                               10),
             "ms": cuda_ms(lambda: identity.banded_matches(cd, meta, 64), 10),
             "window_ms": cuda_ms(
                 lambda: identity.banded_matches(cd, full, 64), 3),
             "window_cells": identity_cells(full),
             "plain_ms": plain_ms, "native_ms": native_s * 1e3,
             "one_cells": identity_cells(one),
             "one_rows": int(min(one[1, 0], one[3, 0]))}
        m.update(bound(codes.nbytes + 32 * 4,
                       m["cells"] * IDENTITY_OPS_PER_CELL, INT32_OPS_PER_S))
        m["window_bound_ms"] = (m["window_cells"] * IDENTITY_OPS_PER_CELL
                                / INT32_OPS_PER_S * 1e3)
        out[name] = m
        say("phase 17 identity %s: 32 pairs (%d at 0.7) equal plain and "
            "native, K %s, %d-bit keys; kernel %.4f ms (bound %.4f, %.1f%%), "
            "one pair %.4f ms (%d rows: %.3f us a row), a window of %d "
            "pairs %.4f ms (bound %.4f, %.1f%%); plain %.1f ms, native %.1f "
            "ms (one thread)"
            % (name, m["related_at_threshold"], plan[0], plan[1], m["ms"],
               m["bound_ms"], 100 * m["bound_ms"] / m["ms"], m["one_ms"],
               m["one_rows"], 1e3 * m["one_ms"] / m["one_rows"],
               IDENTITY_WINDOW, m["window_ms"], m["window_bound_ms"],
               100 * m["window_bound_ms"] / m["window_ms"], plain_ms,
               m["native_ms"]))
    # partial genomes (6.8-7.3 kb) beside complete ones (8.2-8.4 kb): bands
    # of 1,030-1,730 cells, past the register kernel
    codes, meta = identity_pairs(rng, 32, 8200, 8400, short=(6800, 7300))
    cd = torch.from_numpy(codes).to(dev)
    _, want, native_s = check("partial", cd, codes, meta)
    out["partial"] = {
        "pairs": 32, "cells": identity_cells(meta),
        "widths": [int(w) for w in identity._width(meta[1], meta[3], 64)[
            [0, -1]]],
        "related_at_threshold": int(sum(w >= 0.7 for w in want)),
        "ms": cuda_ms(lambda: identity.banded_matches(cd, meta, 64), 5),
        "native_ms": native_s * 1e3}
    say("phase 17 identity partial genomes: 32 pairs (%d at 0.7) equal plain "
        "and native on the wide kernel; %.4f ms, native %.1f ms (one thread)"
        % (out["partial"]["related_at_threshold"], out["partial"]["ms"],
           out["partial"]["native_ms"]))
    # both sides of the 32-bit key's limit: la 16,383 and 16,384
    for la in (16383, 16384):
        a = rng.integers(0, 4, size=la).astype(np.int8)
        b = a.copy()
        hit = rng.random(la) < 0.1
        b[hit] = rng.integers(0, 5, size=int(hit.sum()))
        b = np.concatenate([b[:la // 2], b[la // 2 + 20:],
                            rng.integers(0, 4, size=50).astype(np.int8)])
        codes = np.concatenate([a, b])
        meta = np.array([[0], [la], [la], [len(b)]], np.int64)
        plan = identity.identity_plan(meta[1], meta[3], 64)
        check("la %d" % la, torch.from_numpy(codes).to(dev), codes, meta)
        out["limit_%d" % la] = {"plan": plan}
        say("phase 17 identity la %d lb %d: %d-bit keys, equal native"
            % (la, len(b), plan[1]))
    out["max_abs_err"] = max(errs)
    out["timing_launches"] = launched(before, *IDENTITY)
    report["identity"] = out
    fit_identity(report)
    identity_jobs(args, report)


def fit_identity(report):
    """The identity constants of utils/link.py from phase 17's times: the
    native rate of one thread and the kernel's over a full window at genome
    length, and a row's latency from one pair alone."""
    g = report["identity"]["genome"]
    fit = {"host_identity_cells_per_s": g["cells"] / (g["native_ms"] / 1e3),
           "device_identity_cells_per_s":
               g["window_cells"] / (g["window_ms"] / 1e3),
           "device_identity_row_s": g["one_ms"] / 1e3 / g["one_rows"]}
    say("phase 17 identity fit (paste into utils/link.py RATES): %s"
        % json.dumps(fit))
    report.setdefault("crossover", {})["identity_fit"] = fit


def cluster_job(rng, length, families, members, singletons, subs):
    """One clustering job: ``families`` of ``members`` copies of a random
    sequence of about ``length`` bases, each family with its rate of
    substitutions from ``subs`` and a few deletions, then random
    singletons -> (ids, seqs)."""
    lut = np.array(list("ACGT"))
    seqs = []
    for f in range(families):
        base = rng.integers(0, 4, size=length + int(rng.integers(-50, 50)))
        for _ in range(members):
            x = base.copy()
            hit = rng.random(len(x)) < subs[f % len(subs)]
            x[hit] = rng.integers(0, 4, size=int(hit.sum()))
            x = np.delete(x, rng.integers(0, len(x), size=int(
                rng.integers(0, 12))))
            seqs.append("".join(lut[x]))
    for _ in range(singletons):
        seqs.append("".join(lut[rng.integers(0, 4, size=length + int(
            rng.integers(-50, 50)))]))
    return [str(i) for i in range(len(seqs))], seqs


def identity_jobs(args, report):
    """One job of each shape on both sides of the job's choice: the serial
    walk on 8 threads (the host) and the windowed walk on the card, equal
    clusters; the side ``identity.resolve_clustering`` picks for the job in
    a fresh process (the CUDA context and the library's load charged) and
    in this one, beside both measured walls; the walk's counts."""
    import torch
    from multiprime_tpu_torch.cluster import greedy, identity
    from multiprime_tpu_torch.utils import link as linkmod
    from multiprime_tpu_torch.utils import trace
    rng = np.random.default_rng(args.seed + 1717)
    jobs = {"genome": (8300, 2, 450, 10, (0.03, 0.08)),
            "cds": (900, 40, 95, 20, (0.03, 0.08))}
    real_count = trace.count
    out = {}
    try:
        for name, shape in jobs.items():
            ids, seqs = cluster_job(rng, *shape)
            counts = {}

            def count(key, n=1):
                counts[key] = counts.get(key, 0) + n
            trace.count = count
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o_dev, c_dev = greedy.greedy_cluster_windows(
                ids, seqs, threads=8, device=DEVICE)
            dev_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            o_host, c_host = greedy.greedy_cluster(ids, seqs, threads=8)
            host_s = time.perf_counter() - t0
            if o_dev != o_host or [(c.rep_index, c.members) for c in c_dev] \
                    != [(c.rep_index, c.members) for c in c_host]:
                fail("phase 17 %s job: the windowed walk on the card and "
                     "the serial walk give different clusters" % name)
            lens = [len(x) for x in seqs]
            warm = identity.resolve_clustering(lens, 8)
            real = linkmod.device_startup_s
            linkmod.device_startup_s = lambda **kw: (
                linkmod.RATES["cuda_init_s"] + linkmod.RATES["kernel_load_s"])
            try:
                fresh = identity.resolve_clustering(lens, 8)
            finally:
                linkmod.device_startup_s = real
            out[name] = {"seqs": len(seqs), "clusters": len(c_dev),
                         "device_s": dev_s, "host_s": host_s,
                         "pick_fresh": fresh, "pick_warm": warm,
                         "counts": counts}
            say("phase 17 %s job: %d sequences, %d clusters, equal on both "
                "sides; the card's windowed walk %.3f s, the serial walk %.3f "
                "s (8 threads); the estimate picks %s in a fresh process, %s "
                "here; counts %s" % (name, len(seqs), len(c_dev), dev_s,
                                     host_s, fresh, warm, json.dumps(counts)))
    finally:
        trace.count = real_count
    report["identity"]["jobs"] = out


def background_segments(lengths, seg_len=1 << 16, overlap=17):
    """The segment lengths scan_hits_long cuts the background into."""
    stride = seg_len - overlap
    out = []
    for n in lengths:
        off = 0
        while True:
            out.append(min(seg_len, n - off))
            if off + seg_len >= n:
                break
            off += stride
    return out


def identity_entry(report):
    """The banded-identity kernel's entry of the kernels line: phase 17's
    genome pairs, native's time (one thread) as the yardstick; launches
    are those of phase 14's `run` (its clustering, forced to the card),
    phase 17's own timing launches beside them."""
    ident = report["identity"]
    g = ident["genome"]
    return dict(kernel_entry(dict(g, launches=report["mesh"]["run"][
        "identity_launches"], max_abs_err=ident["max_abs_err"],
        library_ms=None), "banded_identity", "banded_identity.cu",
        "none (the JAX package clusters on the host)"),
                timing_launches=ident["timing_launches"],
                native_ms=g["native_ms"], window_ms=g["window_ms"],
                window_bound_ms=g["window_bound_ms"], cds=ident["cds"],
                partial=ident["partial"], jobs=ident["jobs"])


def kernel_entry(m, name, source, replaces):
    """One kernel's entry of the kernels line, from its measurements."""
    return {"name": name, "route": "cuda",
            "source": "multiprime_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": m["launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "matches_plain": True}


def dp_entry(m, name, source, replaces, main_path, by_path):
    """A DP kernel's entry of the kernels line: ``launches`` from main_path,
    the path that runs it, ``launches_per_block`` one a block,
    ``native_ms`` the host DP's time a block as the yardstick (no single
    PyTorch call computes these DPs)."""
    return dict(kernel_entry(dict(m, launches=by_path[main_path],
                                  library_ms=None), name, source, replaces),
                native_ms=m["native_ms"],
                launches_per_block=m["launches_per_block"],
                launches_by_path=by_path, trace_share=m["trace_share"])


def cuda_kernels(m, by_path, warp):
    """The ``cuda_kernels`` of a DP's entry: its warp kernel (measurements
    ``m``, launches ``warp`` by path) and its CTA kernel (``m["cta"]``, the
    rest of ``by_path``), each with its times on phase 10's block."""
    out = []
    for k, paths in ((m, warp), (m["cta"], {p: by_path[p] - warp[p]
                                            for p in by_path})):
        out.append({"kernel": k["kernel"], "launches_by_path": paths,
                    **{key: k[key] for key in (
                        "ms", "ms_again", "plain_ms", "bound_ms",
                        "trace_share", "registers", "spill_bytes",
                        "peak_mib")}})
    return out


def gotoh_entry(report):
    """The Gotoh DP's entry of the kernels line: the numbers of the warp
    kernel, which serves the main path's blocks, and under
    ``cuda_kernels`` both CUDA kernels of csrc/gotoh_dp.cu, each with its
    launches by path and its times on phase 10's block."""
    g, run = report["gotoh_dp"], report["device_run"]
    by_path = {"run": run["gotoh_dp_launches"],
               "cluster": g["cluster_launches"]}
    warp = {"run": run["gotoh_dp_warp_launches"],
            "cluster": g["cluster_warp_launches"]}
    return dict(dp_entry(g, "gotoh_dp", "gotoh_dp.cu",
                         "multiprime_tpu/align/device.py:38", "run",
                         by_path), cuda_kernels=cuda_kernels(g, by_path, warp))


def refine_entry(report):
    """The refine DP's entry of the kernels line, as ``gotoh_entry``: the
    warp kernel's numbers (it serves refine_pass_device's blocks) and both
    CUDA kernels of csrc/refine_dp.cu under ``cuda_kernels``."""
    r, run = report["refine_dp"], report["device_run"]
    by_path = {"run": run["refine_dp_launches"],
               "refine_pass_device": r["pass_launches"]}
    warp = {"run": run["refine_dp_warp_launches"],
            "refine_pass_device": r["pass_warp_launches"]}
    return dict(dp_entry(r, "refine_dp", "refine_dp.cu",
                         "multiprime_tpu/align/device.py:122",
                         "refine_pass_device", by_path),
                cuda_kernels=cuda_kernels(r, by_path, warp))


def stage_a_entry(report):
    """Design Stage A's entry of the kernels line: the three kernels of
    csrc/design_stage_a.cu as one, their ms a 512-window block (the rows'
    call shared by the cluster's blocks) on phase 10's cluster, launches
    of the windows kernel by path (one a block, and a shard on the mesh),
    no PyTorch call computes it: the host NumPy Stage A's design wall
    beside the device one as the yardstick."""
    s, mesh = report["device_ops"]["stage_a"], report["mesh"]
    by_path = {"run": report["device_run"]["stage_a_kernel_launches"],
               "mesh_stage_a": mesh["stage_a"]["kernel_launches"]["windows"],
               "mesh_run": mesh["run"]["stage_a_kernel_launches"]}
    return dict(kernel_entry(dict(s, launches=by_path["run"],
                                  library_ms=None),
                             "design_stage_a", "design_stage_a.cu",
                             "multiprime_tpu/ops/design_scan.py:160"),
                launches_by_path=by_path, kernel_ms=s["kernel_ms"],
                launches_per_block=s["launches_per_block"],
                plain_launches_per_block=s["plain_launches_per_block"],
                design_wall_s=report["device_ops"]["design_stats_blocks"][
                    "design_wall_s"])


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
        res, run_find_hits = phase(4, phase_run, work)
        primers, keys = phase(5, phase_scan, work, res)
        phase(6, phase_new_kernels)
        phase(7, phase_bitmap, res, keys)
        phase(8, phase_dimer, primers)
        phase(9, phase_device_run, work, res)
        phase(10, phase_device_ops_apart, work, res)
        phase(11, phase_specificity, work, primers)
        phase(12, phase_update, work, res)
        phase(13, phase_onestep, work, res)
        phase(14, phase_mesh, work, res, keys)
        phase(15, phase_profile, work)
        phase(16, phase_crossover, work, res, keys)
        phase(17, phase_identity)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the launches of the find_hits kernels on every path that drove them,
    # each counted over that path alone (the CLI paths each in a process
    # of its own); the run's rule-19 scan is the main path
    spec = report["specificity"]["runs"]
    mesh = report["mesh"]
    by_path = {"run": run_find_hits,
               "device_run": report["device_run"]["find_hits_launches"],
               "scan": report["scan"]["find_hits_launches"],
               "specificity": sum(spec[n]["launches"] for n in spec
                                  if n.endswith("_device")),
               "update": report["update"]["device"]["update"]["launches"],
               "onestep": report["onestep"]["runs"]["device"]["launches"],
               "mesh_scan": mesh["scan"]["find_hits_launches"],
               "mesh_run": mesh["run"]["find_hits_launches"]}
    fh = report["find_hits"]
    # hit_codes is on no scan path now: its entry holds phase 11's numbers
    # and the launches of phase 11's call of the entry point whose codes
    # are held to find_hits's list
    codes_launches = fh["hit_codes_launches"]
    kernels = {"kernels": [
        dict(kernel_entry(dict(fh, launches=run_find_hits), "find_hits",
                          "find_hits.cu",
                          "multiprime_tpu/ops/mismatch_scan.py:462"),
             launches_by_path=by_path, kernels=3,
             codes_path_ms=fh["codes_path_ms"],
             compaction_ms=fh["compaction_ms"], peak_mib=fh["peak_mib"],
             codes_path_peak_mib=fh["codes_path_peak_mib"],
             library="torch.nonzero of the masked hit_codes codes",
             run_shape={k: report["find_hits_run_shape"][k] for k in (
                 "shape", "ms", "plain_ms", "codes_path_ms", "bound_ms",
                 "bound_by", "library_ms")}),
        dict(kernel_entry(report["dimer_fired"], "dimer_fired",
                          "dimer_fired.cu", "multiprime_tpu/ops/dimer.py:134"),
             launches_by_path={"dimer_fused": report["dimer_fired"][
                 "launches"]}),
        dict(kernel_entry(dict(report["hit_codes_background_shape"],
                               launches=codes_launches),
                          "hit_codes", "hit_codes.cu",
                          "multiprime_tpu/ops/mismatch_scan.py:173"),
             launches_by_path={"hit_codes_entry": codes_launches},
             main_shape={k: report["hit_codes"][k] for k in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
        dict(kernel_entry(report["match_counts"], "match_counts",
                          "match_counts.cu",
                          "multiprime_tpu/ops/mismatch_scan.py:150"),
             launches_by_path={
                 "dimer_unfused": report["match_counts"]["launches"],
                 "mesh_coverage":
                     mesh["coverage"]["match_counts_launches"]}),
        kernel_entry(report["hit_window_bitmap"], "hit_window_bitmap",
                     "hit_window_bitmap.cu",
                     "multiprime_tpu/ops/mismatch_scan.py:315"),
        gotoh_entry(report),
        refine_entry(report),
        stage_a_entry(report),
        identity_entry(report)]}
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
