"""The port's two kernels of each device DP side by side on one block, on a card.

For each DP (``--dp gotoh,refine``, both by default) builds its source
(``csrc/gotoh_dp.cu``, ``csrc/refine_dp.cu``; printing ptxas's registers
and spills of each kernel), makes a seeded block like the smoke check's
phase 10 from a center of 923 bases and members that are copies of it
with 6% substitutions and 0-3 indels of 1-12 bases (Gotoh: the center
against 512 members; refine: the first 256 rows of a center-star MSA of
the center and 256 members), holds the DP's wrapper to its plain version
under each dispatch (the warp kernel, then the CTA kernel forced by
setting the DP's limit to 0), and times the two in turns (warp, CTA, CTA,
warp; CUDA events, mean of 10 after a warm-up) with each one's trace
share from its ``clock64`` stamps and the peak device memory of a call.
With ``--warps 1,2,4`` it then builds ``csrc/gotoh_dp.cu`` again with
each number of members (warps) a CTA of the Gotoh warp kernel and times
those builds in five rounds of rotating order (10 launches each; median
and minimum).

    python examples/torch_dp_kernels.py [--dp gotoh,refine] [--la 923]
        [--gotoh-members 512] [--refine-members 256] [--warps 1,2,4]
"""

import argparse
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")

from multiprime_tpu_torch.align import centerstar, refine  # noqa: E402
from multiprime_tpu_torch.align import device as adev  # noqa: E402
from multiprime_tpu_torch.ops import _cuda  # noqa: E402


def timed(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def member(rng, c):
    b = c.copy()
    k = rng.random(len(b)) < 0.06
    b[k] = rng.integers(0, 4, size=int(k.sum()))
    for _ in range(int(rng.integers(0, 4))):
        at, n = int(rng.integers(0, len(b))), int(rng.integers(1, 13))
        if rng.random() < 0.5:
            b = np.delete(b, np.arange(at, min(at + n, len(b))))
        else:
            b = np.insert(b, at, rng.integers(0, 4, size=n))
    return b.astype(np.int8)


def gotoh_case(args, dev):
    """-> (run(clocks=None), the plain version's ops, members)."""
    rng = np.random.default_rng(args.seed)
    c = rng.integers(0, 4, size=args.la).astype(np.int8)
    block = [member(rng, c) for _ in range(args.gotoh_members)]
    c_dev = torch.from_numpy(c.astype(np.int32)).to(dev)
    bmat, lbs = adev.gotoh_block_inputs(block, device=dev)
    lb = bmat.shape[1]
    print("gotoh: la=%d M=%d lb=%d: plan %s" % (
        args.la, len(block), lb, adev.gotoh_kernel_plan(lb)))
    return (lambda clocks=None: adev.gotoh_block(c_dev, bmat, lbs,
                                                 clocks=clocks),
            adev.gotoh_block_reference(c, bmat, lbs, dev), len(block))


def refine_case(args, dev):
    """-> (run(clocks=None), the plain version's columns, members)."""
    rng = np.random.default_rng(args.seed)
    c = rng.integers(0, 4, size=args.la).astype(np.int8)
    seqs = ["".join("ACGT"[x] for x in s) for s in
            [c] + [member(rng, c) for _ in range(args.refine_members)]]
    _, rows = centerstar.center_star_msa(
        [str(i) for i in range(len(seqs))], seqs, backend="native",
        device="cpu")
    _, res_codes, lens, f6, occ, n_cols = refine.device_pass_inputs(rows)
    m = args.refine_members
    blk = adev.refine_block_inputs(res_codes, lens, f6, occ, slice(0, m),
                                   device=dev)
    lmax = blk[0].shape[1]
    print("refine: M=%d C=%d lmax=%d: plan %s" % (
        m, n_cols, lmax, adev.refine_kernel_plan(lmax)))
    return (lambda clocks=None: adev.refine_block(*blk, clocks=clocks),
            adev.refine_block_reference(*blk, dev), m)


# each DP: its block, its library and the limit that forces its CTA kernel
DPS = {"gotoh": (gotoh_case, "gotoh_dp", "_GOTOH_WARP_MAX_COLS"),
       "refine": (refine_case, "refine_dp", "_REFINE_WARP_MAX_POS")}


def trace_share(run, m, dev):
    clocks = torch.zeros((m, 3), dtype=torch.int64, device=dev)
    run(clocks)
    ck = clocks.cpu().numpy().astype(np.float64)
    return float((ck[:, 2] - ck[:, 1]).sum() / (ck[:, 2] - ck[:, 0]).sum())


def both_kernels(run, want, m, limit_attr, dev):
    """Each kernel equal to the plain version's ``want`` and timed, in
    turns -> {"warp": [ms, ms], "cta": [ms, ms]}."""
    limit = getattr(adev, limit_attr)
    forced = {"warp": limit, "cta": 0}
    out = {}
    for name in ("warp", "cta", "cta", "warp"):
        setattr(adev, limit_attr, forced[name])
        try:
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                sys.exit("the %s kernel differs from the plain version" % name)
            ms = timed(run)
            share = trace_share(run, m, dev)
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
        finally:
            setattr(adev, limit_attr, limit)
        out.setdefault(name, []).append(ms)
        print("%s kernel: %.4f ms (trace %.1f%% of the members' cycles), "
              "peak %.1f MiB, equal to the plain version"
              % (name, ms, 100 * share, peak))
    return out


def warps_builds(counts, run, want):
    """Build csrc/gotoh_dp.cu once for each count of warps a CTA of the warp
    kernel (into _build/warps<n>/), check each against the plain version's
    ``want``, and time them in rotating order -> {count: [ms, ...]}."""
    src_dir, build_dir = _cuda.SRC_DIR, _cuda.BUILD_DIR
    src = open(os.path.join(src_dir, "gotoh_dp.cu")).read()
    line = "constexpr int kWarpsPerBlock = "
    at = src.index(line) + len(line)
    libs = {}
    try:
        for n in counts:
            d = os.path.join(build_dir, "warps%d" % n)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "gotoh_dp.cu"), "w") as f:
                f.write(src[:at] + str(n) + src[src.index(";", at):])
            _cuda.SRC_DIR, _cuda.BUILD_DIR = d, d
            _cuda._libs.pop("gotoh_dp", None)
            _cuda.build(["gotoh_dp"], force=True)
            libs[n] = _cuda.load("gotoh_dp")
            regs = re.findall(r"Used (\d+) registers",
                              _cuda.BUILD_LOG["gotoh_dp"])
            print("%d warps a CTA: ptxas registers (K = 40 .. 8, CTA "
                  "kernel) %s" % (n, regs))
        out = {n: [] for n in counts}
        for rnd in range(5):
            order = counts[rnd % len(counts):] + counts[:rnd % len(counts)]
            for n in order:
                _cuda._libs["gotoh_dp"] = libs[n]
                if rnd == 0:
                    got = run()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        sys.exit("%d warps a CTA differs from the plain "
                                 "version" % n)
                out[n].append(timed(run))
        return out
    finally:
        _cuda.SRC_DIR, _cuda.BUILD_DIR = src_dir, build_dir
        _cuda._libs.pop("gotoh_dp", None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", default="gotoh,refine")
    ap.add_argument("--la", type=int, default=923)
    ap.add_argument("--gotoh-members", type=int, default=512)
    ap.add_argument("--refine-members", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warps", default="",
                    help="comma-separated warps a CTA of the Gotoh warp "
                    "kernel to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for dp in args.dp.split(","):
        case, lib, limit_attr = DPS[dp]
        _cuda.build([lib], force=True)
        for line in _cuda.BUILD_LOG[lib].splitlines():
            if re.search(r"Compiling entry|registers|spill", line):
                print("  " + line.strip())
        run, want, m = case(args, dev)
        out = both_kernels(run, want, m, limit_attr, dev)
        print(dp, {k: [round(v, 4) for v in vs] for k, vs in out.items()})
        if dp == "gotoh" and args.warps:
            counts = [int(x) for x in args.warps.split(",")]
            for n, vs in warps_builds(counts, run, want).items():
                vs = sorted(vs)
                print("warp kernel, %d warps a CTA: median %.4f ms, min "
                      "%.4f ms of %s" % (n, vs[len(vs) // 2], vs[0],
                                         [round(v, 4) for v in vs]))


if __name__ == "__main__":
    main()
