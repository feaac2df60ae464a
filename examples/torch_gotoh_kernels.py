"""The port's two Gotoh kernels side by side on one member block, on a card.

Builds ``csrc/gotoh_dp.cu`` (printing ptxas's registers and spills of each
kernel), makes a seeded block like the smoke check's phase 10 (a center of
923 bases and 512 members, each a copy with 6% substitutions and 0-3
indels of 1-12 bases), holds ``gotoh_block`` to its plain version under
each dispatch (the warp kernel, then the CTA kernel forced by setting
``_GOTOH_WARP_MAX_COLS`` to 0), and times the two in turns (warp, CTA,
CTA, warp; CUDA events, mean of 10 after a warm-up) with each one's trace
share from its ``clock64`` stamps and the peak device memory of a call.
With ``--warps 1,2,4`` it then builds the source again with each number of
members (warps) a CTA of the warp kernel and times those builds in five
rounds of rotating order (10 launches each; median and minimum).

    python examples/torch_gotoh_kernels.py [--la 923] [--members 512]
        [--warps 1,2,4]
"""

import argparse
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")

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


def trace_share(c, bmat, lbs):
    clocks = torch.zeros((bmat.shape[0], 3), dtype=torch.int64,
                         device=bmat.device)
    adev.gotoh_block(c, bmat, lbs, clocks=clocks)
    ck = clocks.cpu().numpy().astype(np.float64)
    return float((ck[:, 2] - ck[:, 1]).sum() / (ck[:, 2] - ck[:, 0]).sum())


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
    ap.add_argument("--la", type=int, default=923)
    ap.add_argument("--members", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warps", default="",
                    help="comma-separated warps a CTA to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _cuda.build(["gotoh_dp"], force=True)
    for line in _cuda.BUILD_LOG["gotoh_dp"].splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("  " + line.strip())
    rng = np.random.default_rng(args.seed)
    c = rng.integers(0, 4, size=args.la).astype(np.int8)
    block = [member(rng, c) for _ in range(args.members)]
    c_dev = torch.from_numpy(c.astype(np.int32)).to(dev)
    bmat, lbs = adev.gotoh_block_inputs(block, device=dev)
    lb = bmat.shape[1]
    print("la=%d M=%d lb=%d: plan %s" % (args.la, args.members, lb,
                                         adev.gotoh_kernel_plan(lb)))
    want = adev.gotoh_block_reference(c, bmat, lbs, dev)
    limit = adev._GOTOH_WARP_MAX_COLS
    forced = {"warp": limit, "cta": 0}
    out = {}
    for name in ("warp", "cta", "cta", "warp"):
        adev._GOTOH_WARP_MAX_COLS = forced[name]
        try:
            got = adev.gotoh_block(c_dev, bmat, lbs)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                sys.exit("the %s kernel differs from the plain version" % name)
            ms = timed(lambda: adev.gotoh_block(c_dev, bmat, lbs))
            share = trace_share(c_dev, bmat, lbs)
            torch.cuda.reset_peak_memory_stats()
            adev.gotoh_block(c_dev, bmat, lbs)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
        finally:
            adev._GOTOH_WARP_MAX_COLS = limit
        out.setdefault(name, []).append(ms)
        print("%s kernel: %.4f ms (trace %.1f%% of the members' cycles), "
              "peak %.1f MiB, equal to the plain version"
              % (name, ms, 100 * share, peak))
    print({k: [round(v, 4) for v in vs] for k, vs in out.items()})
    if args.warps:
        counts = [int(x) for x in args.warps.split(",")]
        times = warps_builds(counts, lambda: adev.gotoh_block(c_dev, bmat,
                                                               lbs), want)
        for n, vs in times.items():
            vs = sorted(vs)
            print("warp kernel, %d warps a CTA: median %.4f ms, min %.4f ms "
                  "of %s" % (n, vs[len(vs) // 2], vs[0],
                             [round(v, 4) for v in vs]))


if __name__ == "__main__":
    main()
