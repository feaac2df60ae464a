"""Step by step timing of the port's find_hits compaction on a CUDA card.

Builds one batch of hit codes at the 64 Mb background's scan shape
([16, 65,519, 744] int8, 500 sparse hits, rows of full, partial and zero
length), then times with CUDA events (mean of 10 after a warm-up): the
whole ``find_hits_from_codes``; each full-size step alone in the forms
considered for it (the window mask as a broadcast ``masked_fill_`` and as
a multiply, the block counts as bool sums in 2**20-block steps, the
reductions over bytes and int64 words); the nonzero over the block counts
and the candidate step; and a torch.profiler table of one whole call.

    python examples/torch_compaction_steps.py     (from the repo root)
"""

import sys

import torch

sys.path.insert(0, ".")

from multiprime_tpu_torch.ops import mismatch_scan as ms  # noqa: E402


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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    n, n_out, p, plen = 16, 65519, 744, 18
    torch.manual_seed(0)
    codes = torch.zeros((n, n_out, p), dtype=torch.int8, device=dev)
    codes.view(-1)[torch.randint(0, codes.numel(), (500,), device=dev)] = 2
    lens = torch.full((n,), 65536, dtype=torch.int32, device=dev)
    lens[11:] = 0
    lens[10] = 30000
    outside = (torch.arange(n_out, device=dev)[None, :] + plen) \
        > lens[:, None]
    flat = codes.reshape(-1)
    nf = flat.numel() // 64
    full = flat[:nf * 64].view(nf, 64)
    words = full.view(torch.int64)
    blk = torch.empty(nf, dtype=torch.int32, device=dev)

    def bool_counts():
        for lo in range(0, nf, 1 << 20):
            hi = min(lo + (1 << 20), nf)
            torch.sum(full[lo:hi] > 0, dim=1, dtype=torch.int32,
                      out=blk[lo:hi])
    chunk = full[:1 << 20]
    steps = {
        "find_hits_from_codes": lambda: ms.find_hits_from_codes(
            codes, lens, plen=plen, max_hits=1 << 17),
        "mask masked_fill_ bytes": lambda: codes.masked_fill_(
            outside[:, :, None], 0),
        "mask masked_fill_ int64 words": lambda: codes.view(
            torch.int64).masked_fill_(outside[:, :, None], 0),
        "mask mul_": lambda: codes.mul_((~outside)[:, :, None].to(
            torch.int8)),
        "counts bool sum int32, 2**20-block steps": bool_counts,
        "one step: > 0": lambda: chunk > 0,
        "one step: sum(bool, int32)": lambda: torch.sum(
            chunk > 0, dim=1, dtype=torch.int32),
        "one step: count_nonzero": lambda: torch.count_nonzero(chunk,
                                                              dim=1),
        "one step: != 0 as int64 words, sum": lambda: (
            chunk != 0).view(torch.int64).sum(dim=1),
        "amax of int64 words": lambda: words.amax(dim=1),
        "amax of int8 blocks": lambda: full.amax(dim=1),
        "nonzero_static of block flags": lambda: torch.nonzero_static(
            blk > 0, size=1 << 17, fill_value=-1),
    }
    print(torch.cuda.get_device_name(0))
    for name, fn in steps.items():
        print("%-44s %.4f ms" % (name, timed(fn)))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms.find_hits_from_codes(codes, lens, plen=plen, max_hits=1 << 17)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=12))


if __name__ == "__main__":
    main()
