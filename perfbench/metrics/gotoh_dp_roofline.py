"""The Gotoh DP kernels' share of their roofline: the least time of every
block the completed jobs ran (roofline_dp.py, from the ``cells`` of the
program's ``align.dp`` spans), over the CUDA-event seconds of the
``gotoh_dp`` launchers (both kernels) in those spans.  Nothing where no
span holds a launch."""

from perfbench import roofline_dp, spans


def read(run):
    jobs = spans.by_job(run, "run")
    if not jobs:
        return None
    cells = secs = 0.0
    for _, ss in jobs:
        for s in ss:
            if s["name"] != "align.dp":
                continue
            cells += s["counts"].get("cells", 0)
            secs += sum(t for k, (_, t) in s["kernels"].items()
                        if k in ("gotoh_dp", "gotoh_dp_warp"))
    if secs <= 0 or cells <= 0:
        return None
    return 100.0 * roofline_dp.gotoh_bound_s(cells) / secs
