"""The refine DP kernels' share of their roofline: the least time of every
pass the completed jobs ran (roofline_dp.py, from the ``cells`` and
``member_columns`` of the program's ``align.refine`` spans), over the
CUDA-event seconds of the ``refine_dp`` launchers (both kernels) in those
spans.  Nothing where no span holds a launch."""

from perfbench import roofline_dp, spans


def read(run):
    jobs = spans.by_job(run, "run")
    if not jobs:
        return None
    cells = cols = secs = 0.0
    for _, ss in jobs:
        for s in ss:
            if s["name"] != "align.refine":
                continue
            cells += s["counts"].get("cells", 0)
            cols += s["counts"].get("member_columns", 0)
            secs += sum(t for k, (_, t) in s["kernels"].items()
                        if k in ("refine_dp", "refine_dp_warp"))
    if secs <= 0 or cells <= 0:
        return None
    return 100.0 * roofline_dp.refine_bound_s(cells, cols) / secs
