"""The find_hits kernels' share of their roofline: the least time of each
recorded call (roofline.py, from its shapes), summed, over the device time
of the ``find_hits_*`` kernels in the trace.  Nothing where the trace holds
no such kernel."""

from perfbench import roofline


def read(run):
    calls = run.calls.get("find_hits", [])
    prof = run.profile
    if not calls or prof is None:
        return None
    kernel_us = sum(us for name, us in prof["by_name"].items()
                    if "find_hits" in name)
    if kernel_us <= 0:
        return None
    least = sum(roofline.find_hits_bound_s(
        c["shape"][0], c["shape"][1], c["lens"].cpu().numpy(), c["p"],
        c["plen"], c["max_hits"], mask_bytes=c["mask_bytes"],
        len_bytes=c["lens"].element_size()) for c in calls)
    return 100.0 * least / (kernel_us / 1e6)
