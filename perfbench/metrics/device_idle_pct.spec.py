"""The share of the window in which the card ran no operation: 100 less
the union of the trace's device activity over the window's length
(torch.profiler, this process's first session)."""


def read(run):
    prof = run.profile
    if prof is None or prof["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_us"] / 1e6 / run.elapsed_s)
