"""The share of a completed panel's wall, from the job's start to its end,
that no child of its ``specificity`` root span covers: what the program's
spans do not yet see, in percent, the mean over the panels."""

from perfbench import spans


def read(run):
    def unspanned(ss, rec):
        roots = {s["id"] for s in ss if s["parent"] is None}
        lo, hi = rec["start"] * 1e9, rec["end"] * 1e9
        covered, reach = 0.0, lo
        for a, b in sorted((s["start"], s["end"]) for s in ss
                           if s["parent"] in roots):
            a, b = max(a, reach), min(b, hi)
            if b > a:
                covered += b - a
                reach = b
        return 100.0 * (1.0 - covered / (hi - lo)) if hi > lo else None
    return spans.mean_per_job(run, "specificity", unspanned)
