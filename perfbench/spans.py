"""The program's own spans (multiprime_tpu_torch/utils/trace.py), for the
metric readers: a traced run's spans of each completed job, found by the
job's request, whose root span lies inside the job's start and end (one
clock: perf_counter).  Nothing where the program recorded no span: an
untraced run, or a program without the recorder."""


def by_job(run, root):
    """-> [(record, spans)] for each completed job with a request whose
    root span is named ``root``, or None where there is none."""
    try:
        from multiprime_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.spans()
    roots = [s for s in spans if s["parent"] is None and s["name"] == root]
    out = []
    for rec in run.completed():
        lo, hi = rec["start"] * 1e9, rec["end"] * 1e9
        requests = {r["request"] for r in roots
                    if lo <= r["start"] and r["end"] <= hi}
        if requests:
            out.append((rec, [s for s in spans
                              if s["request"] in requests]))
    return out or None


def seconds(span):
    return (span["end"] - span["start"]) / 1e9


def total(spans, *names):
    """Seconds in the spans of the given names, summed; None where the
    job has none."""
    mine = [seconds(s) for s in spans if s["name"] in names]
    return sum(mine) if mine else None


def mean_per_job(run, root, value):
    """The mean over the completed jobs of ``value(spans, record)``, the
    jobs where it gives None left out; None where every job is."""
    jobs = by_job(run, root)
    if not jobs:
        return None
    values = [v for v in (value(s, rec) for rec, s in jobs) if v is not None]
    return sum(values) / len(values) if values else None
