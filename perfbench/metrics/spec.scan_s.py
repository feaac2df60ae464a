"""Seconds a completed panel spends in the benchmark's spec.scan spans
(jobs/specificity.py: around validate/scan.py's scan_hits_long, both
directions, ended by a synchronise), over the window."""


def read(run):
    spans = [b - a for name, a, b in run.spans if name == "spec.scan"]
    panels = sum(r["work"].get("panels", 0) for r in run.completed())
    return sum(spans) / panels if spans and panels else None
