"""Seconds a completed panel spends in the benchmark's spec.join spans
(jobs/specificity.py: around validate/scan.py's pcr_join), over the window."""


def read(run):
    spans = [b - a for name, a, b in run.spans if name == "spec.join"]
    panels = sum(r["work"].get("panels", 0) for r in run.completed())
    return sum(spans) / panels if spans and panels else None
