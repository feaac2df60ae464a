"""Seconds a completed panel spends turning the hit blocks into Python
tuples, both directions: the program's ``scan.hitlist`` spans
(validate/scan.py)."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(
        run, "specificity",
        lambda ss, rec: spans.total(ss, "scan.hitlist"))
