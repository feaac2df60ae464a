"""Seconds a completed panel spends cutting the background into segments
and encoding them, both directions: the program's ``scan.segment`` and
``scan.encode`` spans (validate/scan.py)."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(
        run, "specificity",
        lambda ss, rec: spans.total(ss, "scan.segment", "scan.encode"))
