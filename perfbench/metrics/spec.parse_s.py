"""Seconds a completed panel spends parsing the background: the program's
``specificity.parse`` span (validate/specificity.py)."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(
        run, "specificity",
        lambda ss, rec: spans.total(ss, "specificity.parse"))
