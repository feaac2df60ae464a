"""Seconds a completed panel spends uploading the encoded background and
the patterns to the card, to the copy's end: the program's
``scan.upload`` spans (validate/scan.py)."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(
        run, "specificity",
        lambda ss, rec: spans.total(ss, "scan.upload"))
