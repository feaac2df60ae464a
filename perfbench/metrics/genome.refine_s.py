"""The MSA polish's seconds a completed `run` job, summed over the
workers: the program's ``align.refine`` spans (align/refine.py: each
refine_msa call, its passes' profiles, kernels, copies and scores)."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(
        run, "run", lambda ss, rec: spans.total(ss, "align.refine"))
