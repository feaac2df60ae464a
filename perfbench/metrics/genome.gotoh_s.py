"""The center-star DP's seconds a completed `run` job, summed over the
workers: the program's ``align.dp`` spans (align/device.py: each
align_ops_batch_device call, its member blocks' inputs, kernels, copies
and op matrices)."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(run, "run",
                              lambda ss, rec: spans.total(ss, "align.dp"))
