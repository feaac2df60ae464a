"""Design Stage A's seconds a completed `run` job, summed over the
workers: the program's ``design.stage_a`` spans (models/mcdpd.py: the
host's wait for each block of ops/design_scan.design_stats_blocks, its
kernels and copies included)."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(
        run, "run", lambda ss, rec: spans.total(ss, "design.stage_a"))
