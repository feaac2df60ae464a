"""Design Stage B's seconds a completed `run` job, summed over the
workers: the program's ``design.stage_b`` spans (models/mcdpd.py: the
per-window loop of each block)."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(
        run, "run", lambda ss, rec: spans.total(ss, "design.stage_b"))
