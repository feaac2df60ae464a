"""The wall of a completed `run` job's fan-out: the program's ``fanout``
span (pipeline/driver.py: the pool made, every cluster's align, design and
pair, the last report merged), a job."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(run, "run",
                              lambda ss, rec: spans.total(ss, "fanout"))
