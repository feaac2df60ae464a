"""The longest ``worker.start`` span of a completed `run` job, a job: from
the pool's creation until the worker's first cluster begins (spawn,
imports).  Nothing where the job ran no pool."""

from perfbench import spans


def read(run):
    def longest(ss, rec):
        starts = [spans.seconds(s) for s in ss if s["name"] == "worker.start"]
        return max(starts) if starts else None
    return spans.mean_per_job(run, "run", longest)
