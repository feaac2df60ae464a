"""The greedy clustering's seconds a completed `run` job: the program's
``clustering`` span (pipeline/driver.py's cluster stage, in the parent:
the word filter, the banded identities on the host or the card, and the
.clstr written)."""

from perfbench import spans


def read(run):
    return spans.mean_per_job(run, "run",
                              lambda ss, rec: spans.total(ss, "clustering"))
