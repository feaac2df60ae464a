"""Input sequences of the completed ``run`` jobs over the window: from its
start to the last completion (host clock)."""


def read(run):
    seqs = sum(r["work"].get("seqs", 0) for r in run.completed())
    return seqs / run.elapsed_s if seqs else None
