"""Panels whose check completed, a minute, over the window: from its
start to the last completion (host clock).  A per-layer metric: the host's
slow spells on the card's machine spread it by up to a fifth from run to
run."""


def read(run):
    panels = sum(r["work"].get("panels", 0) for r in run.completed())
    return 60.0 * panels / run.elapsed_s if panels else None
