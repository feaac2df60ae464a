"""How busy the fan-out's workers were in a completed `run` job: its
``cluster`` spans summed, over the workers (the ``fanout`` span's count)
times the ``fanout`` span's wall, in percent, a job."""

from perfbench import spans


def read(run):
    def busy(ss, rec):
        fanout = [s for s in ss if s["name"] == "fanout"]
        clusters = spans.total(ss, "cluster")
        if not fanout or clusters is None:
            return None
        room = sum(s["counts"].get("workers", 1) * spans.seconds(s)
                   for s in fanout)
        return 100.0 * clusters / room if room > 0 else None
    return spans.mean_per_job(run, "run", busy)
