"""The pair stage's seconds a completed job: pipeline_metrics.json's
timings_s["pair"], summed over the pool's workers (busy time, not wall)."""


def read(run):
    done = [r["timings_s"]["pair"] for r in run.completed()
            if "pair" in r.get("timings_s", {})]
    return sum(done) / len(done) if done else None
