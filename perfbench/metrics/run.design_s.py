"""The design stage's seconds a completed job: pipeline_metrics.json's
timings_s["design"], summed over the pool's workers (busy time, not wall)."""


def read(run):
    done = [r["timings_s"]["design"] for r in run.completed()
            if "design" in r.get("timings_s", {})]
    return sum(done) / len(done) if done else None
