"""The CUDA kernels' device seconds a completed `run` job: every launch
of the job, in this process and in the pool's workers, timed by the
program between two CUDA events on its stream (ops/_cuda.py, read into the
innermost span).  Nothing where no kernel was launched."""

from perfbench import spans


def read(run):
    def kernel_s(ss, rec):
        times = [t for s in ss for _, t in s["kernels"].values()]
        return sum(times) if times else None
    return spans.mean_per_job(run, "run", kernel_s)
