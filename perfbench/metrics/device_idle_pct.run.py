"""100 less the card's mean utilisation over the window, as NVML samples
it every 100 ms (``nvidia-smi``): device-wide, so the pool's worker
processes count too.  Nothing where NVML gave no samples."""


def read(run):
    if not run.nvml:
        return None
    util = [u for _, u, _ in run.nvml]
    return 100.0 - sum(util) / len(util)
