"""The card's memory at its peak, in MiB: the largest that the process's
allocator held from its start to the window's close
(``torch.cuda.max_memory_allocated``, the reading of ``memory_peak_bytes``),
the set-up's warm-up job included.  None on the CPU."""


def read(run):
    return run.memory_peak_bytes / 2 ** 20 if run.memory_peak_bytes else None
