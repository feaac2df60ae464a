"""The card's published peaks and the least time a kernel could take: the
yardstick of every ``*_roofline`` metric, copied from chip_smoke.py
(``bound`` and the ``find_hits`` count of measure_find_hits) so that a later
change to the port cannot move it.

Peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W): 3.35 TB/s of
HBM, 1,979 TOP/s in int8 on the tensor cores.
"""

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def bound_s(n_bytes, ops, ops_per_s):
    """The larger of the bytes over the memory rate (each input read once,
    each output written once) and the operations over their peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / ops_per_s)


def find_hits_bound_s(n, length, lens, p, plen, max_hits,
                      mask_bytes=1, len_bytes=4):
    """One ``find_hits`` call on n target rows of ``length`` mask bytes with
    ``lens`` bases each, against p (padded) patterns of plen: in, the masks,
    the lengths and both [p, 4] int64 plane sets; out, the two hit lists of
    max_hits int64 and n_hits; the operations, the int8 window product of
    the windows inside their rows, 2 * 4 * plen a window and pattern."""
    n_out = length - plen + 1
    windows = int(np.clip(np.asarray(lens, np.int64) - plen + 1, 0,
                          n_out).sum())
    in_bytes = n * length * mask_bytes + n * len_bytes + 2 * p * 4 * 8
    out_bytes = 2 * max_hits * 8 + 8
    return bound_s(in_bytes + out_bytes, 2 * windows * p * 4 * plen,
                   INT8_OPS_PER_S)
