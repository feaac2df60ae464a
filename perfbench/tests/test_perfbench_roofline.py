"""The copied bound arithmetic against the numbers PERF.md holds."""

import numpy as np
import pytest

from perfbench import roofline


def _background_last_batch(seg_len=1 << 16, plen=18, bs=16):
    """Phase 11's last batch of the 64 Mb background: the last genome's
    last segments (its final one shorter), then padding rows."""
    stride = seg_len - plen + 1

    def segments(n):
        return 1 + max(0, -(-(n - seg_len) // stride))
    lengths = [4000000] * 16
    lengths[-1] -= 5 * stride
    while sum(map(segments, lengths)) % bs == 0:
        lengths[-1] -= stride
    last = lengths[-1]
    n_segs = sum(map(segments, lengths))
    offs = [k * stride for k in range(segments(last))]
    lens = np.zeros(bs, np.int64)
    tail = offs[-(n_segs % bs):]
    lens[:len(tail)] = [min(seg_len, last - o) for o in tail]
    return lengths, lens


def test_find_hits_bound_at_the_background_batch():
    """The find_hits bound of the background batch in PERF.md's kernel table:
    0.0356 ms at N=16 L=65,536 P=744, 11 real rows."""
    lengths, lens = _background_last_batch()
    assert lengths[-1] == 3672405 and (lens > 0).sum() == 11
    ms = 1e3 * roofline.find_hits_bound_s(16, 1 << 16, lens, 744, 18,
                                          1 << 17)
    assert round(ms, 4) == 0.0356


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12, 0, 1) == pytest.approx(1.0)
    assert roofline.bound_s(0, 1.979e15, roofline.INT8_OPS_PER_S) == \
        pytest.approx(1.0)
