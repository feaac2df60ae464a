"""The port's greedy identity clustering (multiprime_tpu_torch/cluster/
greedy.py) against the JAX package's, on genome-length sequences where the
word filter passes unrelated representatives, so a query is aligned
against several: the candidates aligned on a thread pool give the serial
walk's clusters."""

import numpy as np
import pytest

from multiprime_tpu.cluster import greedy as jgreedy
from multiprime_tpu_torch import native as tnative
from multiprime_tpu_torch.cluster import greedy as tgreedy


def _genomes(seed=41, families=2, members=10, singletons=4):
    """Families of 8.2-8.4 kb genomes with 3% substitutions and a few
    deletions, then random singletons of the same lengths."""
    rng = np.random.default_rng(seed)
    lut = np.array(list("ACGT"))
    seqs = []
    for _ in range(families):
        length = int(rng.integers(8200, 8400))
        base = rng.integers(0, 4, size=length)
        for _ in range(members):
            s = base.copy()
            hit = rng.random(length) < 0.03
            s[hit] = rng.integers(0, 4, size=int(hit.sum()))
            s = np.delete(s, rng.integers(0, length, size=int(
                rng.integers(0, 12))))
            seqs.append("".join(lut[s]))
    for _ in range(singletons):
        seqs.append("".join(lut[rng.integers(0, 4, size=int(
            rng.integers(8200, 8400)))]))
    return [str(i) for i in range(len(seqs))], seqs


def _clusters(clusters):
    return [(cl.rep_index, cl.members) for cl in clusters]


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_greedy_cluster_threads_equal_jax(threads, monkeypatch):
    """The port's clusters at 1, 3 and 8 threads equal the JAX package's
    serial ones, identities included, and the queries met more candidate
    representatives than one each."""
    assert tnative.available()
    ids, seqs = _genomes()
    want_order, want = jgreedy.greedy_cluster(ids, seqs)
    calls = []
    orig = tnative.banded_identity

    def counted(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(tnative, "banded_identity", counted)
    order, got = tgreedy.greedy_cluster(ids, seqs, threads=threads)
    assert order == want_order
    assert _clusters(got) == _clusters(want)
    assert len(got) == 2 + 4
    assert len(calls) > len(seqs)
