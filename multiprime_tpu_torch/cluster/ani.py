# Copied from multiprime_tpu/cluster/ani.py (host code, no JAX).
"""k-mer ANI estimation + small-cluster merging (fastANI replacement).

The reference's merge_cluster_by_ANI.py:116-279 shells out to fastANI for
every small cluster against each bigger cluster and merges (or drops) the
small cluster when the mean ANI >= threshold.  Here ANI between two sequences
is estimated from k-mer set Jaccard via the Mash distance identity

    ANI ~= 1 + ln(2j / (1 + j)) / k

which tracks fastANI's fragment-mapping estimate closely at the 80%+ range
the pipeline thresholds on.
"""

from __future__ import annotations

import math

import numpy as np

from .greedy import _encode, kmer_set


def ani_estimate(seq_a, seq_b, k=16):
    """Approximate average nucleotide identity in [0, 1]."""
    ka = kmer_set(_encode(seq_a), k)
    kb = kmer_set(_encode(seq_b), k)
    if ka.size == 0 or kb.size == 0:
        return 0.0
    inter = np.intersect1d(ka, kb, assume_unique=True).size
    union = ka.size + kb.size - inter
    if inter == 0:
        return 0.0
    j = inter / union
    return max(0.0, 1.0 + math.log(2 * j / (1 + j)) / k)


def mean_cluster_ani(small_seqs, big_seqs, k=16, max_pairs=100, seed=0):
    """Mean pairwise ANI between two clusters.

    When the small x big pair grid exceeds max_pairs, a seeded UNIFORM
    sample over the whole grid is used (fastANI maps all fragments; the
    first-N-pairs-in-iteration-order subsample this replaced covered only
    the first small sequence against the first big ones — a biased
    estimate whenever within-cluster diversity is uneven)."""
    ns, nb = len(small_seqs), len(big_seqs)
    total_pairs = ns * nb
    if total_pairs == 0:
        return 0.0
    if total_pairs <= max_pairs:
        pairs = ((i, j) for i in range(ns) for j in range(nb))
    else:
        rng = np.random.default_rng(seed)
        flat = rng.choice(total_pairs, size=max_pairs, replace=False)
        pairs = ((int(f) // nb, int(f) % nb) for f in np.sort(flat))
    total = count = 0
    for i, j in pairs:
        total += ani_estimate(small_seqs[i], big_seqs[j], k)
        count += 1
    return total / count


def merge_small_clusters(clusters, seqs_by_cluster, min_size=10,
                         ani_threshold=0.8, drop=False, k=16):
    """Merge clusters smaller than min_size into the best big cluster with
    mean ANI >= threshold; optionally drop unmergeable small clusters.

    clusters: list of member-id lists (big + small), ordered by size desc.
    seqs_by_cluster: list of member-sequence lists.
    -> (new_clusters, history): history rows mirror the reference's
    history.txt ("merged small -> big" / "dropped small").
    """
    sizes = [len(c) for c in clusters]
    big_idx = [i for i, s in enumerate(sizes) if s >= min_size]
    small_idx = [i for i, s in enumerate(sizes) if s < min_size]
    merged = {i: list(clusters[i]) for i in big_idx}
    history = []
    kept_small = []
    for si in small_idx:
        best, best_ani = None, 0.0
        for bi in big_idx:
            a = mean_cluster_ani(seqs_by_cluster[si], seqs_by_cluster[bi], k)
            if a > best_ani:
                best, best_ani = bi, a
        if best is not None and best_ani >= ani_threshold:
            merged[best].extend(clusters[si])
            history.append(("merged", si, best, round(best_ani, 4)))
        elif drop:
            history.append(("dropped", si, None, round(best_ani, 4)))
        else:
            kept_small.append(si)
            history.append(("kept", si, None, round(best_ani, 4)))
    out = [merged[i] for i in big_idx] + [clusters[i] for i in kept_small]
    return out, history
