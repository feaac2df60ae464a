# Copied from multiprime_tpu/cluster/greedy.py (host code, no JAX).
"""Greedy identity clustering + exact dedup (cd-hit replacement).

The reference shells out to cd-hit twice (multiPrime.py:84,118):

* ``cd-hit -c 1.0``  — remove duplicates/contained sequences;
* ``cd-hit -c 0.7``  — greedy identity clustering; representatives feed the
  per-cluster MSA/design fan-out, members are parsed from the ``.clstr``
  file by extract_cluster.py:133-157.

This module reproduces cd-hit's *algorithmic contract* TPU-natively:
sequences sorted longest-first, each assigned to the first (earliest-created)
cluster whose representative aligns with identity >= threshold over the
shorter sequence, else founds a new cluster.  Identity is computed by banded
global alignment (vectorised over the band); a k-mer containment prefilter
(the analogue of cd-hit's short-word filter) skips hopeless candidates.
Outputs use cd-hit's .clstr format so downstream parsers are unchanged.

Note: cd-hit's own identity values depend on its heuristic banding and
word-index pruning; cluster *memberships* agree on clean data but are not
guaranteed bit-identical on borderline pairs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BASE_IDX = {65: 0, 67: 1, 71: 2, 84: 3}   # A C G T


def _encode(seq):
    arr = np.frombuffer(seq.encode("ascii"), np.uint8)
    out = np.full(arr.shape, 4, np.int8)
    for b, v in _BASE_IDX.items():
        out[arr == b] = v
    return out


def kmer_set(codes, k=8):
    """Packed k-mer codes of a sequence (positions with ambiguity excluded)."""
    if len(codes) < k:
        return np.empty(0, np.int64)
    valid = codes < 4
    kk = np.lib.stride_tricks.sliding_window_view(codes.astype(np.int64), k)
    vv = np.lib.stride_tricks.sliding_window_view(valid, k).all(axis=1)
    # MSB-first packing, matching native/seqlib.cpp kmer_codes
    weights = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    packed = kk @ weights
    return np.unique(packed[vv])


ALN_MATCH, ALN_MISMATCH = 2, -2
ALN_OPEN, ALN_EXT = -6, -1


def banded_identity(a_codes, b_codes, band=64):
    """Identity = matches on the best-scoring banded global alignment divided
    by the shorter length (cd-hit's definition).  Affine gaps (+2 match,
    -2 mismatch, -6 open, -1 extend): long biological indels stay cheap while
    single-gap detours cannot profitably chase matches in unrelated DNA (a
    free-gap match-max formulation degenerates into banded LCS and reports
    ~0.7 for random pairs).

    The DP maximises (score, matches) lexicographically — packed into one
    int64 key so every row stays vectorised; the within-row E-state
    propagation is the usual prefix-max-with-drift trick.
    """
    la, lb = len(a_codes), len(b_codes)
    if la > lb:
        a_codes, b_codes, la, lb = b_codes, a_codes, lb, la
    if la == 0:
        return 0.0
    width = 2 * band + (lb - la) + 1
    SCALE = np.int64(1 << 20)       # matches < 2^20; key = score*SCALE + m
    neg = np.int64(-1) << 40
    j_of = np.arange(width) - band  # j = row + (w - band)
    ext = np.int64(ALN_EXT) * SCALE
    opn = np.int64(ALN_OPEN) * SCALE
    v = np.full(width, neg, np.int64)     # best key
    f = np.full(width, neg, np.int64)     # gap-in-b (vertical) state
    v[band] = 0
    ok0 = (j_of >= 1) & (j_of <= lb)
    v[ok0] = opn + ext * j_of[ok0]
    for i in range(la):
        j = i + 1 + j_of
        valid = (j >= 0) & (j <= lb)
        jj = np.clip(j - 1, 0, lb - 1)
        is_match = ((b_codes[jj] == a_codes[i]) & (a_codes[i] < 4)) & (j >= 1)
        sub = np.where(is_match, ALN_MATCH, ALN_MISMATCH).astype(np.int64)
        # F (skip a[i], same column): source cells sit one band slot right
        f_shift = np.concatenate([f[1:], [neg]])
        v_shift = np.concatenate([v[1:], [neg]])
        f_new = np.maximum(f_shift + ext, v_shift + opn + ext)
        diag = np.where(j >= 1, v + sub * SCALE + is_match, neg)
        vert = np.maximum(diag, f_new)
        # E (skip b[j], within row): E[w] = max over w'<w of
        # (vert[w'] + open) or continuing E, each + ext per step.
        t = np.where(valid, vert + opn - ext * j, neg)
        run = np.maximum.accumulate(
            np.concatenate([[neg], t[:-1]]))
        e_new = run + ext * j
        v_new = np.where(valid, np.maximum(vert, e_new), neg)
        f = np.where(valid, f_new, neg)
        v = v_new
    end = lb - la + band
    return int(v[end] % SCALE) / la if v[end] > neg else 0.0


@dataclass
class Cluster:
    rep_index: int
    members: list           # (seq_index, identity_or_None) in join order


def greedy_cluster(ids, seqs, threshold=0.7, k=10, band=64,
                   word_filter_slack=1.0, threads=1):
    """-> (order, clusters): cd-hit-style greedy clustering.

    order: indices sorted longest-first (ties: input order) — the processing
    order, which is also the representative ordering.

    threads: with the native library, a query's candidate representatives
    are aligned ``threads`` at a time on a thread pool (the native call
    releases the GIL), and the first in candidate order that reaches the
    threshold takes the query, as in the serial walk: the clusters do not
    depend on it.  At genome length the word filter passes unrelated
    representatives, so a query meets several.  The pairs aligned are
    counted as ``identity.host_pairs`` on the innermost span.
    """
    from concurrent.futures import ThreadPoolExecutor
    from .. import native
    from ..utils import trace
    use_native = native.available()
    ident_fn = native.banded_identity if use_native else banded_identity
    kmer_fn = native.kmer_codes if use_native else kmer_set
    wave = max(int(threads), 1) if use_native else 1
    pool = ThreadPoolExecutor(wave) if wave > 1 else None
    n = len(seqs)
    order = sorted(range(n), key=lambda i: (-len(seqs[i]), i))
    codes = {i: _encode(seqs[i]) for i in order}
    clusters = []
    exact = {}              # full-sequence hash fast path
    # Inverted kmer -> cluster index (native hash map when available — the
    # per-query posting walk was the clustering hot spot at 100k+ seqs).
    posting = native.PostingIndex()
    for i in order:
        seq = seqs[i]
        placed = False
        if seq in exact:
            clusters[exact[seq]].members.append((i, 1.0))
            placed = True
        else:
            q_kmers = kmer_fn(codes[i], k)
            # Word filter (the cd-hit short-word screen): a pair at identity c
            # over shorter length L shares ~L*c^k k-mers when mismatches are
            # spread out, far more when they cluster; unrelated sequences
            # share ~L^2/4^k.  Require a conservative fraction of the
            # expectation before paying for an alignment — without this, the
            # scored alignment alone cannot reject unrelated pairs (optimally
            # placed length-difference gaps chase spurious matches).
            # k must keep L^2/4^k below 0.25*c^k*L for the longest inputs:
            # k=10 holds to L ~ 7.4 kb at c = 0.7 (past it, as for 8.3 kb
            # genomes, unrelated pairs pass and are aligned).  The shared
            # counts come from one pass over the inverted index, not per-rep
            # intersections.
            need = 0.25 * (threshold ** k) * max(len(seq) - k + 1, 1)
            cands = posting.query(q_kmers, need / word_filter_slack)

            def to_rep(ci):
                return ident_fn(codes[i], codes[clusters[ci].rep_index], band)
            for lo in range(0, len(cands), wave):
                part = cands[lo:lo + wave]
                trace.count("identity.host_pairs", len(part))
                idents = (pool.map(to_rep, part)
                          if pool is not None and len(part) > 1
                          else map(to_rep, part))
                for ci, ident in zip(part, idents):
                    if ident >= threshold:
                        clusters[ci].members.append((i, ident))
                        placed = True
                        break
                if placed:
                    break
        if not placed:
            exact[seq] = len(clusters)
            ci = len(clusters)
            clusters.append(Cluster(rep_index=i, members=[(i, None)]))
            posting.add(q_kmers, ci)
    if pool is not None:
        pool.shutdown()
    return order, clusters


# a window's pairs: enough to fill the card's warps (132 SMs x 16), and
# cells capped so that a window ending early at a founder throws away
# about one pair's latency of work at genome length (the tests lower both)
_WINDOW_PAIRS = 2112
_WINDOW_CELLS = 1 << 30


def greedy_cluster_windows(ids, seqs, threshold=0.7, k=10, band=64,
                           word_filter_slack=1.0, threads=1, device="cuda"):
    """``greedy_cluster``'s clusters, identities included, with the banded
    identities of a window of queries computed in one batch on ``device``
    through ``identity.banded_matches`` (the kernels, or their plain
    version on the CPU).

    A window takes the next queries in processing order (those the exact
    hash places ride along) until its pairs fill ``_WINDOW_PAIRS`` or
    ``_WINDOW_CELLS``, or a query with no candidate ends it; each query's
    candidates come from the word filter against the representatives that
    stand at the window's start.  The walk then places the window's queries
    in order by the serial rule (the first candidate, in ascending cluster
    id, at the threshold).  The first query that none takes founds a
    cluster and ends the window: the queries after it start the next one,
    which sees the new representative (a thrown-away query keeps its
    candidates and adds each later founder whose k-mers pass the filter:
    the posting index's answer, without walking it again).  So every
    query kept saw the representatives the serial walk shows it.  The
    k-mers are taken up front on ``threads`` threads.  Every sequence has
    to be taken by ``identity.kernel_takes`` (up to about 524 kb), or the
    launch raises.

    Counts on the innermost span: ``identity.windows``, ``.launches``
    (one a window with pairs: a launch of each kernel its bands take),
    ``.pairs`` and ``.cells`` (those aligned in launches), ``.replayed``
    (queries thrown away by a window that ended early) and
    ``.replayed_pairs`` (their pairs)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from .. import native
    from ..utils import trace
    from . import identity
    use_native = native.available()
    kmer_fn = native.kmer_codes if use_native else kmer_set
    workers = max(int(threads), 1) if use_native else 1
    pool = ThreadPoolExecutor(workers) if workers > 1 else None
    n = len(seqs)
    order = sorted(range(n), key=lambda i: (-len(seqs[i]), i))
    codes = {i: _encode(seqs[i]) for i in order}
    lens = np.array([len(s) for s in seqs], np.int64)
    offs = np.zeros(n, np.int64)
    offs[1:] = np.cumsum(lens)[:-1]
    corpus = []     # every sequence's codes on the device, sent once

    def on_device(meta):
        if not corpus:
            flat = (np.concatenate([codes[i] for i in range(n)])
                    if n else np.zeros(0, np.int8))
            corpus.append(torch.from_numpy(flat).to(device))
        trace.count("identity.launches")
        trace.count("identity.pairs", meta.shape[1])
        trace.count("identity.cells",
                    int(identity.band_cells(meta[1], meta[3], band).sum()))
        return identity.identities(identity.banded_matches(
            corpus[0], meta, band).cpu().numpy(), meta)

    def kmers_of(i):
        return kmer_fn(codes[i], k)
    kmers = dict(zip(order, pool.map(kmers_of, order) if pool is not None
                     else map(kmers_of, order)))
    clusters = []
    exact = {}
    posting = native.PostingIndex()
    # a thrown-away query's candidates, and the clusters standing when the
    # word filter gave them
    carried = {}
    pos = 0
    while pos < n:
        # the window: (query, its candidates, or None where exact places it)
        window, pairs, cells = [], [], 0
        p = pos
        while p < n:
            i = order[p]
            if seqs[i] in exact:
                window.append((i, None))
                p += 1
                continue
            if pairs and (len(pairs) >= _WINDOW_PAIRS
                          or cells >= _WINDOW_CELLS):
                break
            need = 0.25 * (threshold ** k) * max(len(seqs[i]) - k + 1, 1)
            if i in carried:
                # the posting index's answer now: the earlier candidates
                # and each later founder that shares enough k-mers
                cands, seen = carried.pop(i)
                cands = cands + [
                    ci for ci in range(seen, len(clusters))
                    if native.intersect_count(
                        kmers[i], kmers[clusters[ci].rep_index])
                    >= need / word_filter_slack]
            else:
                cands = posting.query(kmers[i], need / word_filter_slack)
            window.append((i, cands))
            p += 1
            if not cands:
                break       # it founds a cluster: nothing after it is known
            for ci in cands:
                r = clusters[ci].rep_index
                pairs.append((i, r))
                cells += int(identity.band_cells(lens[i], lens[r], band))
        standing = len(clusters)
        trace.count("identity.windows")
        ident = {}
        if pairs:
            q, r = np.array(pairs, np.int64).T
            ident = dict(zip(pairs, on_device(
                np.stack([offs[q], lens[q], offs[r], lens[r]]))))
        # the walk, in order; the first founder ends the window
        for at, (i, cands) in enumerate(window):
            seq = seqs[i]
            if cands is None:
                clusters[exact[seq]].members.append((i, 1.0))
                continue
            for ci in cands:
                got = ident[(i, clusters[ci].rep_index)]
                if got >= threshold:
                    clusters[ci].members.append((i, got))
                    break
            else:
                exact[seq] = len(clusters)
                posting.add(kmers[i], len(clusters))
                clusters.append(Cluster(rep_index=i, members=[(i, None)]))
                thrown = [(q, c) for q, c in window[at + 1:] if c is not None]
                carried.update((q, (c, standing)) for q, c in thrown)
                trace.count("identity.replayed", len(thrown))
                trace.count("identity.replayed_pairs",
                            sum(len(c) for _, c in thrown))
                pos += at + 1
                break
        else:
            pos = p
    if pool is not None:
        pool.shutdown()
    return order, clusters


def write_clstr(clusters, ids, seqs, clstr_path):
    """cd-hit .clstr format (consumed by extract_cluster.py:133-157)."""
    with open(clstr_path, "w") as f:
        for ci, cl in enumerate(clusters):
            f.write(">Cluster %d\n" % ci)
            for mi, (si, ident) in enumerate(cl.members):
                tail = "*" if si == cl.rep_index else \
                    "at +/%.2f%%" % (100.0 * ident)
                f.write("%d\t%dnt, >%s... %s\n"
                        % (mi, len(seqs[si]), ids[si], tail))


def write_representatives(clusters, ids, seqs, fa_path):
    with open(fa_path, "w") as f:
        for cl in clusters:
            f.write(">" + ids[cl.rep_index] + "\n" + seqs[cl.rep_index] + "\n")


_ANCHOR = 32        # anchor length/stride for the containment index (long
                    # enough that homolog families rarely share one exactly)


def dedup(ids, seqs):
    """cd-hit -c 1.0 equivalent: drop exact duplicates and exact substrings
    of longer sequences (containment at 100% identity).

    Containment candidates come from a strided anchor index: each rep indexes
    its 16-mers at stride 16; a contained query must share one of its first
    16 offset-shifted 16-mers with the rep, so ~16 dict probes replace a scan
    over every representative.
    """
    order = sorted(range(len(seqs)), key=lambda i: (-len(seqs[i]), i))
    clusters = []
    seen = {}
    anchor_posting = {}     # anchor -> [(cluster id, position in rep)]
    max_rep_len = len(seqs[order[0]]) if order else 0

    for i in order:
        seq = seqs[i]
        placed = False
        if seq in seen:
            clusters[seen[seq]].members.append((i, 1.0))
            placed = True
        elif _ANCHOR <= len(seq) < max_rep_len:
            # Strict containment needs a strictly longer rep (equal-length
            # containment IS equality, already handled by the hash above);
            # length-uniform datasets skip the posting probes entirely.
            # A contained query aligns one of its first 16 offset-shifted
            # anchors (one per stride offset) with a rep anchor; the stored position pins
            # the alignment, so verification is a single early-exit
            # startswith instead of a full substring search.
            hits = []
            for off in range(min(_ANCHOR, max(len(seq) - _ANCHOR + 1, 0))):
                for ci, pos in anchor_posting.get(
                        seq[off:off + _ANCHOR], ()):
                    start = pos - off
                    if start >= 0:
                        hits.append((ci, start))
            for ci, start in sorted(set(hits)):
                rep = seqs[clusters[ci].rep_index]
                if start + len(seq) <= len(rep) \
                        and rep.startswith(seq, start):
                    clusters[ci].members.append((i, 1.0))
                    placed = True
                    break
        if not placed:
            seen[seq] = len(clusters)
            ci = len(clusters)
            clusters.append(Cluster(rep_index=i, members=[(i, None)]))
            for off in range(0, max(len(seq) - _ANCHOR + 1, 0), _ANCHOR):
                anchor_posting.setdefault(
                    seq[off:off + _ANCHOR], []).append((ci, off))
    return order, clusters
