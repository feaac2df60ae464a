# Copied from multiprime_tpu/models/global_opt.py (host code, no JAX).
"""multiPrime2 "global optimum" degenerate refinement (v2 backend).

Implements the v2 algorithm of multiPrime2_onstep.py:1156-1270 /
multiPrime2-core_V2.py: instead of the greedy NN-link walk, collect the
mismatch (position, base) elements of every uncovered window variant versus
the consensus, then search (position,base)-combinations of size
<= dege_number-1 that maximise the number of variants left with <= variation
residual mismatches.  The chosen elements are merged into the consensus as
IUPAC codes.

Quirks replicated from the reference:
* ``Y_dist_len_collection`` dedup tests a list against dict *values* (lists
  of lists) — never true, so duplicate mismatch patterns are appended and
  counted repeatedly in the combination score (:1225-1232).
* the element pool only includes patterns with 1 < len < degenerate_number +
  variation, and the search returns early with (max_count, comb) the moment
  a combination covers everything (:1240-1270).
"""

from __future__ import annotations

import itertools

from ..utils import iupac


def mismatch_elements(primer, target):
    """["pos|BASE", ...] for every position where target's base differs from
    the (plain ACGT) primer's (Y_position, multiPrime2_onstep.py:248-252).

    The reference computes score_table[p]-score_table[t] and maps the diff
    back to a base via non_score_table.  For t in ACGT that recovers t; for a
    GAP in the target the diff is score[p]-100 which non_score_table maps to
    the PRIMER's own base (e.g. -98.79 -> "C"), so gap positions surface as
    no-op elements carrying p itself.  Replicated char-wise.
    """
    out = []
    for idx, (p, t) in enumerate(zip(primer, target)):
        if t == p:
            continue
        out.append("%d|%s" % (idx, p if t == "-" else t))
    return out


def merge_elements(primer, elements):
    """Add each element's base into the primer code (degenerate_merge,
    multiPrime2_onstep.py:516-523)."""
    chars = list(primer)
    for el in elements:
        pos, base = el.split("|")
        pos = int(pos)
        if base not in iupac.CODE_MEMBERS.get(chars[pos], [chars[pos]]):
            chars[pos] = iupac.union_char([chars[pos], base])
    return "".join(chars)


def refine_global(primer, cover, dege_number, variation, cover_number):
    """-> (degenerate_primer, coverage) via the v2 combination search.

    NOTE on set usage: the reference iterates ``itertools.combinations``
    directly over Python sets, so which of several equal-count combinations
    wins depends on the sets' internal hash-table layout.  To stay
    bit-identical in-process we perform the SAME set operations in the SAME
    order as multiPrime2_onstep.py:1215-1270 (set-difference over
    set(cover.keys()), per-pattern ``union`` accumulation) instead of any
    tidier equivalent.
    """
    optimal_set = set(iupac.expand(primer))
    uncover = set(cover.keys()) - optimal_set
    dist_number = {}
    dist_by_len = {}
    for key in uncover:
        dist = mismatch_elements(primer, key)
        joined = "_".join(dist)
        dist_number[joined] = dist_number.get(joined, 0) + 1
        # reference bug preserved: the dedup membership test compares a list
        # against dict *values* (lists of lists) and never fires, so every
        # pattern (duplicates included) is appended
        dist_by_len.setdefault(len(dist), []).append(dist)
    coverage, chosen = _search_combinations(
        dist_number, dist_by_len, dege_number, variation, cover_number)
    return merge_elements(primer, chosen), coverage


def _search_combinations(dist_number, dist_by_len, n, variation,
                         cover_number):
    """remove_elements (multiPrime2_onstep.py:1240-1270)."""
    max_count = 0
    max_subset = ()
    for degenerate_number in range(2, n + 1):
        pool = []
        elements = set()
        for length in dist_by_len.keys():
            if 1 < length < degenerate_number + variation:
                pool.extend(dist_by_len[length])
                for d in dist_by_len[length]:
                    elements = elements.union(set(d))
        if len(elements) > degenerate_number:
            for comb in itertools.combinations(elements,
                                               degenerate_number - 1):
                comb_set = set(comb)
                count = 0
                for dist in pool:
                    if len(set(dist) - comb_set) <= variation:
                        count += dist_number["_".join(dist)]
                        if count == cover_number:
                            return max_count, comb
                if count > max_count:
                    max_count = count
                    max_subset = comb
        else:
            max_count = cover_number
            max_subset = elements
    return max_count, max_subset
