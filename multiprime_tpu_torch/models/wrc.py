# Copied from multiprime_tpu/models/wrc.py (host code, no JAX).
"""DEGEPRIME backend (multi-DegePrime pipeline): TrimAlignment + WRC design.

The multi-DegePrime pipeline (multi-DegePrime.py:154-228) trims an MSA with
TrimAlignment.pl (run with DEFAULT arguments, i.e. min-occupancy 0: only the
case/U->T/ID normalisation matters), designs per-window degenerate primers
with DegePrime.pl's Weighted Randomised Combination search, then pairs with
get_degePrimer.py.

``trim_alignment`` reproduces TrimAlignment.pl exactly (byte-identical
output, verified by a live shadow run of the Perl script):

* occupancy gates (TrimAlignment.pl get_rich_positions): keep column i iff
  trailing('.')/total <= max_trailing AND
  (non_gap - trailing)/(total - trailing) >= min_occupancy;
  with -trailgap the '.'s are first turned into '-'s;
* output normalisation (get_short_seqs): uppercase, then U->T; a kept base
  is LOWERCASED when any word character (letter) occupies the dropped
  columns between it and the next kept column — the marker DegePrime uses
  to reject windows spanning removed regions; the LAST kept column is never
  lowercased; IDs are the first whitespace token of the header.

``design_windows`` reproduces DegePrime.pl's per-window bookkeeping
(DegePrime.pl:139-251): skip_length=20 ends are excluded via per-sequence
first/last word-character positions, a window's mers take part only when the
sequence spans [pos-skip, pos+len-1+skip], the LAST mer character is
uppercased (DegePrime.pl:228) so a trailing removed-region marker does not
disqualify a mer, mers with any non-ACGT character are excluded from the
ranking (but still count for NumberSpanning and the entropy), and a row is
emitted when zero-gap mers >= min_depth.  Output columns match:
Pos NumberSpanning UniqueMers Entropy PrimerDeg PrimerSeq NumberMatching
FractionMatching, floats in Perl's %.15g stringification.

The WRC search itself (DegePrime.pl:253-340) draws mers weighted by their
counts without replacement, unions their bases per position while the
degeneracy stays <= max_deg, and keeps the best-matching union over
``iterations`` randomised restarts.  The Perl original is UNSEEDED (not
self-reproducible run-to-run), so bit-parity is undefined; ours is a seeded
NumPy equivalent of the same procedure (including the <=100 unique draws
cap and the exact-degeneracy early stop), which makes runs reproducible.
max_deg is first reduced to the nearest valid degeneracy 2^a*3^b
(check_max_deg, DegePrime.pl:120-137).
"""

from __future__ import annotations

import numpy as np

from ..utils import iupac

_WORD = set("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789_")


def _fmt(x):
    """Perl default number stringification ("%.15g" for floats)."""
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    s = "%.15g" % x
    return s


def read_fasta_raw(path):
    """Raw fasta -> (ids, rows) preserving case/U/'.' (TrimAlignment.pl
    reads the alignment verbatim; whitespace inside sequences is stripped,
    IDs are the first whitespace token after '>')."""
    ids, rows, cur = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    rows.append("".join(cur))
                    cur = []
                ids.append(line[1:].split()[0] if line[1:].split() else "")
            else:
                cur.append("".join(line.split()))
    if cur:
        rows.append("".join(cur))
    return ids, rows


def trim_alignment(rows, min_occupancy=0.0, max_trailing=1.0,
                   trailgap=False):
    """TrimAlignment.pl on aligned rows -> (trimmed rows, kept columns).

    rows: list of equal-length aligned strings (raw case, may contain U/u
    and '.' trailing characters).  Returns the trimmed strings WITH the
    reference's lowercase removed-region markers, plus the kept original
    column indices.
    """
    if not rows:
        return [], np.zeros(0, np.int64)
    lengths = {len(r) for r in rows}
    if len(lengths) > 1:
        raise ValueError("Aligned sequences have different lengths")
    mat = np.array([list(r) for r in rows])
    if trailgap:
        mat = np.where(mat == ".", "-", mat)
    total = len(rows)
    non_gap = (mat != "-").sum(axis=0)
    trailing = (mat == ".").sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        occ = (non_gap - trailing) / np.maximum(total - trailing, 1)
    keep = np.nonzero((trailing / total <= max_trailing)
                      & (occ >= min_occupancy))[0]
    up = np.char.upper(mat.astype("U1"))
    up = np.where(up == "U", "T", up)
    if len(keep) and np.all(np.diff(keep) == 1):
        # fast path (the pipeline's default min_occupancy=0 keeps every
        # column): no dropped columns between kept ones, so no lowercase
        # marker can ever fire — emit the normalised columns directly
        sub = up[:, keep]
        return ["".join(r) for r in sub], keep
    trimmed = []
    for r in range(total):
        seq = up[r]
        out = []
        for i in range(len(keep) - 1):
            nt = seq[keep[i]]
            between = seq[keep[i] + 1:keep[i + 1]]
            if any(ch in _WORD for ch in between):
                nt = nt.lower()
            out.append(nt)
        if len(keep):
            out.append(seq[keep[-1]])
        trimmed.append("".join(out))
    return trimmed, keep


def write_trimmed(rows, ids, outfile, **kw):
    """TrimAlignment.pl -i/-o equivalent: fasta in-memory rows -> file in
    the reference's exact format (">first_token\\nseq\\n")."""
    trimmed, keep = trim_alignment(rows, **kw)
    with open(outfile, "w") as f:
        for rid, seq in zip(ids, trimmed):
            f.write(">%s\n%s\n" % (rid.lstrip(">").split()[0], seq))
    return keep


def check_max_deg(max_deg):
    """Reduce to the nearest valid degeneracy 2^a*3^b
    (DegePrime.pl:120-137)."""
    def ok(a):
        while a % 2 == 0:
            a //= 2
        while a % 3 == 0:
            a //= 3
        return a == 1
    while max_deg > 1 and not ok(max_deg):
        max_deg -= 1
    return max_deg


def wrc_window(mers, counts, max_deg=96, iterations=100, seed=0):
    """Best degenerate primer for one window's zero-gap mer ranking.

    mers: list of equal-length ACGT strings; counts: occurrence counts.
    -> (degeneracy, degenerate primer, matching count); ("", "", 0) when no
    draw ever matched (DegePrime.pl's $bestdeg/$bestprimer stay empty).
    """
    if not mers:
        return "", "", 0
    plen = len(mers[0])
    k = len(mers)
    masks = np.stack([iupac.seq_to_masks(m) for m in mers])    # [K, plen]
    counts = np.asarray(counts, np.int64)
    rng = np.random.default_rng(seed)
    weights = counts / counts.sum()
    max_draws = min(k, 100)                   # trial cap, DegePrime.pl:282
    # all restarts at once: Efraimidis–Spirakis keys give every iteration a
    # weighted-without-replacement draw order in one vectorised shot
    keys = rng.random((iterations, k)) ** (1.0 / weights)
    order = np.argsort(-keys, axis=1)[:, :max_draws]   # [I, draws]
    unions = np.zeros((iterations, plen), np.uint8)
    degs = np.zeros(iterations, np.int64)
    stopped = np.zeros(iterations, bool)
    for t in range(max_draws):
        cand = unions | masks[order[:, t]]
        newdeg = np.prod(np.maximum(
            iupac.popcount4(cand).astype(np.int64), 1), axis=1)
        accept = (newdeg <= max_deg) & ~stopped
        unions = np.where(accept[:, None], cand, unions)
        degs = np.where(accept, newdeg, degs)
        stopped |= degs >= max_deg            # while (deg < max_deg)
    # matching per restart: mers whose bases are subsets of the union
    member = ((masks[None, :, :] & ~unions[:, None, :]) == 0).all(axis=2)
    matching = member @ counts                # [I]
    best = int(np.argmax(matching))           # first best, like the serial
    if matching[best] <= 0:                   # update's strict >
        return "", "", 0
    primer = "".join(iupac.MASK_TO_CHAR[int(m)] if m else "-"
                     for m in unions[best])
    return int(degs[best]), primer, int(matching[best])


def design_windows(rows, plen=18, max_deg=96, iterations=100,
                   seed=0, min_depth=1, skip_length=20):
    """DegePrime.pl over every window of a TRIMMED alignment.

    rows: trimmed aligned strings (may contain lowercase markers).
    -> list of output rows
    (pos, spanning, unique, entropy, deg, primer, matching, fraction)
    mirroring DegePrime.pl's 8 columns; rows below min_depth are omitted
    exactly like the reference.
    """
    max_deg = check_max_deg(max_deg)
    mat = np.array([list(r) for r in rows])
    n, length = mat.shape
    is_word = np.isin(mat, list(_WORD))
    # start/end: first and last word character per sequence
    # (check_lengths, DegePrime.pl:199-214: ^\W* / \W*$)
    any_word = is_word.any(axis=1)
    first = np.where(any_word, is_word.argmax(axis=1), length)
    last = np.where(any_word,
                    length - 1 - is_word[:, ::-1].argmax(axis=1), -1)
    out = []
    for pos in range(0, length - plen + 1):
        spanning = (first + skip_length <= pos) \
            & (last - skip_length >= pos + plen - 1)
        idx = np.nonzero(spanning)[0]
        total_spanning = len(idx)
        win = mat[idx, pos:pos + plen].copy()
        if win.size:
            win[:, -1] = np.char.upper(win[:, -1].astype("U1"))
        mers = ["".join(w) for w in win]
        # entropy over ALL spanning mers (DegePrime.pl:236-249)
        entropy = 0.0
        if total_spanning:
            _, cnt_all = np.unique(mers, return_counts=True)
            p = cnt_all / total_spanning
            entropy = float(-(p * np.log(p) / np.log(2)).sum())
        clean = [m for m in mers
                 if all(c in "ACGT" for c in m)]
        uniq, counts = (np.unique(clean, return_counts=True)
                        if clean else ([], []))
        zero_gaps = len(clean)
        if zero_gaps < min_depth:
            continue
        deg, primer, matching = wrc_window(
            list(uniq), counts, max_deg, iterations, seed + pos)
        fraction = matching / total_spanning if total_spanning else "NA"
        out.append((pos, total_spanning, len(uniq), entropy, deg, primer,
                    matching, fraction))
    return out


def write_design(table, outfile):
    """DegePrime.pl's exact output file format."""
    with open(outfile, "w") as f:
        f.write("Pos\tNumberSpanning\tUniqueMers\tEntropy\tPrimerDeg\t"
                "PrimerSeq\tNumberMatching\tFractionMatching\n")
        for (pos, spanning, uniq, entropy, deg, primer, matching,
             fraction) in table:
            f.write("%d\t%d\t%d\t%s\t%s\t%s\t%d\t%s\n" % (
                pos, spanning, uniq, _fmt(entropy),
                _fmt(deg) if deg != "" else "", primer, matching,
                _fmt(fraction) if fraction != "NA" else "NA"))
