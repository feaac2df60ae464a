# Copied from multiprime_tpu/validate/ont.py (host code, no JAX).
"""ONT read primer classification (FindONTprimerV3 equivalent).

Classifies each read's head/tail primer-length k-mer against the expanded
primer set (both strands): best similarity above a threshold assigns the
read end to that primer (FindONTprimerV3.py:126-276).  The reference scores
with difflib.SequenceMatcher.ratio; ``metric="difflib"`` reproduces that
exactly, ``metric="banded"`` uses the banded match-maximising alignment
(2*matches/(len_a+len_b), the same quantity difflib approximates).

Measured at 292 expansions on 2 cores: difflib 77 ends/s; banded via the
packed native batch (`_PackedExpansion`, one ctypes call scoring all
candidates) 4,186 ends/s — 54x.  A naive per-candidate banded loop is
*slower* than difflib (4 ends/s: ctypes + re-encode per call dominate),
which is why ``run`` always uses the packed path when the native library
is present.  Output: per-(F,R) sorted label-pair counts (<out>.num).
"""

from __future__ import annotations

import difflib
import gzip

import numpy as np

from ..cluster.greedy import _encode, banded_identity
from ..utils import iupac


def expand_primer_set(primer_fa, expand_fa_out=None):
    """-> {expanded_or_rc_seq: label}; labels '<header> | j' like the
    reference's expand fasta (FindONTprimerV3.py:166-179)."""
    expand = {}
    lines = []
    with open(primer_fa) as f:
        header = None
        for line in f:
            if line.startswith(">"):
                header = line.strip()
            elif line.strip():
                for j, e in enumerate(iupac.expand(line.strip())):
                    label = header + " | " + str(j)
                    lines.append((label, e))
                    expand[e] = label
                    expand[iupac.rc(e)] = label
    if expand_fa_out:
        with open(expand_fa_out, "w") as f:
            for label, e in lines:
                f.write(label + "\n" + e + "\n")
    return expand


def _similarity(a, b, metric):
    if metric == "difflib":
        return round(difflib.SequenceMatcher(None, a, b).ratio(), 2)
    matches = banded_identity(_encode(a), _encode(b), band=8) * min(len(a),
                                                                   len(b))
    return round(2 * matches / (len(a) + len(b)), 2)


class _PackedExpansion:
    """Pre-encoded expansion set for the native banded batch path: one
    ctypes call scores a read end against every candidate (vs the per-
    candidate Python loop), with the same first-wins strictly-greater
    selection order as ``classify_end``."""

    def __init__(self, expand_dict):
        self.labels = list(expand_dict.values())
        cands = list(expand_dict.keys())
        self.lens = np.array([len(c) for c in cands], np.int64)
        self.offsets = np.zeros(len(cands) + 1, np.int64)
        np.cumsum(self.lens, out=self.offsets[1:])
        self.buf = np.empty(max(int(self.offsets[-1]), 1), np.int8)
        for i, c in enumerate(cands):
            self.buf[self.offsets[i]:self.offsets[i + 1]] = _encode(c)

    def classify(self, seq, min_ident, report_variant, lib, band=8):
        q = _encode(seq)
        n = len(self.labels)
        out = np.empty(n, np.float64)
        lib.banded_identity_batch(
            q.ctypes.data, len(q), self.buf.ctypes.data,
            self.offsets.ctypes.data, n, band, out.ctypes.data)
        # identical arithmetic to _similarity(metric="banded")
        la = len(seq)
        scores = np.round(2 * out * np.minimum(la, self.lens)
                          / (la + self.lens), 2)
        bi = int(np.argmax(scores))          # first maximum = first-wins
        if scores[bi] <= min_ident:
            return "NA"
        label = self.labels[bi]
        return label if report_variant else label.split(" | ")[0]


def classify_end(seq, expand_dict, min_ident, metric="difflib",
                 report_variant=False):
    """Best-matching primer label for a read end.  With report_variant=True
    the full '<header> | j' expansion label is returned
    (FindONTexpandprimer.py behaviour) instead of the primer name."""
    best_label, best = "NA", -1.0
    for cand, label in expand_dict.items():
        r = _similarity(seq, cand, metric)
        if r > best:
            best = r
            best_label = label if report_variant else label.split(" | ")[0]
    return best_label if best > min_ident else "NA"


def iter_reads(path, fmt="fq"):
    """Yield read lines.  Quirk kept from the reference
    (FindONTprimerV3.py:210-244): gzipped inputs are stripped, plain-text
    inputs are NOT — the tail k-mer of a plain read includes the newline."""
    step = 4 if fmt == "fq" else 2
    if path.endswith("gz"):
        with gzip.open(path, "rt") as f:
            for idx, line in enumerate(f):
                if idx % step == 1:
                    yield line.strip()
    else:
        with open(path) as f:
            for idx, line in enumerate(f):
                if idx % step == 1:
                    yield line


def run(read_file, primer_fa, outfile, primer_len=18, min_ident=0.8,
        fmt="fq", metric="difflib", report_variant=False):
    # .strip("fa") (NOT rstrip of ".fa") reproduces the reference's own
    # path quirk byte-for-byte (FindONTprimerV3.py:168)
    expand = expand_primer_set(primer_fa,
                               primer_fa.strip("fa") + "expand.fa")
    lib = None
    if metric == "banded":
        from .. import native
        lib = native.load()
    if lib is not None:
        packed = _PackedExpansion(expand)

        def _classify(seq):
            return packed.classify(seq, min_ident, report_variant, lib)
    else:
        def _classify(seq):
            return classify_end(seq, expand, min_ident, metric,
                                report_variant)
    counts = {}
    for read in iter_reads(read_file, fmt):
        head = read[:primer_len]
        tail = read[-primer_len:]
        pair = sorted([_classify(head), _classify(tail)])
        key = "\t".join(pair)
        counts[key] = counts.get(key, 0) + 1
    with open(outfile + ".num", "w") as fo:
        fo.write("Primer_F\tPrimer_R\tNumber\n")
        for key, n in sorted(counts.items(), key=lambda x: x[1],
                             reverse=True):
            fo.write(key + "\t" + str(n) + "\n")
    return counts
