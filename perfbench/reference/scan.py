"""Plain reference of the mismatch scan and the F x R join behind the
port's coverage (``scan``, rule 19 of ``run``) and ``specificity`` rows.

The semantics are those of multiPrime's primer_coverage_validation_by_BWT.py
and primer_specificity.py as the port states them:

* a primer file's 3' ``term_len``-mers are its keys; a key's label is the
  ``_``-joined names of the primers that share it.  Where no expansion of
  a degenerate key is shared with another key, the keys are scanned as
  masks; otherwise every expansion is scanned under a merged id
  (get_term, :205-240);
* a hit is a window of a target in which at most ``mm`` positions hold a
  base outside the key's code and the last ``term`` positions hold none;
  a target base other than A, C, G, T matches nothing.  Reverse hits are
  hits of the key's reverse complement, its suffix rule applied to the
  scanned pattern as it is;
* per target, each F position x each R position whose product length
  lies strictly inside the product window gives a row; a later pattern
  at one position overwrites an earlier one; the non-exhaustive join
  abandons a target at the first start with an empty window (:303-342).

The scan is a product of one-hot windows with one-hot patterns, in
float16 on a card and float32 elsewhere (every count is an integer of at
most plen, exact in either), a block of windows at a time.
"""

import re
from bisect import bisect_left

import numpy as np
import torch

from . import iupac

HEADER = "\t".join(["Chrom (or Genes)", "Start", "Stop", "Primer_F",
                    "Primer_R", "Product length"])


def read_fasta(path):
    """-> [(id, sequence)], the id the first word of the header line."""
    out, name, parts = [], None, []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(parts)))
                name, parts = line[1:].strip().split(" ")[0], []
            else:
                parts.append(line.strip().upper())
    if name is not None:
        out.append((name, "".join(parts)))
    return out


def read_primers(path):
    """A primer FASTA of one line a sequence -> [(name, sequence)]."""
    out, name = [], None
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                name = line.strip().lstrip(">")
            else:
                out.append((name, line.strip()))
    return out


def patterns_and_labels(primers, term_len):
    """[(name, seq)] -> (patterns, labels) as the scan sees them."""
    by_key = {}
    for name, seq in primers:
        key = seq if term_len == 0 else seq[-term_len:]
        by_key.setdefault(key, []).append(name)
    by_expansion = {}
    for key, names in by_key.items():
        merged = "_".join(dict.fromkeys(names))
        expansions = iupac.expand(key)
        if len(expansions) > 1:
            for j, e in enumerate(expansions):
                by_expansion.setdefault(e, []).append(merged + "_" + str(j))
        else:
            by_expansion.setdefault(key, []).append(merged + "_0")
    if any(len(ids) > 1 for ids in by_expansion.values()):
        return (list(by_expansion),
                [re.split(r"_\d+$", "_".join(ids))[0]
                 for ids in by_expansion.values()])
    return (list(by_key),
            [re.split(r"_\d+$", "_".join(dict.fromkeys(names)) + "_0")[0]
             for names in by_key.values()])


class Targets:
    """Target sequences as one flat one-hot stream on ``device``, with the
    window starts that lie inside a target."""

    def __init__(self, seqs, device):
        self.device = torch.device(device)
        self.lengths = np.array([len(s) for s in seqs], np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.lengths)])
        flat = np.frombuffer("".join(seqs).encode("ascii"), np.uint8)
        codes = torch.from_numpy(iupac.ASCII_TO_BASE[flat].astype(np.int64))
        # float16 on a card; float32 elsewhere, where float16 products are
        # slow or missing
        self.dtype = (torch.float16 if self.device.type == "cuda"
                      else torch.float32)
        onehot = torch.zeros((len(flat), 5), dtype=self.dtype)
        onehot[torch.arange(len(flat)), codes] = 1
        # column 4 (not a base) is dropped: it matches nothing
        self.onehot = onehot[:, :4].contiguous().to(self.device)
        self.total = len(flat)


def _pattern_weights(patterns, plen, term, device, dtype):
    """-> (all positions [plen * 4, P], the last ``term`` [plen * 4, P]),
    one-hot columns of each pattern's codes."""
    masks = np.stack([iupac.ASCII_TO_MASK[np.frombuffer(p.encode("ascii"),
                                                         np.uint8)]
                      for p in patterns]).astype(np.int64)   # [P, plen]
    bits = (masks[:, :, None] >> np.arange(4)) & 1              # [P, plen, 4]
    full = bits.reshape(len(patterns), plen * 4).T
    suffix = bits.copy()
    suffix[:, :plen - term] = 0
    suffix = suffix.reshape(len(patterns), plen * 4).T
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
        device=device, dtype=dtype)
    return to(full), to(suffix)


def scan(targets, patterns, *, mm, term):
    """-> int64 arrays (target, position, pattern) of every hit, ordered by
    target, position, pattern.  Every pattern has one length."""
    if not patterns:
        return (np.zeros(0, np.int64),) * 3
    plen = len(patterns[0])
    if any(len(p) != plen for p in patterns):
        raise ValueError("patterns of one length only")
    term = max(int(term), 0)
    full_w, suffix_w = _pattern_weights(patterns, plen, term, targets.device,
                                        targets.dtype)
    n_win = targets.total - plen + 1
    # windows a block: its product holds at most 2**30 counts
    block = max(1 << 16, min(1 << 22, (1 << 30) // len(patterns)))
    seqs, poss, pats = [], [], []
    for lo in range(0, max(n_win, 0), block):
        hi = min(lo + block, n_win)
        win = targets.onehot[lo:hi + plen - 1].unfold(0, plen, 1)  # [w,4,plen]
        win = win.transpose(1, 2).reshape(hi - lo, plen * 4)
        matches = win @ full_w
        hit = matches >= plen - mm
        if term > 0:
            hit &= (win @ suffix_w) >= term
        w, p = torch.nonzero(hit, as_tuple=True)
        if not len(w):
            continue
        flat = w.cpu().numpy() + lo
        seq = np.searchsorted(targets.starts, flat, side="right") - 1
        pos = flat - targets.starts[seq]
        inside = pos + plen <= targets.lengths[seq]
        seqs.append(seq[inside])
        poss.append(pos[inside])
        pats.append(p.cpu().numpy()[inside])
    if not seqs:
        return (np.zeros(0, np.int64),) * 3
    seq, pos, pat = (np.concatenate(a) for a in (seqs, poss, pats))
    order = np.lexsort((pat, pos, seq))
    return seq[order], pos[order], pat[order]


def _closest(sorted_list, lo_val, hi_val):
    left = bisect_left(sorted_list, lo_val)
    if hi_val > sorted_list[-1]:
        right = len(sorted_list) - 1
    else:
        right = bisect_left(sorted_list, hi_val) - 1
    return left, right


def join(gene_ids, f_hits, r_hits, labels, product_size, exhaustive):
    """Per-target F x R join of the hit arrays -> rows (gene, start, stop,
    F label, R label, length)."""
    lo, hi = int(product_size[0]), int(product_size[1])
    f_by, r_by = {}, {}
    for by, (seq, pos, pat) in ((f_by, f_hits), (r_by, r_hits)):
        for s, o, p in zip(seq.tolist(), pos.tolist(), pat.tolist()):
            by.setdefault(s, {})[o] = labels[p]
    rows = []
    for s in sorted(set(f_by) & set(r_by)):
        primer_f, primer_r = f_by[s], r_by[s]
        starts, stops = sorted(primer_f), sorted(primer_r)
        if stops[0] - starts[-1] > hi or stops[-1] - starts[0] < lo:
            continue
        for start in starts:
            i0, i1 = _closest(stops, start + lo, start + hi)
            if i0 > i1:
                if not exhaustive or i0 >= len(stops):
                    break
                continue
            for stop in stops[i0:i1 + 1]:
                distance = stop - start + 1
                if distance > hi:
                    break
                if lo < distance < hi:
                    rows.append((gene_ids[s], start, stop, primer_f[start],
                                 primer_r[stop], distance))
    return rows


def predicted_rows(primers, gene_ids, targets, *, term_len, term, mm,
                   product_size, exhaustive):
    """The rows of a primer set against the targets, as text lines."""
    patterns, labels = patterns_and_labels(primers, term_len)
    # the scan takes one pattern length at a time, as the program groups
    # them; hits of each group keep their order within the group
    lengths = sorted({len(p) for p in patterns})
    f_parts, r_parts = [], []
    for plen in lengths:
        idx = [i for i, p in enumerate(patterns) if len(p) == plen]
        for parts, pats in ((f_parts, [patterns[i] for i in idx]),
                            (r_parts, [iupac.rc(patterns[i]) for i in idx])):
            seq, pos, pat = scan(targets, pats, mm=mm, term=term)
            parts.append((seq, pos, np.asarray(idx, np.int64)[pat]))
    f_hits, r_hits = (tuple(np.concatenate([p[k] for p in parts])
                            for k in range(3)) for parts in (f_parts, r_parts))
    rows = join(gene_ids, f_hits, r_hits, labels, product_size, exhaustive)
    return ["\t".join(map(str, row)) for row in rows]


def read_rows(path):
    """The rows of a program's .out file, header dropped, as text lines."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines or lines[0] != HEADER:
        raise ValueError("%s: no row header" % path)
    return lines[1:]


def rows_differing(got, want):
    """Lines at which two row lists differ, the longer's surplus counted."""
    return (sum(a != b for a, b in zip(got, want))
            + abs(len(got) - len(want)))
