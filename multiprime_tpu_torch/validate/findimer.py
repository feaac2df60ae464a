# Copied from multiprime_tpu/validate/findimer.py (host code, no JAX).
"""All-vs-all primer-dimer scan of a final set (finDimer equivalent).

Re-implements multiPrime/scripts/finDimer.py (class Dimer:127-280):
for each primer (by file order), its expanded 3'-ends (suffix lengths 5..18,
adaptor-extendable) are searched as reverse complements inside every primer at
or after it in the list; the first hit per (primer, other) pair is reported
with its Loss / dG verdict.

The reference's pool submits per-primer tasks whose result order is
non-deterministic at nproc>1; we run positions in ascending order, which is
identical to its nproc=1 behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..thermo import exact as thermo
from ..utils import iupac


@dataclass
class FinDimerParams:
    threshold: float = 3.96     # -t Loss threshold
    adaptor: str = ""
    nproc: int = 1


def parse_primer_fasta(path):
    """fasta -> {sequence: name} (finDimer.py:138-146; later names win when
    sequences repeat, replicated by plain dict assignment)."""
    primers = {}
    name = None
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                name = line.strip()
            else:
                primers[line.strip()] = name
    return primers


def current_end(primer, adaptor="", num=5, length=14):
    """Expanded 3'-end suffixes (finDimer.py:162-169)."""
    ext = adaptor + primer
    out = []
    for i in range(num, num + length):
        s = ext[-i:]
        if s:
            out.extend(iupac.expand(s))
    return out


def _substring_first_index(primers):
    """Global inverted index: substring -> [(primer_pos, expansion_order,
    first occurrence idx)], lengths 5..max.  One pass over all expansions;
    first-occurrence-only matches the reference's str.find semantics."""
    index = {}
    for pos, primer in enumerate(primers):
        for p_order, exp in enumerate(iupac.expand(primer)):
            n = len(exp)
            seen = {}
            for start in range(n):
                top = n - start
                for ln in range(5, top + 1):
                    sub = exp[start:start + ln]
                    if sub not in seen:
                        seen[sub] = start
            for sub, start in seen.items():
                index.setdefault(sub, []).append((pos, p_order, start))
    return index


def scan(primers, threshold=3.96, adaptor=""):
    """Dimer hit rows in the reference's sequential order (finDimer.py
    :191-224): for each primer (file order), walk every primer at or after
    it; the reported hit is the first (end, expansion) pair in
    longest-end-first / expansion order whose first occurrence triggers.

    Implemented over a global substring index, so cost scales with actual
    occurrences instead of |primers|^2 * |ends| string searches.
    """
    seqs = list(primers.keys())
    index = _substring_first_index(seqs)
    exp_lens = [
        [len(e) for e in iupac.expand(s)] for s in seqs]
    rows = []
    for pos, primer in enumerate(seqs):
        ends = sorted(current_end(primer, adaptor), key=len, reverse=True)
        # best (end_order, p_order) triggering pair per downstream primer
        best = {}
        for e_order, end in enumerate(ends):
            occurrences = index.get(iupac.rc(end))
            if not occurrences:
                continue
            gc = end.count("G") + end.count("C")
            dg = None
            for (other_pos, p_order, idx) in occurrences:
                if other_pos < pos:
                    continue
                key = other_pos
                if key in best and best[key][0] <= (e_order, p_order):
                    continue
                d2 = exp_lens[other_pos][p_order] - len(end) - idx
                loss = thermo.penalty_points(len(end), gc, 0, d2)
                if dg is None:
                    dg = thermo.delta_g(end, both_ends=True)
                if loss >= threshold or (dg < -5 and d2 == 0):
                    cand = ((e_order, p_order),
                            (primers[primer], primer, end, dg, len(end), 0,
                             gc, primers[seqs[other_pos]], seqs[other_pos],
                             d2, loss))
                    if key not in best or cand[0] < best[key][0]:
                        best[key] = cand
        for other_pos in range(pos, len(seqs)):
            if other_pos in best:
                rows.append(best[other_pos][1])
    return rows


HEADERS = ["Primer_ID", "Primer seq", "Primer end", "Delta G",
           "Primer end length", "End (distance 1)", "End (GC)",
           "Dimer-primer_ID", "Dimer-primer seq", "End (distance 2)", "Loss"]


def write_outputs(rows, outfile):
    """Main table + .dimer_num row-sum summary (finDimer.py:250-280)."""
    id_sum = {}
    dimer_sum = {}
    with open(outfile, "w") as fo:
        fo.write("\t".join(HEADERS) + "\n")
        for row in rows:
            id_sum[row[0]] = id_sum.get(row[0], 0) + 1
            dimer_sum[row[7]] = dimer_sum.get(row[7], 0) + 1
            fo.write("\t".join(map(str, row)) + "\n")
    with open(outfile + ".dimer_num", "w") as fo:
        fo.write("SeqName\tPrimer_ID\tDimer-primer_ID\tRowSum\n")
        for k in id_sum:
            p_id = id_sum[k]
            d_id = dimer_sum.get(k, 0)
            fo.write("\t".join(map(str, [k, p_id, d_id, p_id + d_id])) + "\n")
