# Port of multiprime_tpu/solve/maxset.py: the off-target screen scans on ``device``.
"""Greedy minimal primer-set assembly (get_Maxprimerset equivalent).

Re-implements multiPrime/scripts/get_Maxprimerset.py with identical
outputs.  Two modes:

* ``maximal`` (method "T", :291-356) — walk clusters (fewest candidates
  first); take the first pair whose union with the accumulated primer set is
  dimer-free; clusters with no clean pair go to the ``.next.xls`` spill.
* ``maximum`` (:218-282) — same walk with backtracking to the previous
  cluster's next candidate on a dead end (reference semantics preserved,
  including the for/while pointer interplay).

Scaling note: the reference's ``dimer_examination`` rescans the *entire*
accumulated expansion set for every candidate pair — O(|set|^2 * ends) string
searches per step.  The union test is order-independent boolean, so we
evaluate it incrementally: a cached clean core set is only ever tested
against the candidate pair's additions (new x old, old x new, new x new).
Identical verdicts, linear instead of quadratic growth per step.  The batch
cross-correlation form of this test lives in multiprime_tpu.ops.dimer for
device-scale sets.
"""

from __future__ import annotations

import os
import re
import sys
from functools import lru_cache

from ..thermo import exact as thermo
from ..utils import iupac

COLUMNS = ["#Primer", "Primer_rank", "Primer_F", "Primer_R",
           "PCR_product (Length:Tm:Coverage)",
           "Coverage number with error in top N",
           "Primer position (representative sequence)"]


@lru_cache(maxsize=200000)
def suffix_ends(primer):
    """Expanded 3'-suffixes of length 5..len-1 (current_end,
    get_Maxprimerset.py:149-154).  Note: excludes the full-length suffix.
    Frozen + cached: callers only union it into their own sets."""
    out = []
    for a in range(5, len(primer)):
        out.extend(iupac.expand(primer[-a:]))
    return frozenset(out)


def _end_hits_primer(end, primer):
    """True if RC(end) occurs in primer with a dimer-worthy score
    (dimer_examination inner test, get_Maxprimerset.py:202-214)."""
    idx = primer.find(iupac.rc(end))
    if idx < 0:
        return False
    d2 = len(primer) - len(end) - idx
    loss = thermo.penalty_points(len(end), end.count("G") + end.count("C"),
                                 0, d2)
    if loss >= 3:
        return True
    return thermo.delta_g(end, both_ends=True) < -5 and d2 == 0


@lru_cache(maxsize=None)
def _maxset_loss_triggers(length, gc, d2):
    """penalty_points(length, gc, 0, d2) >= 3 — the dimer_examination loss
    gate on its tiny (len, gc, d2) domain."""
    return thermo.penalty_points(length, gc, 0, d2) >= 3


@lru_cache(maxsize=200000)
def _hit_end_set(primer):
    """All ends e with _end_hits_primer(e, primer) — every distinct
    substring of the (already expanded, pure ACGT) primer at its FIRST
    occurrence, rc'd, kept when the loss/dG verdict triggers.  Factoring
    the target side out of the pair loop turns the ledger's O(ends x core)
    string scans into set intersections (identical verdicts, fuzz-tested
    against _end_hits_primer)."""
    out = set()
    n = len(primer)
    first = {}
    for start in range(n):
        for ln in range(5, n - start + 1):
            s = primer[start:start + ln]
            if s not in first:
                first[s] = start
    gcpre = [0] * (n + 1)
    acc = 0
    for i, ch in enumerate(primer):
        if ch == "G" or ch == "C":
            acc += 1
        gcpre[i + 1] = acc
    for s, idx in first.items():
        ln = len(s)
        d2 = n - ln - idx
        if _maxset_loss_triggers(ln, gcpre[idx + ln] - gcpre[idx], d2):
            out.add(iupac.rc(s))
        elif d2 == 0:
            e = iupac.rc(s)
            if thermo.delta_g(e, both_ends=True) < -5:
                out.add(e)
    return frozenset(out)


class DimerLedger:
    """Incremental replacement for the reference's full-rescan
    dimer_examination.  Maintains the invariant that the accepted core set is
    internally clean, so testing a candidate pair only needs the pair's new
    expansions/ends against the core and themselves."""

    def __init__(self):
        self.core_primers = []      # accepted expanded primers
        self.core_ends = set()      # accepted expanded 3'-suffixes
        self.core_primers_set = set()
        self.core_hit_ends = set()  # ends that hit SOME core primer

    def pair_is_dimer(self, primer_f, primer_r):
        """Factored form: 'some end scans dirty against some primer' is a
        set intersection with the per-primer hit-end sets (_hit_end_set),
        maintained incrementally for the core.  Verdict-identical to the
        reference's rescan (see _pair_is_dimer_ref + fuzz test)."""
        ef = iupac.expand(primer_f)
        er = iupac.expand(primer_r)
        if len(ef) == 1 and len(er) == 1:
            # pure pair (the dominant case at scale): the union-set tests
            # decompose into pairwise isdisjoint calls over the cached
            # per-primer frozensets — no per-call set building.  The OR of
            # the decomposed tests is exactly the original verdict, and the
            # test ORDER preserves the original's laziness: most rejections
            # fire on the cheap suffix-vs-core-hit test before the O(n^2)
            # _hit_end_set of either primer is ever computed.
            ch = self.core_hit_ends
            sf = suffix_ends(primer_f)
            if not sf.isdisjoint(ch):
                return True
            if primer_f == primer_r:
                hf = _hit_end_set(primer_f)
                if not sf.isdisjoint(hf):
                    return True
                return primer_f not in self.core_primers_set \
                    and not self.core_ends.isdisjoint(hf)
            sr = suffix_ends(primer_r)
            if not sr.isdisjoint(ch):
                return True
            hf = _hit_end_set(primer_f)
            if not sf.isdisjoint(hf) or not sr.isdisjoint(hf):
                return True
            hr = _hit_end_set(primer_r)
            if not sf.isdisjoint(hr) or not sr.isdisjoint(hr):
                return True
            cs = self.core_primers_set
            ce = self.core_ends
            if primer_f not in cs and not ce.isdisjoint(hf):
                return True
            return primer_r not in cs and not ce.isdisjoint(hr)
        new_primers = list(dict.fromkeys(list(ef) + list(er)))
        new_set = set(new_primers)
        core_set = self.core_primers_set
        new_ends = set()
        for p in new_set:
            new_ends |= suffix_ends(p)
        # new ends vs core primers
        if not new_ends.isdisjoint(self.core_hit_ends):
            return True
        # new ends vs new primers
        for p in new_primers:
            if not new_ends.isdisjoint(_hit_end_set(p)):
                return True
        # core ends vs new primers (core vs core already proven clean)
        for p in new_primers:
            if p in core_set:
                continue
            if not self.core_ends.isdisjoint(_hit_end_set(p)):
                return True
        return False

    def _pair_is_dimer_ref(self, primer_f, primer_r):
        """The direct rescan formulation (parity oracle)."""
        new_primers = list(dict.fromkeys(
            list(iupac.expand(primer_f)) + list(iupac.expand(primer_r))))
        new_set = set(new_primers)
        core_set = self.core_primers_set
        new_ends = set()
        for p in new_set:
            new_ends |= suffix_ends(p)
        for end in new_ends:
            for p in self.core_primers:
                if _end_hits_primer(end, p):
                    return True
            for p in new_primers:
                if _end_hits_primer(end, p):
                    return True
        for end in self.core_ends:
            for p in new_primers:
                if p in core_set:
                    continue
                if _end_hits_primer(end, p):
                    return True
        return False

    def accept(self, primer_f, primer_r):
        for p in list(iupac.expand(primer_f)) + list(iupac.expand(primer_r)):
            if p not in self.core_primers_set:
                self.core_primers_set.add(p)
                self.core_primers.append(p)
                self.core_ends |= suffix_ends(p)
                self.core_hit_ends |= _hit_end_set(p)

    def snapshot(self):
        """O(1): the accepted-expansion list is append-only, so a prefix
        length fully determines the ledger state (the derived sets rebuild
        from cached per-primer sets on restore — greedy_maximum keeps one
        snapshot per accepted row, so copies of the large hit-end union
        would be quadratic)."""
        return len(self.core_primers)

    def restore(self, snap):
        self.core_primers = self.core_primers[:snap]
        self.core_primers_set = set(self.core_primers)
        ends = set()
        hit_ends = set()
        for p in self.core_primers:
            ends |= suffix_ends(p)
            hit_ends |= _hit_end_set(p)
        self.core_ends = ends
        self.core_hit_ends = hit_ends


_TABRUN = re.compile("\t{2,}")


class _LazyRow:
    """A candidate row that splits its fields incrementally.

    ``list(filter(None, line.strip().split("\t")))`` materialises every
    field eagerly — 53.6 s and ~5.8 GB of small strings for the 100k run's
    1.2 GB aggregate (4096 rows × ~30k fields), almost all of it dead
    weight: the greedy solvers read only a short prefix of most rows.
    The normalised form (strip + collapse tab runs) is field-for-field
    identical to the filtered split — fields cannot contain tabs — so
    ``len`` is a tab count, the sort sidecar can write the normalised
    string verbatim, and ``row[i]`` tokenises just far enough to serve i.
    Equivalence is pinned by tests/test_solve_golden.py."""

    __slots__ = ("norm", "_fields", "_pos", "_n")

    def __init__(self, norm):
        self.norm = norm
        self._fields = []
        self._pos = 0 if norm else None      # None = fully tokenised
        self._n = (norm.count("\t") + 1) if norm else 0

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        f = self._fields
        if not 0 <= i < self._n:
            raise IndexError(i)
        while len(f) <= i:
            j = self.norm.find("\t", self._pos)
            if j < 0:
                f.append(self.norm[self._pos:])
                self._pos = None
            else:
                f.append(self.norm[self._pos:j])
                self._pos = j + 1
        return f[i]

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def pair(self, i):
        """(self[i], self[i+1]) in one call — the greedy walks read rows
        exclusively as adjacent F/R pairs, so this halves the per-access
        method dispatch on the hot loop."""
        self[i + 1]
        f = self._fields
        return f[i], f[i + 1]


def _row_pair(row, i):
    return row.pair(i) if isinstance(row, _LazyRow) else (row[i], row[i + 1])


def _row_text(row):
    """The row's tab-joined text — free for _LazyRow (its normalised
    string IS that text), computed for plain lists (tests / direct API)."""
    return row.norm if isinstance(row, _LazyRow) else "\t".join(row)


class RowStore:
    """File-backed candidate rows for huge aggregates.

    The 1M-envelope run's candidate_primers_sets.txt is 12.8 GB; holding
    every normalised row as a Python string put ~18 GB on the solve's RSS
    (26 GB peak) which every later forked stage then inherited.  Rows are
    served straight from the (already normalised, already sorted) sort
    sidecar by byte offset — one fresh _LazyRow per access, with a tiny
    LRU so greedy_maximal's per-row accesses and greedy_maximum's
    backtracking re-reads keep O(1) rows resident."""

    _LRU = 4

    def __init__(self, path, offsets, lengths):
        self._f = open(path, "rb")
        self._offsets = offsets
        self._lengths = lengths
        self._cache = {}            # insertion-ordered: oldest evicted

    def __len__(self):
        return len(self._offsets)

    def __getitem__(self, i):
        if not 0 <= i < len(self._offsets):
            raise IndexError(i)
        row = self._cache.get(i)
        if row is None:
            self._f.seek(self._offsets[i])
            row = _LazyRow(self._f.read(self._lengths[i]).decode())
            self._cache[i] = row
            if len(self._cache) > self._LRU:
                del self._cache[next(iter(self._cache))]
        return row

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _norm_row(line):
    line = line.strip()
    # collapse tab runs only when one exists: the C substring probe
    # replaces a full regex scan per row (11.4 s of the 100k parse)
    return line if "\t\t" not in line else _TABRUN.sub("\t", line)


def parse_and_sort(infile, sort_file):
    """Read candidate rows, sort by candidate count ascending (stable), and
    write the sort.<name> sidecar (get_Maxprimerset.py:363-371).

    Above MPTPU_SOLVE_ROWSTORE_BYTES (default 2 GB) the rows are not
    materialised: one streaming pass records each row's field count and
    byte span, the sort sidecar is written by streaming rows in sorted
    order, and a RowStore serving rows from that sidecar is returned —
    same ordering (stable ascending field count) and byte-identical
    outputs (tests/test_solve_golden.py::test_rowstore_equivalence)."""
    limit = int(os.environ.get("MPTPU_SOLVE_ROWSTORE_BYTES", 2 << 30))
    if os.path.getsize(infile) < limit:
        with open(infile) as f:
            primers = sorted([_LazyRow(_norm_row(line)) for line in f],
                             key=len)
        with open(sort_file, "w") as f:
            for row in primers:
                f.write(row.norm + "\n")
        return primers
    counts, spans = [], []
    with open(infile, "rb") as f:
        off = 0
        for raw in f:
            norm = _norm_row(raw.decode())
            counts.append(norm.count("\t") + 1)
            spans.append((off, len(raw)))
            off += len(raw)
    order = sorted(range(len(counts)), key=counts.__getitem__)
    offsets, lengths = [], []
    pos = 0
    with open(infile, "rb") as src, open(sort_file, "wb") as out:
        for i in order:
            o, ln = spans[i]
            src.seek(o)
            norm = _norm_row(src.read(ln).decode()).encode()
            out.write(norm + b"\n")
            offsets.append(pos)
            lengths.append(len(norm))
            pos += len(norm) + 1
    return RowStore(sort_file, offsets, lengths)


def _write_tsv(rows, output):
    """pandas.to_csv(sep='\\t', index=False) equivalent: empty string for
    missing cells."""
    with open(output, "w") as f:
        f.write("\t".join(COLUMNS) + "\n")
        for row in rows:
            f.write("\t".join(str(row.get(c, "")) for c in COLUMNS) + "\n")


def greedy_maximal(primers, output, next_candidate_file, step=5):
    """Maximal mode (get_Maxprimerset.py:291-356)."""
    ledger = DimerLedger()
    clique = []
    row_pointer, column_pointer = 0, 1
    with open(next_candidate_file, "w") as next_f:
        while row_pointer < len(primers):
            row = primers[row_pointer]
            if len(row) <= 1:
                print("Non primers: virus {} missing!".format(row[0]))
                next_f.write(_row_text(row) + "\n")
                row_pointer += 1
                column_pointer = 1
                continue
            while column_pointer <= len(row) - step:
                pf, pr = _row_pair(row, column_pointer)
                if ledger.pair_is_dimer(pf, pr):
                    column_pointer += step
                    if column_pointer > len(row) - step:
                        clique.append({"#Primer": row[0]})
                        print("virus {} missing!".format(row[0]))
                        next_f.write(_row_text(row) + "\n")
                        row_pointer += 1
                        column_pointer = 1
                        break
                else:
                    clique.append({
                        "#Primer": row[0],
                        "Primer_rank": str(column_pointer),
                        "Primer_F": row[column_pointer],
                        "Primer_R": row[column_pointer + 1],
                        COLUMNS[4]: row[column_pointer + 2],
                        COLUMNS[5]: row[column_pointer + 3],
                        COLUMNS[6]: row[column_pointer + 4],
                    })
                    ledger.accept(row[column_pointer], row[column_pointer + 1])
                    row_pointer += 1
                    column_pointer = 1
                    break
    _write_tsv(clique, output)
    return clique


def greedy_maximal_with_offtarget(primers, output, next_candidate_file,
                                  background_fa, step=5, mm=1, term=4,
                                  product_size=(50, 2000), device="cuda"):
    """Maximal mode with an in-loop off-target screen — the abandoned-but-
    intended extension of get_Maxprimerset_V3.py:300-645: a candidate pair is
    also rejected when it predicts an amplicon on a background database.

    The background scans run on ``device`` (default cuda; raises without a
    GPU); the background is encoded and uploaded once, not once a pair.
    """
    from ..utils import link as linkmod
    from ..validate import scan as vscan

    dev = linkmod.resolve_device(device)
    gene_ids, bg_seqs = vscan.parse_fasta(background_fa)
    params = vscan.ScanParams(term=term, mm=mm, product_size=product_size)
    cache = {}

    def off_target(primer_f, primer_r):
        key = (primer_f, primer_r)
        if key in cache:
            return cache[key]
        from ..utils import iupac
        f_pats = list(iupac.expand(primer_f))
        r_pats = [iupac.rc(e) for e in iupac.expand(primer_r)]
        f_hits = vscan.scan_hits(bg_seqs, f_pats, params, dev)
        r_hits = vscan.scan_hits(bg_seqs, r_pats, params, dev)
        rows = vscan.pcr_join(gene_ids, f_hits, r_hits,
                              ["F"] * len(f_pats) + ["R"] * len(r_pats),
                              product_size)
        cache[key] = bool(rows)
        return cache[key]

    ledger = DimerLedger()
    clique = []
    row_pointer, column_pointer = 0, 1
    with vscan.shared_corpus(params), open(next_candidate_file, "w") \
            as next_f:
        while row_pointer < len(primers):
            row = primers[row_pointer]
            if len(row) <= 1:
                next_f.write(_row_text(row) + "\n")
                row_pointer += 1
                column_pointer = 1
                continue
            while column_pointer <= len(row) - step:
                bad = ledger.pair_is_dimer(row[column_pointer],
                                           row[column_pointer + 1]) \
                    or off_target(row[column_pointer],
                                  row[column_pointer + 1])
                if bad:
                    column_pointer += step
                    if column_pointer > len(row) - step:
                        clique.append({"#Primer": row[0]})
                        next_f.write(_row_text(row) + "\n")
                        row_pointer += 1
                        column_pointer = 1
                        break
                else:
                    clique.append({
                        "#Primer": row[0],
                        "Primer_rank": str(column_pointer),
                        "Primer_F": row[column_pointer],
                        "Primer_R": row[column_pointer + 1],
                        COLUMNS[4]: row[column_pointer + 2],
                        COLUMNS[5]: row[column_pointer + 3],
                        COLUMNS[6]: row[column_pointer + 4],
                    })
                    ledger.accept(row[column_pointer], row[column_pointer + 1])
                    row_pointer += 1
                    column_pointer = 1
                    break
    _write_tsv(clique, output)
    return clique


def greedy_maximum(primers, output, step=5):
    """Maximum mode with backtracking (get_Maxprimerset.py:218-282).

    The reference iterates ``for row_pointer in range(row_num)`` while the
    backtrack helper mutates ``row_pointer``/``column_pointer`` — the for
    target is reassigned each iteration, so a backtrack only replays rows
    within the current iteration's while loop.  Replicated as-is.
    """
    ledger = DimerLedger()
    clique = []
    snapshots = {}
    jdict = {}
    blank_row = 0
    column_pointer = 1

    for loop_row in range(len(primers)):
        row_pointer = loop_row
        row = primers[row_pointer]
        if len(row) <= 1:
            blank_row += 1
            continue
        while column_pointer <= len(primers[row_pointer]) - step:
            row = primers[row_pointer]
            if ledger.pair_is_dimer(row[column_pointer],
                                    row[column_pointer + 1]):
                column_pointer += step
                # backtrack_to_previous_row
                while column_pointer > len(primers[row_pointer]) - step:
                    row_pointer -= 1
                    if row_pointer < blank_row:
                        print("Non maximum primer set. "
                              "Try maximal primer set!")
                        sys.exit(1)
                    column_pointer = jdict[row_pointer] + step
                    ledger.restore(snapshots[row_pointer])
                    clique.pop()
            else:
                snapshots[row_pointer] = ledger.snapshot()
                clique.append({
                    "#Primer": row[0],
                    "Primer_rank": str(column_pointer),
                    "Primer_F": row[column_pointer],
                    "Primer_R": row[column_pointer + 1],
                    COLUMNS[4]: row[column_pointer + 2],
                    COLUMNS[5]: row[column_pointer + 3],
                    COLUMNS[6]: row[column_pointer + 4],
                })
                ledger.accept(row[column_pointer], row[column_pointer + 1])
                jdict[row_pointer] = column_pointer
                column_pointer = 1
                break
    _write_tsv(clique, output)
    return clique
