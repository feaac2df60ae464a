# Copied from multiprime_tpu/models/mcdpd.py (host code, no JAX).
"""MC-DPD / MC-EDPD degenerate-primer design engine.

TPU-native re-design of the reference's ``NN_degenerate`` class
(multiPrime/scripts/multiPrime-core.py:342-1180) with identical output
semantics.  The computation is split into two stages:

* **Stage A (batched)** — window extraction with gap patching, per-window
  frequency/N-N transition tensors, entropy gates and batched Viterbi over
  *all* windows at once.  This stage is pure tensor algebra over a uint8
  IUPAC-mask matrix and has a JAX/TPU implementation
  (:mod:`multiprime_tpu.ops.design_scan`); the NumPy path here is the
  bit-exact reference used by tests and by CPU-only runs.

* **Stage B (host)** — the order-dependent greedy degeneracy refinement,
  mismatch-coverage bookkeeping and output formatting.  All arithmetic is
  integer or memoized-exact float, reproducing the reference's results
  bit-for-bit (including its aliasing and defaultdict-insertion quirks, see
  inline notes).

Window positions are independent, so Stage A shards naturally over a device
mesh (sequence axis -> psum of count tensors, window axis -> data parallel);
see multiprime_tpu.parallel.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from .. import native
from ..thermo import exact as thermo
from ..utils import iupac

BASES = ("A", "C", "G", "T")
_BASE2IDX = {"A": 0, "C": 1, "G": 2, "T": 3}
_MEMBER_COUNT = {ch: len(m) for ch, m in iupac.CODE_MEMBERS.items()}
_PURE_BYTES = np.frombuffer(b"ACGT-", np.uint8)
# byte -> "needs degenerate expansion" (anything outside ACGT-)
_IMPURE_TABLE = np.ones(256, dtype=bool)
_IMPURE_TABLE[_PURE_BYTES] = False


def _build_argsort4_desc():
    """np.argsort(vals)[::-1] for every 4-value tie pattern.

    The refinement loop's candidate order comes from np.argsort on
    4-element count vectors; its tie order is an implementation detail of
    NumPy's small-array sort (not stable), and the reference's output
    depends on it.  A comparison sort's permutation depends only on the
    dense-rank pattern of the inputs, so tabulating np.argsort itself over
    all rank patterns (4^4 representatives) reproduces it exactly without
    a per-call NumPy round-trip."""
    table = {}
    for vals in itertools.product(range(4), repeat=4):
        s = sorted(set(vals))
        key = (s.index(vals[0]), s.index(vals[1]),
               s.index(vals[2]), s.index(vals[3]))
        if key not in table:
            table[key] = tuple(
                int(i) for i in np.argsort(np.array(vals))[::-1])
    return table


_ARGSORT4_DESC = _build_argsort4_desc()


def _argsort4_desc(vals):
    s = sorted(set(vals))
    return _ARGSORT4_DESC[(s.index(vals[0]), s.index(vals[1]),
                           s.index(vals[2]), s.index(vals[3]))]


_ASCII_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# Tri/di-nucleotide run patterns (multiPrime-core.py:196-207): XXXX, XYXYXYXY,
# and XYZXYZXYZ for distinct X,Y,Z (i != j != k chains include '#' in the
# reference's base2bit; '#' never occurs in primers so those are inert).
_DI_PATTERNS = None


def _di_nucleotide_patterns():
    global _DI_PATTERNS
    if _DI_PATTERNS is None:
        pats = set()
        syms = ["A", "C", "G", "T", "#"]
        for i in syms:
            pats.add(i * 4)
            for j in syms:
                if i != j:
                    pats.add((i + j) * 4)
                for k in syms:
                    if i != j and j != k:
                        pats.add((i + j + k) * 3)
        _DI_PATTERNS = sorted(pats)
    return _DI_PATTERNS


@lru_cache(maxsize=100000)
def _occ_union(primer: str):
    """Bit-parallel position-occurrence sets for a degenerate primer.

    Returns ``(occ, masks)`` where ``occ[m]`` (for every 4-bit IUPAC mask
    ``m``) has bit ``i`` set iff ``mask(primer[i]) & m != 0``, i.e. iff some
    expansion of the primer can carry a base of ``m`` at position ``i``;
    ``masks`` is the per-position mask tuple.  Returns ``None`` when the
    primer has a non-IUPAC character (callers fall back to the string scan).

    Because IUPAC expansion is a full cartesian product, "some expansion of X
    contains some expansion of Y at offset o" is *exactly* "at every overlap
    position the two masks intersect" — the shift/AND walk over these ints is
    an exact replacement for the reference's expand-and-substring loops, not
    merely a screen."""
    occ_base = [0, 0, 0, 0]         # A, C, G, T planes
    masks = []
    for i, ch in enumerate(primer):
        m = iupac.CHAR_TO_MASK.get(ch, 0)
        if not m:
            return None
        masks.append(m)
        bit = 1 << i
        if m & iupac.A:
            occ_base[0] |= bit
        if m & iupac.C:
            occ_base[1] |= bit
        if m & iupac.G:
            occ_base[2] |= bit
        if m & iupac.T:
            occ_base[3] |= bit
    occ = [0] * 16
    for mm in range(1, 16):
        v = 0
        if mm & iupac.A:
            v |= occ_base[0]
        if mm & iupac.C:
            v |= occ_base[1]
        if mm & iupac.G:
            v |= occ_base[2]
        if mm & iupac.T:
            v |= occ_base[3]
        occ[mm] = v
    return occ, tuple(masks)


# 4-bit mask complement (A<->T, C<->G) for RC arithmetic on masks.
_COMP_MASK = [int(iupac._COMP4[m]) for m in range(16)]

_BASE_OF = {"A": iupac.A, "C": iupac.C, "G": iupac.G, "T": iupac.T}


@dataclass
class DesignParams:
    """Knobs of the design engine (CLI of multiPrime-core.py:60-102).

    ``algo`` selects which reference behaviour to reproduce bit-for-bit:

    * ``"v20"`` — the current multiPrime-core.py (used by multiPrime.py):
      mis-coverage-driven refinement, coordinate as a position list, rounded
      Y-distance, exponential dimer penalty denominator.
    * ``"v16"`` — multiPrime-core_V16.py, the version that generated the
      shipped golden test_data/results: V15 behaviour plus the coordinate-set
      mismatch gating of v20 (still unrounded Y-distance, linear penalty).
    * ``"v15"`` — multiPrime-core_V15.py (used by multiPrime-original.py):
      full-degenerate short-circuit, perfect-coverage-driven refinement,
      coordinate as a single int margin, unrounded Y-distance floats, linear
      dimer penalty denominator.
    * ``"v2"`` — the multiPrime2 "global optimum" designer
      (multiPrime2_onstep.py): consensus + combination-search refinement
      (models/global_opt.py) instead of the greedy NN walk; rows carry an
      extra degeneracy column.
    """

    primer_length: int = 18
    coverage: float = 0.8          # -f fraction
    dege_number: int = 4           # -n max number of degenerate positions
    degeneracy: int = 10           # -d max degeneracy product
    variation: int = 1             # -v max mismatches / max gaps
    entropy_threshold: float = 3.6  # -e
    gc: tuple = (0.2, 0.7)         # -g
    min_product: int = 100         # -s
    coordinate: str = "1,2,-1"     # -c forbidden mismatch positions (v20)
    position_margin: int = 4       # -c forbidden margin (v15 semantics)
    hairpin_distance: int = 4      # -a
    nproc: int = 1
    algo: str = "v20"
    # Stage-A backend: "host" (bit-exact NumPy), "device" (the batched
    # torch ops of ops/design_scan.design_stats_blocks on ``device``;
    # freq/NN/Viterbi for a block of windows at once, host Stage B consumes
    # them), or "auto" (resolve_stage_a).  Outputs are identical either way
    # (tests/test_torch_design_scan.py).
    stage_a: str = "host"
    # torch device of device Stage A: "cuda" (raises without a GPU) or "cpu"
    device: str = "cuda"


def resolve_stage_a(n_seqs, n_windows, plen):
    """The Stage-A backend of "auto": MPTPU_FORCE_BACKEND when set, else
    the device.  The JAX package weighed a TPU link model here; the H100
    crossover is not measured yet (ROADMAP.md), so "auto" takes the device.
    """
    from ..utils import link as linkmod
    return linkmod.forced_backend() or "device"


def _build_covered_table(rounded):
    """Per-char-pair "covered" truth table replicating Y_distance.

    The reference computes score_table[c1] - score_table[c2] (numpy float64)
    and treats the position as covered when the difference is a member of
    score_table.values() — with round(.,2) in v20 (core.py:229-233) and raw
    float equality in v15 (core_V15.py:275-277).  We evaluate the identical
    float arithmetic once for every pair and cache the booleans in a 128x128
    ASCII-indexed matrix.
    """
    table = np.zeros((128, 128), dtype=bool)
    values = list(iupac.SCORE_TABLE.values())
    for c1, s1 in iupac.SCORE_TABLE.items():
        if c1 == "#":
            continue
        for c2, s2 in iupac.SCORE_TABLE.items():
            if c2 == "#":
                continue
            d = np.float64(s1) - np.float64(s2)
            if rounded:
                d = round(d, 2)
            table[ord(c1), ord(c2)] = d in values
    return table


_COVERED_V20 = _build_covered_table(rounded=True)
_COVERED_V15 = _build_covered_table(rounded=False)


@dataclass
class WindowResult:
    position: int
    c_bit: float
    t_bit: float
    primer: str
    dege_number: int
    nonsense: int
    coverage: int
    f_mis: int
    r_mis: int
    tm: float
    information: object
    f_non_cover: dict = field(default_factory=dict)
    r_non_cover: dict = field(default_factory=dict)
    gap_ids: dict = field(default_factory=dict)

    def row(self):
        return [self.position, self.c_bit, self.t_bit, self.primer,
                self.dege_number, self.nonsense, self.coverage,
                self.f_mis, self.r_mis, self.tm, self.information]


class MSAWindows:
    """Stage A: vectorised window extraction with the reference's gap-patching
    semantics (multiPrime-core.py:666-687).

    Leading/trailing gaps of a window are replaced with the nearest flanking
    non-gap characters of the same sequence when enough exist.
    """

    def __init__(self, seq_ids, char_matrix, plen):
        self.seq_ids = seq_ids
        self.chars = char_matrix            # [N, L] uint8 ASCII
        self.plen = plen
        self.n, self.length = char_matrix.shape
        gap = char_matrix == ord("-")
        nz = ~gap
        pos = np.arange(self.length, dtype=np.int32)
        # Non-gap count strictly before each column.
        cs = np.cumsum(nz, axis=1, dtype=np.int32)
        self.before = np.concatenate(
            [np.zeros((self.n, 1), np.int32), cs[:, :-1]], axis=1)
        self.total = cs[:, -1]
        # Distance from p to the next non-gap at or after p.
        nxt = np.where(nz, pos[None, :], np.int32(self.length))
        nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
        self.run_from = nxt - pos[None, :]          # gap-run length starting at p
        prv = np.where(nz, pos[None, :], np.int32(-1))
        prv = np.maximum.accumulate(prv, axis=1)
        self.run_to = pos[None, :] - prv            # gap-run length ending at p
        # Compressed (gapless) characters, left-packed per row.
        self.packed = np.zeros_like(char_matrix)
        rows, cols = np.nonzero(nz)
        self.packed[rows, self.before[rows, cols]] = char_matrix[rows, cols]
        self._packed_flat = self.packed.reshape(-1)

    def windows(self, positions):
        """Patched windows for the given start positions -> [N, W, plen] ASCII.

        Patching is sparse in real MSAs (most windows touch no gap run), so
        the packed-character gathers run only on the (row, window) pairs that
        actually need them instead of materialising dense [N, W, plen] index
        tensors."""
        plen = self.plen
        p = np.asarray(positions, dtype=np.int32)
        j = np.arange(plen, dtype=np.int32)
        win = self.chars[:, (p[:, None] + j[None, :])]   # [N, W, plen]
        lead = np.minimum(self.run_from[:, p], plen)        # [N, W]
        trail = np.minimum(self.run_to[:, p + plen - 1], plen)
        allgap = lead >= plen
        c_start = self.before[:, p]
        c_end = self.before[:, p + plen - 1] + (self.chars[:, p + plen - 1] != ord("-"))
        use_lead = (~allgap) & (lead > 0) & (c_start >= lead)
        use_trail = (~allgap) & (trail > 0) & \
            ((self.total[:, None] - c_end) >= trail)
        if use_lead.any():
            r, w = np.nonzero(use_lead)
            ld = lead[r, w].astype(np.int32)[:, None]            # [K, 1]
            # use_lead guarantees c_start >= lead, so idx >= r*length >= 0.
            idx = (r.astype(np.int64) * self.length)[:, None] \
                + c_start[r, w][:, None] - ld + j
            vals = self._packed_flat[idx]                         # [K, plen]
            patched = np.where(j < ld, vals, win[r, w])
            win[r, w] = patched
        if use_trail.any():
            r, w = np.nonzero(use_trail)
            tr = trail[r, w].astype(np.int32)[:, None]
            off = j - (plen - tr)                                 # [K, plen]
            idx = (r.astype(np.int64) * self.length)[:, None] \
                + c_end[r, w][:, None] + off
            # off < 0 entries are masked below; clamp keeps the gather in-bounds.
            vals = self._packed_flat[np.maximum(idx, 0)]
            patched = np.where(off >= 0, vals, win[r, w])
            win[r, w] = patched
        return win


def parse_msa(path):
    """MSA FASTA -> (ids, char matrix) with the reference's cleaning:
    uppercase, non-[ACGTRYMKSWHBVD] -> '-' (N becomes a gap; core.py:441-455).
    IDs keep their '>' prefix like the reference's dict keys."""
    ids, seqs = [], []
    cur = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
                ids.append(line.strip().split(" ")[0])
            else:
                cur.append(line.strip().upper())
    if cur:
        seqs.append("".join(cur))
    keep = set(b"ACGTRYMKSWHBVD")
    table = np.full(256, ord("-"), np.uint8)
    for b in keep:
        table[b] = b
    lower_to_upper = {ord(c): ord(c.upper()) for c in "acgtrymkswhbvd"}
    for lo, up in lower_to_upper.items():
        table[lo] = up
    mat = np.stack([
        table[np.frombuffer(s.encode("ascii"), np.uint8)] for s in seqs])
    return ids, mat


@lru_cache(maxsize=4096)
def _pure_gc_mean(gc_count, plen):
    """gc_degenerate_mean of a pure row from its GC count:
    round(round(gc/L, 3), 2) on the (count, plen) grid."""
    return round(round(gc_count / plen, 3), 2)


@lru_cache(maxsize=None)
def _loss3_table(l1, linear):
    """uint8 [l1, l1, l1] of the self-dimer Loss >= 3 verdicts over
    (end_len, gc, d2) — the exact Python floats, tabulated once per
    (primer_len, penalty variant) for the native pure_window_filters2
    gate (dimer_check's loss half, core.py:487-503)."""
    t = np.zeros((l1, l1, l1), np.uint8)
    fn = thermo.penalty_points_linear if linear else thermo.penalty_points
    for ln in range(5, min(19, l1)):
        for gc in range(ln + 1):
            for d2 in range(l1):
                if fn(ln, gc, 0, d2) >= 3:
                    t[ln, gc, d2] = 1
    return t


class DesignEngine:
    """Bit-exact MC-EDPD engine over one MSA."""

    def __init__(self, params: DesignParams):
        self.p = params
        self._uniform_bits = None    # (total, cBit, tBit) fast-path cache
        # the Stage-A backend that served the last design() ("host" or
        # "device"); None until a design reaches Stage A
        self.stage_a_used = None
        plen = params.primer_length
        if params.algo in ("v20", "v16", "v2"):
            self.y_strict, self.y_strict_r = self._forbidden_sets()
            self._y_strict_arr = np.zeros(plen, dtype=bool)
            self._y_strict_r_arr = np.zeros(plen, dtype=bool)
            for y in self.y_strict:
                if 0 <= y < plen:
                    self._y_strict_arr[y] = True
            for y in self.y_strict_r:
                if 0 <= y < plen:
                    self._y_strict_r_arr[y] = True
        else:
            self.y_strict = self.y_strict_r = None
        self._covered = _COVERED_V20 if params.algo in ("v20", "v2") \
            else _COVERED_V15
        self._di_pats = _di_nucleotide_patterns()

    # -- parameter-derived sets ------------------------------------------------
    def _forbidden_sets(self):
        """Forbidden mismatch positions (get_Y, core.py:1091-1101)."""
        plen = self.p.primer_length
        f, r = [], []
        for tok in self.p.coordinate.split(","):
            y = int(tok.strip())
            if y > 0:
                f.append(y)
                r.append(plen - y)
            else:
                f.append(plen + y + 1)
                r.append(-y + 1)
        return set(f), set(r)

    # -- per-primer string filters (reference semantics) -----------------------
    @staticmethod
    def _substring_maxstart(primer, min_len=5):
        return _substring_maxstart_cached(primer, min_len)

    def hairpin_check(self, primer: str) -> bool:
        """Sliding 5-mer vs downstream tail RC search (core.py:387-398).

        Exact bit-parallel form of the reference's expand-both-sides loop:
        a hit exists iff at some offset every RC(5-mer) mask intersects the
        tail mask (expansion choices are independent per position)."""
        d = self.p.hairpin_distance
        length = len(primer)
        if length < 10 + d:
            return False
        flag = native.hairpin_flag(primer, d)
        if flag is not None:
            return flag
        prep = _occ_union(primer)
        if prep is None:
            return self._hairpin_check_ref(primer)
        occ, masks = prep
        for n in range(length - 10 - d + 1):
            lo = n + 5 + d
            window = ((1 << (length - 5 - lo + 1)) - 1) << lo
            ok = window
            for j in range(5):
                ok &= occ[_COMP_MASK[masks[n + 4 - j]]] >> j
                if not ok:
                    break
            if ok:
                return True
        return False

    def _hairpin_check_ref(self, primer: str) -> bool:
        """Reference string-scan oracle (core.py:387-398)."""
        d = self.p.hairpin_distance
        n = 0
        while n <= len(primer) - 10 - d:
            for k in iupac.expand(primer[n:n + 5]):
                rck = iupac.rc(k)
                for tail in iupac.expand(primer[n + 5 + d:]):
                    if rck in tail:
                        return True
            n += 1
        return False

    def di_nucleotide(self, primer: str) -> bool:
        """Di/tri-nucleotide run filter (core.py:196-207, 462-468) — exact
        bit-parallel pattern match over the degenerate primer."""
        flag = native.di_nucleotide_flag(primer)
        if flag is not None:
            return flag
        prep = _occ_union(primer)
        if prep is None:
            return self._di_nucleotide_ref(primer)
        occ, masks = prep
        length = len(primer)
        for pat in self._di_pats:
            lp = len(pat)
            if lp > length or "#" in pat:
                continue
            ok = (1 << (length - lp + 1)) - 1
            for j, ch in enumerate(pat):
                ok &= occ[_BASE_OF[ch]] >> j
                if not ok:
                    break
            if ok:
                return True
        return False

    def _di_nucleotide_ref(self, primer: str) -> bool:
        for m in iupac.expand(primer):
            for pat in self._di_pats:
                if pat in m:
                    return True
        return False

    def gc_clamp(self, primer: str, num=4, length=13) -> bool:
        for i in range(num, num + length):
            if thermo.gc_degenerate_mean(primer[-i:]) > 0.6:
                return True
        return False

    def current_end(self, primer: str, adaptor="", num=5, length=14):
        out = []
        ext = adaptor + primer
        for i in range(num, num + length):
            s = ext[-i:]
            if s:
                out.extend(iupac.expand(s))
        return out

    def dimer_check(self, primer: str) -> bool:
        """Self-dimer 3'-end scan (core.py:487-503).  v15 uses the linear
        penalty denominator (core_V15.py:240-242), v20 the exponential one.
        The expansion substring index screens out ends whose RC cannot occur
        anywhere; the exact find loop only runs on real candidates."""
        linear = self.p.algo in ("v15", "v16")
        cands = native.dimer_screen(primer)
        if cands is not None:
            # native string phase (same candidates, same order — see
            # seqlib.cpp dimer_screen); float verdicts stay in Python
            for end, d2 in cands:
                gc = end.count("G") + end.count("C")
                if linear:
                    loss = thermo.penalty_points_linear(len(end), gc, 0, d2)
                else:
                    loss = thermo.penalty_points(len(end), gc, 0, d2)
                dg = thermo.delta_g(end, both_ends=True)
                if loss >= 3 or (dg < -5 and d2 == 0):
                    return True
            return False
        ends = sorted(self.current_end(primer), key=len, reverse=True)
        expansions = iupac.expand(primer)
        # Bit-parallel offset screen on the degenerate pattern: occ[b] has
        # bit i set iff position i of the primer admits base b.  An end can
        # only hit some expansion if its RC matches the pattern at some
        # offset; most ends fail this in a handful of shift/AND ops, so the
        # exact first-occurrence find loop runs rarely.
        plen_ = len(primer)
        occ = {"A": 0, "C": 0, "G": 0, "T": 0}
        for i, ch in enumerate(primer):
            m = iupac.CHAR_TO_MASK.get(ch, 0)
            if m & iupac.A:
                occ["A"] |= 1 << i
            if m & iupac.C:
                occ["C"] |= 1 << i
            if m & iupac.G:
                occ["G"] |= 1 << i
            if m & iupac.T:
                occ["T"] |= 1 << i
        for end in ends:
            rce = iupac.rc(end)
            mlen = len(rce)
            if mlen > plen_:
                continue
            ok = (1 << (plen_ - mlen + 1)) - 1
            for j, ch in enumerate(rce):
                ok &= occ[ch] >> j
                if not ok:
                    break
            if not ok:
                continue
            for p in expansions:
                idx = p.find(rce)
                if idx >= 0:
                    d2 = len(p) - len(end) - idx
                    gc = end.count("G") + end.count("C")
                    if linear:
                        loss = thermo.penalty_points_linear(len(end), gc, 0, d2)
                    else:
                        loss = thermo.penalty_points(len(end), gc, 0, d2)
                    dg = thermo.delta_g(end, both_ends=True)
                    if loss >= 3 or (dg < -5 and d2 == 0):
                        return True
        return False

    def pre_filter_info(self, primer: str):
        """GC / di-nucleotide / hairpin report (core.py:507-521)."""
        issues = []
        gc = thermo.gc_degenerate_mean(primer)
        lo, hi = self.p.gc
        if not float(lo) <= gc <= float(hi):
            issues.append("GC_out_of_range (" + str(gc) + ")")
        if self.di_nucleotide(primer):
            issues.append("di_nucleotide")
        if self.hairpin_check(primer):
            issues.append("hairpin")
        return gc if not issues else "|".join(issues)

    # -- MSA attributes --------------------------------------------------------
    def usable_span(self, chars):
        """Quantile-based usable window span (seq_attribute, core.py:617-640)."""
        gap = chars == ord("-")
        n, length = chars.shape
        first = np.argmax(~gap, axis=1)
        first = np.where(gap.all(axis=1), length, first)
        last = length - np.argmax(~gap[:, ::-1], axis=1)
        last = np.where(gap.all(axis=1), 0, last)
        start = int(np.quantile(first, self.p.coverage, method="higher"))
        stop = int(np.quantile(last, self.p.coverage, method="lower"))
        if stop - start < int(self.p.min_product):
            raise ValueError(
                "usable span {} shorter than min product size {} at coverage {}"
                .format(stop - start, self.p.min_product, self.p.coverage))
        return start, stop

    def entropy_threshold(self, length):
        raw = self.p.entropy_threshold
        if length < 5000:
            return raw
        if length < 10000:
            return raw * 0.95
        return raw * 0.9

    # -- main ------------------------------------------------------------------
    def design(self, seq_ids, chars, progress=None):
        """Run the full engine. Returns list[WindowResult] sorted by position.

        Windows are independent; with nproc > 1 the per-window Stage B fans
        out over forked workers (the reference's -p flag, whose own pool is
        accidentally serial — multiPrime-core.py:1143 submits call results)."""
        plen = self.p.primer_length
        n = len(seq_ids)
        start, stop = self.usable_span(chars)
        threshold = self.entropy_threshold(stop - start)
        positions = np.arange(start, stop - plen)
        stage_a = self.p.stage_a
        if stage_a == "auto":
            stage_a = resolve_stage_a(n, len(positions), plen)
        self.stage_a_used = stage_a
        if stage_a == "device":
            return self._design_device(chars, positions, seq_ids, n,
                                       threshold, progress)
        extractor = MSAWindows(seq_ids, chars, plen)
        if self.p.nproc > 1 and len(positions) >= 64:
            return self._design_parallel(extractor, positions, seq_ids, n,
                                         threshold)
        results = []
        block = 256
        fastable = self.p.algo in ("v15", "v16", "v20")
        for b0 in range(0, len(positions), block):
            pos_block = positions[b0:b0 + block]
            wins = extractor.windows(pos_block)      # [N, W, plen]
            gap_blk = (wins == ord("-")).sum(axis=2)
            imp_blk = _IMPURE_TABLE[wins].any(axis=2)
            same_blk = (wins == wins[:1]).all(axis=(0, 2))
            # batch the uniform-pure fast path's four per-window native
            # calls (di/hairpin/dimer-candidates/Tm) into ONE call for the
            # whole block's qualifying windows (singleton clusters are all
            # qualifying windows)
            pure_pre = {}
            if fastable:
                pure_wi = [wi for wi in range(wins.shape[1])
                           if same_blk[wi] and gap_blk[0, wi] == 0
                           and not imp_blk[0, wi]]
                if pure_wi:
                    rows0 = np.ascontiguousarray(wins[0, pure_wi, :])
                    # prefer the fully-native gate batch: the self-dimer
                    # verdict (Loss >= 3 via a Python-built exact table +
                    # dG < -5 at d2 == 0) resolves in the same call, so no
                    # candidate streams or per-end Python float replay
                    # remain (flags bit 3 = reject).  Fallback: the
                    # candidate-stream batch + Python verdicts.
                    from .pairing import _dg_tables
                    batch2 = native.pure_window_filters2(
                        rows0, self.p.hairpin_distance,
                        _loss3_table(self.p.primer_length + 1,
                                     self.p.algo in ("v15", "v16")),
                        _dg_tables())
                    if batch2 is not None:
                        flags, tms, gcs = batch2
                        # tight block assembly: the fast-path checks that
                        # remain after the native gates are constants per
                        # cluster (gap gate at 0 gaps, cBit/tBit vs the
                        # entropy threshold) plus a vectorised 4-base
                        # presence test — build the WindowResults here and
                        # let the wi loop below just pick them up (same
                        # emission order).  Semantics identical to
                        # _design_window's uniform-pure branch (fuzz:
                        # tests/test_design_golden.py).
                        done = {}
                        if round(0 / n, 2) >= (1 - self.p.coverage):
                            done = {wi: None for wi in pure_wi}
                        else:
                            bits = self._uniform_bits
                            if bits is None or bits[0] != n:
                                bits = (n,) + thermo.shannon_pair(
                                    [n], n, [], 0)
                                self._uniform_bits = bits
                            _, c_bit, t_bit = bits
                            if t_bit > threshold:
                                done = {wi: None for wi in pure_wi}
                            else:
                                has4 = ((rows0 == ord("A")).any(axis=1)
                                        & (rows0 == ord("C")).any(axis=1)
                                        & (rows0 == ord("G")).any(axis=1)
                                        & (rows0 == ord("T")).any(axis=1))
                                for bi, wi in enumerate(pure_wi):
                                    done[wi] = None
                                    if not has4[bi]:
                                        continue
                                    done[wi] = self._finalize_pure(
                                        int(pos_block[wi]), c_bit, t_bit,
                                        rows0[bi].tobytes().decode("ascii"),
                                        n, (int(flags[bi]), float(tms[bi]),
                                            int(gcs[bi]), None))
                        pure_pre = done
                    else:
                        batch = native.pure_window_filters(
                            rows0, self.p.hairpin_distance)
                        if batch is not None:
                            flags, tms, gcs, cands = batch
                            pure_pre = {wi: (int(flags[bi]), float(tms[bi]),
                                             int(gcs[bi]), cands[bi])
                                        for bi, wi in enumerate(pure_wi)}
            for wi, position in enumerate(pos_block):
                if wi in pure_pre and not isinstance(pure_pre[wi], tuple):
                    res = pure_pre[wi]          # assembled (or rejected)
                else:
                    res = self._design_window(int(position),
                                              wins[:, wi, :],
                                              seq_ids, n, threshold,
                                              gates=(gap_blk[:, wi],
                                                     imp_blk[:, wi],
                                                     bool(same_blk[wi])),
                                              pure_pre=pure_pre.get(wi))
                if res is not None:
                    results.append(res)
            if progress:
                progress(min(b0 + block, len(positions)), len(positions))
        return results

    def _design_device(self, chars, positions, seq_ids, n, threshold,
                       progress=None):
        """Stage A on ``self.p.device`` (ops/design_scan): patched windows,
        freq/NN tensors and Viterbi paths for all windows in blocks; Stage B
        consumes them window by window.  Bit-identical to the host path
        (the device integers are exact; tests/test_torch_design_scan.py).
        """
        from ..ops import design_scan
        masks = iupac.bytes_to_masks(chars)
        done = 0
        results = []
        blocks = design_scan.design_stats_blocks(
            masks, positions, plen=self.p.primer_length,
            variation=self.p.variation, device=self.p.device)
        for pos_block, stats in blocks:
            win_chars = iupac._MASK_TO_ASCII[stats["win"] & 15]  # [N, W, plen]
            gap_blk = (win_chars == ord("-")).sum(axis=2)
            imp_blk = _IMPURE_TABLE[win_chars].any(axis=2)
            same_blk = (win_chars == win_chars[:1]).all(axis=(0, 2))
            for wi, position in enumerate(pos_block):
                pre = (stats["freq"][wi].T.astype(np.int64),
                       stats["nn"][wi].astype(np.int64),
                       stats["viterbi"][wi].astype(np.int64))
                res = self._design_window(int(position), win_chars[:, wi, :],
                                          seq_ids, n, threshold, pre=pre,
                                          gates=(gap_blk[:, wi],
                                                 imp_blk[:, wi],
                                                 bool(same_blk[wi])))
                if res is not None:
                    results.append(res)
            done += len(pos_block)
            if progress:
                progress(done, len(positions))
        return results

    def _design_parallel(self, extractor, positions, seq_ids, n, threshold):
        import concurrent.futures as cf
        import multiprocessing as mp
        global _FORK_WORKER
        nw = self.p.nproc
        chunks = [c for c in np.array_split(positions, nw * 4) if len(c)]
        ctx = mp.get_context("fork")
        # The worker (engine + full MSA) crosses into children by fork
        # copy-on-write via this module global; only the tiny position
        # chunks and the result rows are ever pickled.
        _FORK_WORKER = _DesignWorker(self, extractor, seq_ids, n, threshold)
        results = []
        try:
            with cf.ProcessPoolExecutor(max_workers=nw, mp_context=ctx) as pool:
                for part in pool.map(_call_fork_worker, chunks):
                    results.extend(part)
        finally:
            _FORK_WORKER = None
        return results

    # -- per-window Stage B ----------------------------------------------------
    def _design_window(self, position, win_chars, seq_ids, total, threshold,
                       pre=None, gates=None, pure_pre=None):
        p = self.p
        plen = p.primer_length
        if gates is None:
            gapcnt = (win_chars == ord("-")).sum(axis=1)
            needs_expand = _IMPURE_TABLE[win_chars].any(axis=1)
            all_same = bool((win_chars == win_chars[:1]).all())
        else:               # precomputed per block (same ops, batched)
            gapcnt, needs_expand, all_same = gates
        is_gap = gapcnt > p.variation

        # Gap gate: the reference checks the running rounded fraction after
        # each gappy sequence and at the end; the fraction is monotone, so it
        # reduces to the final check (core.py:689-713).
        gap_number = int(is_gap.sum())
        if round(gap_number / total, 2) >= (1 - p.coverage):
            return None

        # Uniform-pure fast path (singleton clusters, zero-variation
        # windows): with one distinct pure row the general path provably
        # collapses — cover == {row: total}, cBit == tBit ==
        # shannon_pair([total], total, [], 0), the a<4 early-out becomes
        # "row misses a base", and every refinement route is the identity:
        # the v15/v16 full-degenerate short-circuit emits the row itself
        # (or, when the degeneracy gates block it, the refine loop exits
        # immediately at coverage_init == cover_number), and v20's
        # mis-coverage loop never runs because the uncover set is empty so
        # f_mis == r_mis == 0 with coverage_init == cover_number.  All
        # paths then _finalize(row, N, N, {}, {}) with nonsense 0.
        # v2 is excluded (refine_global's combination search is not
        # obviously the identity).  Exact-equivalence fuzz over all three
        # algos and the degeneracy edges: tests/test_design_golden.py.
        # gapcnt[0] == 0: _IMPURE_TABLE treats '-' as pure, so without this
        # guard an all-identical window carrying 1..variation gaps (allowed
        # by the gap gate above) would reach _finalize with '-' in the
        # primer and crash tm_degenerate_mean; the general path rejects such
        # windows via its zero freq-column gate.
        if (all_same and not needs_expand[0] and gapcnt[0] == 0
                and p.algo in ("v15", "v16", "v20")):
            row = win_chars[0].tobytes().decode("ascii")
            # constant per cluster (depends only on total) — cached
            bits = self._uniform_bits
            if bits is None or bits[0] != total:
                bits = (total,) + thermo.shannon_pair([total], total, [], 0)
                self._uniform_bits = bits
            _, c_bit, t_bit = bits
            if t_bit > threshold:
                return None
            if len(set(row)) < 4:            # a < 4: some base never occurs
                return None
            if pure_pre is not None:
                # block-batched native filters (design(): one call per
                # block) — exact-equivalence fuzz in tests/test_design_
                # golden.py::test_pure_window_filters_batch_equivalence
                return self._finalize_pure(position, c_bit, t_bit, row,
                                           total, pure_pre)
            info = self.pre_filter_info(row)
            return self._finalize(position, c_bit, t_bit, row, total, total,
                                  info, {}, {}, {row: total}, set(), {})

        # Distinct raw windows with first-occurrence order and per-row member
        # lists: expansion/dict building then runs over the distinct rows
        # only, preserving the reference's file-order insertion semantics.
        # The native FNV grouping replaces the N-iteration bytes-keyed dict
        # loop (same first-occurrence order, ascending member indices —
        # parity test in tests/test_native_refine.py); the dict loop remains
        # as the fallback.
        win = np.ascontiguousarray(win_chars)
        flat = win.tobytes()
        grp = native.group_rows(win)
        if grp is not None:
            n_groups, g_order, g_members, g_offsets = grp
            bounds = g_offsets[:n_groups + 1].tolist()
            starts = (g_order[:n_groups].astype(np.int64) * plen).tolist()
            rows_iter = [(flat[s:s + plen],
                          g_members[bounds[gi]:bounds[gi + 1]].tolist())
                         for gi, s in enumerate(starts)]
        else:
            groups = {}
            for si in range(total):
                key = flat[si * plen:(si + 1) * plen]
                g = groups.get(key)
                if g is None:
                    groups[key] = [si]
                else:
                    g.append(si)
            rows_iter = groups.items()

        cover = {}
        cover_for_mm = {}
        non_gap_seq_id = {}
        gap_sequence = {}
        gap_seq_id = {}
        multi_exp = {}          # expansion -> [seq index lists] for merging
        for rkey, members in rows_iter:
            row = rkey.decode("ascii")
            count = len(members)
            expansions = iupac.expand(row) if needs_expand[members[0]] \
                else (row,)
            if is_gap[members[0]]:
                gap_sequence[row] = count
                for e in expansions:
                    gap_seq_id.setdefault(e, []).append(members)
            else:
                for e in expansions:
                    if e in cover:
                        cover[e] += count
                        multi_exp.setdefault(e, []).append(members)
                    else:
                        cover[e] = count
                        non_gap_seq_id[e] = members
                    if "-" not in e:
                        cover_for_mm[e] = cover_for_mm.get(e, 0) + count
        # Merge seq-id lists for expansions shared by several raw windows
        # (reference appends in global sequence order).
        for e, extra in multi_exp.items():
            merged = sorted(itertools.chain(non_gap_seq_id[e], *extra))
            non_gap_seq_id[e] = merged
        for e in non_gap_seq_id:
            non_gap_seq_id[e] = [seq_ids[s] for s in non_gap_seq_id[e]]
        for e in gap_seq_id:
            parts = gap_seq_id[e]
            idxs = parts[0] if len(parts) == 1 else sorted(
                itertools.chain(*parts))
            gap_seq_id[e] = [seq_ids[s] for s in idxs]
        if len(cover) < 1:
            return None
        cover_number = int((~is_gap).sum())

        c_bit, t_bit = thermo.shannon_pair(
            list(cover.values()), cover_number,
            list(gap_sequence.values()), gap_number)
        if t_bit > threshold:
            return None

        # Frequency matrix [4, plen] and NN tensor [plen-1, 4, 4] over the
        # distinct expansions weighted by their counts.  With a device
        # Stage-A (`pre`), the tensors and the Viterbi path arrive
        # precomputed (exact integers, same totals — the device weights each
        # raw row by expansion multiplicity, which equals the per-expansion
        # counting here by linearity).
        keys = list(cover.keys())
        counts = np.fromiter(cover.values(), dtype=np.int64, count=len(keys))
        key_chars = np.frombuffer("".join(keys).encode("ascii"),
                                  np.uint8).reshape(len(keys), plen)
        nn = None
        if pre is not None:
            freq, nn, viterbi_pre = pre
        else:
            fn = native.freq_nn(key_chars, counts)
            if fn is not None:
                freq, nn = fn       # exact int64, same einsum semantics
            else:
                onehot = key_chars[:, :, None] == _ASCII_BASES[None, None, :]
                freq = np.einsum("k,klb->bl", counts,
                                 onehot.astype(np.int64))       # [4, plen]
        if (freq.sum(axis=0) == 0).any():
            return None
        if (freq.sum(axis=1) == 0).any():     # a < 4: some base never occurs
            return None
        if nn is None:
            left = onehot[:, :-1, :].astype(np.int64)
            right = onehot[:, 1:, :].astype(np.int64)
            nn = np.einsum("k,kli,klj->lij", counts, left, right)
        counts_list = [int(c) for c in counts]

        cover_extra = set()

        if self.p.algo in ("v15", "v16"):
            # Full-degenerate short-circuit (core_V15.py:604-618, 841-867):
            # when the per-position union of observed bases is within the
            # degeneracy budget, use it directly without Viterbi/refinement.
            bits = np.array([iupac.CHAR_TO_MASK[b] for b in BASES])
            union = np.bitwise_or.reduce(
                np.where(freq > 0, bits[:, None], 0), axis=0)
            full = "".join(iupac.MASK_TO_CHAR[int(m)] for m in union)
            full_dege = iupac.degeneracy(full)
            full_n = iupac.num_degenerate_positions(full)
            if full_dege < self.p.degeneracy and full_n < self.p.dege_number:
                info = self.pre_filter_info(full)
                f_mis_cc, f_non, r_mis_cc, r_non = self._mis_primer_check(
                    keys, key_chars, counts_list, full, non_gap_seq_id)
                init = sum(cover[e] for e in
                           set(cover.keys()) & set(iupac.expand(full)))
                return self._finalize(position, c_bit, t_bit, full,
                                      init + f_mis_cc, init + r_mis_cc, info,
                                      f_non, r_non, cover, cover_extra,
                                      gap_seq_id)

        viterbi_path = viterbi_pre if pre is not None else _viterbi(freq, nn)

        if self.p.algo == "v2":
            return self._design_window_v2(
                position, c_bit, t_bit, viterbi_path, cover, cover_for_mm,
                keys, key_chars, counts_list, non_gap_seq_id, cover_number,
                gap_seq_id)

        if self.p.algo == "v20":
            # one C-speed conversion shared by both branches; v15/v16 keep
            # the ndarray for the native refine loop (which copies it)
            nn = nn.tolist()
        if cover_for_mm:
            # stable max with insertion-order tie-break == sorted(reverse=True)[0]
            best = None
            for k, v in cover_for_mm.items():
                if best is None or v > best[1]:
                    best = (k, v)
            mm_path = [_BASE2IDX[ch] for ch in best[0]]
            if viterbi_path.tolist() == mm_path:
                branch = self._coverage_stats(
                    viterbi_path, nn, cover, keys, key_chars,
                    counts_list, non_gap_seq_id, cover_number, cover_extra)
                (primer, f_mis, r_mis, info, f_non, r_non) = branch
            else:
                nm = self._coverage_stats(
                    viterbi_path, nn, cover, keys, key_chars,
                    counts_list, non_gap_seq_id, cover_number, cover_extra)
                mm = self._coverage_stats(
                    np.array(mm_path), nn, cover, keys, key_chars,
                    counts_list, non_gap_seq_id, cover_number, cover_extra)
                if (nm[1] + nm[2]) > (mm[1] + mm[2]):
                    primer, f_mis, r_mis, info, f_non, r_non = nm
                else:
                    primer, f_mis, r_mis, info, f_non, r_non = mm
        else:
            branch = self._coverage_stats(
                viterbi_path, nn, cover, keys, key_chars,
                counts_list, non_gap_seq_id, cover_number, cover_extra)
            primer, f_mis, r_mis, info, f_non, r_non = branch

        return self._finalize(position, c_bit, t_bit, primer, f_mis, r_mis,
                              info, f_non, r_non, cover, cover_extra,
                              gap_seq_id)

    def _design_window_v2(self, position, c_bit, t_bit, viterbi_path, cover,
                          cover_for_mm, keys, key_chars, counts_list,
                          non_gap_seq_id, cover_number, gap_seq_id):
        """multiPrime2 "global optimum" flow (refine_by_multiPrime2,
        multiPrime2_onstep.py:1156-1237): combination-search refinement of
        the consensus instead of the greedy NN walk; the branch choice uses
        the refined coverage, NM winning ties."""
        from . import global_opt
        consensus_nm = "".join(BASES[i] for i in viterbi_path)
        if cover_for_mm:
            best = None
            for k, v in cover_for_mm.items():
                if best is None or v > best[1]:
                    best = (k, v)
            consensus_mm = best[0]
            if consensus_nm == consensus_mm:
                primer, coverage = global_opt.refine_global(
                    consensus_nm, cover, self.p.dege_number,
                    self.p.variation, cover_number)
            else:
                p_nm, cov_nm = global_opt.refine_global(
                    consensus_nm, cover, self.p.dege_number,
                    self.p.variation, cover_number)
                p_mm, cov_mm = global_opt.refine_global(
                    consensus_mm, cover, self.p.dege_number,
                    self.p.variation, cover_number)
                primer, coverage = (p_nm, cov_nm) if cov_nm >= cov_mm \
                    else (p_mm, cov_mm)
        else:
            primer, coverage = global_opt.refine_global(
                consensus_nm, cover, self.p.dege_number, self.p.variation,
                cover_number)
        f_mis, f_non, r_mis, r_non = self._mis_primer_check(
            keys, key_chars, counts_list, primer, non_gap_seq_id)
        expansions = iupac.expand(primer)
        nonsense = len(set(expansions) - set(cover.keys()))
        dege_n = iupac.num_degenerate_positions(primer)
        degeneracy = iupac.degeneracy(primer)
        tm_avg = thermo.tm_degenerate_mean(primer)
        perfect = sum(cover.get(e, 0) for e in expansions)
        info = self.pre_filter_info(primer)
        if self.dimer_check(primer):
            return None
        res = WindowResult(position, c_bit, t_bit, primer, dege_n, nonsense,
                           perfect, perfect + f_mis, perfect + r_mis, tm_avg,
                           info, f_non, r_non, gap_seq_id)
        res.degeneracy = degeneracy
        return res

    def _finalize_pure(self, position, c_bit, t_bit, row, total, pre):
        """_finalize specialised to the uniform-pure fast path with the
        block-batched native filter results: for cover == {row: total},
        expansions == (row,) the general assembly collapses to dege_n = 0,
        nonsense = 0, perfect = f_mis = r_mis = total; info reproduces
        pre_filter_info byte-for-byte from the flags/GC count, the dimer
        gate replays dimer_check's float verdicts over the native
        candidate stream, and tm equals tm_degenerate_mean(row)."""
        flags, tm_val, gc_count, cands = pre
        plen = len(row)
        # gc_degenerate_mean(row) for a pure row: round(round(gc/L,3), 2)
        # — plen+1 possible counts, memoized on the tiny (count, plen) grid
        gc = _pure_gc_mean(gc_count, plen)
        issues = []
        lo, hi = self.p.gc
        if not float(lo) <= gc <= float(hi):
            issues.append("GC_out_of_range (" + str(gc) + ")")
        if flags & 1:
            issues.append("di_nucleotide")
        if flags & 2:
            issues.append("hairpin")
        info = gc if not issues else "|".join(issues)
        if cands is None:
            # pure_window_filters2 already resolved the verdict natively
            if flags & 8:
                return None
        else:
            linear = self.p.algo in ("v15", "v16")
            for end, d2 in cands:
                gce = end.count("G") + end.count("C")
                if linear:
                    loss = thermo.penalty_points_linear(len(end), gce, 0, d2)
                else:
                    loss = thermo.penalty_points(len(end), gce, 0, d2)
                dg = thermo.delta_g(end, both_ends=True)
                if loss >= 3 or (dg < -5 and d2 == 0):
                    return None
        tm_avg = round(tm_val, 2)
        return WindowResult(position, c_bit, t_bit, row, 0, 0, total,
                            total, total, tm_avg, info, {}, {}, {})

    def _finalize(self, position, c_bit, t_bit, primer, f_mis, r_mis, info,
                  f_non, r_non, cover, cover_extra, gap_seq_id):
        """Common output assembly (core.py:846-858) + the dimer gate."""
        expansions = iupac.expand(primer)
        nonsense = len(set(expansions) - (set(cover.keys()) | cover_extra))
        dege_n = iupac.num_degenerate_positions(primer)
        tm_avg = thermo.tm_degenerate_mean(primer)
        perfect = sum(cover.get(e, 0) for e in expansions)
        if self.dimer_check(primer):
            return None
        return WindowResult(position, c_bit, t_bit, primer, dege_n, nonsense,
                            perfect, f_mis, r_mis, tm_avg, info,
                            f_non, r_non, gap_seq_id)

    # -- refinement ------------------------------------------------------------
    def _coverage_stats(self, path, nn, cover, keys, key_chars, counts_list,
                        non_gap_seq_id, cover_number, cover_extra):
        """Greedy NN refinement loop (coverage_stast, core.py:860-920)."""
        p = self.p
        path = np.asarray(path)
        primer_list = [BASES[i] for i in path]
        consensus = "".join(primer_list)
        cover_extra.add(consensus)               # defaultdict insertion quirk
        coverage_init = cover.get(consensus, 0)

        if p.algo in ("v15", "v16"):
            # Native transliteration of the perfect-coverage loop (its
            # candidate order / integer bookkeeping is identical; parity
            # pinned by tests/test_native_refine.py + the fuzz shadows).
            res = native.refine_v16(
                consensus, nn, keys, counts_list, coverage_init,
                cover_number, p.degeneracy, p.dege_number)
            if res is not None:
                primer, coverage_init = res
                f_mis, f_non, r_mis, r_non = self._mis_primer_check(
                    keys, key_chars, counts_list, primer, non_gap_seq_id)
                info = self.pre_filter_info(primer)
                return (primer, coverage_init + f_mis,
                        coverage_init + r_mis, info, dict(f_non),
                        dict(r_non))
        elif p.algo == "v20":
            # Native mis-coverage-driven loop: the interleaved
            # _mis_primer_check calls feed only order-independent count
            # sums, so they run in C; the final F/R non-cover dicts (whose
            # key order follows CPython set layout) come from ONE Python
            # _mis_primer_check on the returned primer — identical to the
            # last in-loop call because counts and dicts are deterministic
            # functions of the primer (tests/test_native_refine.py fuzz).
            res = native.refine_v20(
                consensus, nn, keys, counts_list, coverage_init,
                cover_number, p.degeneracy, p.dege_number, self._covered,
                self._y_strict_arr, self._y_strict_r_arr, p.variation)
            if res is not None:
                primer, coverage_init = res
                f_mis, f_non, r_mis, r_non = self._mis_primer_check(
                    keys, key_chars, counts_list, primer, non_gap_seq_id)
                info = self.pre_filter_info(primer)
                return (primer, coverage_init + f_mis,
                        coverage_init + r_mis, info, dict(f_non),
                        dict(r_non))

        nn_index = [[int(path[i]), int(path[i + 1])]
                    for i in range(len(path) - 1)]
        # exact small ints as nested lists for the pure-Python refine loop
        # (ndarray.tolist() is C-speed; a list passed in is already converted)
        if isinstance(nn, np.ndarray):
            nn = nn.tolist()
        nn_cov = [nn[i][a][b] for i, (a, b) in enumerate(nn_index)]

        if p.algo in ("v15", "v16"):
            # Perfect-coverage-driven loop, mis-check only once at the end
            # (core_V15.py:964-986).
            while coverage_init < cover_number:
                (primer_list, coverage_init, nn_cov_new, nn, dege, n_dege) = \
                    self._refine_step(primer_list, coverage_init, cover,
                                      nn_index, nn_cov, nn)
                if nn_cov_new == nn_cov:
                    break
                elif dege >= p.degeneracy or n_dege >= p.dege_number:
                    break
                else:
                    nn_cov = nn_cov_new
            f_mis, f_non, r_mis, r_non = self._mis_primer_check(
                keys, key_chars, counts_list, "".join(primer_list),
                non_gap_seq_id)
        else:
            f_mis, f_non, r_mis, r_non = self._mis_primer_check(
                keys, key_chars, counts_list, "".join(primer_list),
                non_gap_seq_id)
            while (coverage_init + f_mis < cover_number
                   or coverage_init + r_mis < cover_number):
                (primer_list, coverage_init, nn_cov_new, nn, dege, n_dege) = \
                    self._refine_step(primer_list, coverage_init, cover,
                                      nn_index, nn_cov, nn)
                f_mis, f_non, r_mis, r_non = self._mis_primer_check(
                    keys, key_chars, counts_list, "".join(primer_list),
                    non_gap_seq_id)
                if max(f_mis, r_mis) == cover_number:
                    break
                elif nn_cov_new == nn_cov:
                    break
                elif (2 * dege > p.degeneracy or 3 * dege / 2 > p.degeneracy
                        or n_dege == p.dege_number):
                    break
                else:
                    nn_cov = nn_cov_new

        primer = "".join(primer_list)
        info = self.pre_filter_info(primer)
        return (primer, coverage_init + f_mis, coverage_init + r_mis, info,
                dict(f_non), dict(r_non))

    def _refine_step(self, primer_list, coverage_init, cover, nn_index,
                     nn_cov, nn):
        """One refinement move (refine_by_NN_array, core.py:922-1089).

        Candidate positions are all minima of the NN-link coverage; each
        candidate merges the best-supported alternative base into an IUPAC
        code and merges the corresponding NN rows/columns.  The reference's
        in-place list aliasing means each candidate's "updated" primer is the
        candidate's own working copy - replicated here with explicit copies.

        Pure-Python int lists: nn is [L-1][4][4] small exact ints, far below
        NumPy per-op overhead.  The candidate order np.argsort(..)[::-1] has
        an unstable, version-specific tie order; _argsort4_desc tabulates
        np.argsort itself over all 4-element rank patterns, so the order is
        exact by construction (fuzz-verified against the NumPy formulation
        in tests/test_design_golden.py)."""
        m = min(nn_cov)
        refine_positions = [i for i, v in enumerate(nn_cov) if v == m]
        cand_primers, cand_cov, cand_nn, cand_nncov = [], [], [], []
        rng4 = (0, 1, 2, 3)
        last = len(nn_index) - 1
        for i in refine_positions:
            # copy-on-write: only layers i and i+1 are ever mutated below;
            # the rest are shared read-only across candidates/iterations
            nn_tmp = list(nn)
            nn_tmp[i] = [r[:] for r in nn[i]]
            if i + 1 < len(nn_tmp):
                nn_tmp[i + 1] = [r[:] for r in nn[i + 1]]
            nncov_tmp = list(nn_cov)
            lst = list(primer_list)
            cov_renew = coverage_init
            row, column = nn_index[i]
            if i == 0:
                li = nn_tmp[0]
                if sum(1 for r in li if r[column] > 0) > 1:
                    order = _argsort4_desc([li[j][column] for j in rng4])
                    for idx in order:
                        if idx != row:
                            merged = iupac.union_char([lst[i], BASES[idx]])
                            lst[i] = BASES[idx]
                            cov_renew += self._coverage_of(lst, cover)
                            lst[i] = merged
                            rr = li[row]
                            ri = li[idx]
                            for j in rng4:
                                rr[j] += ri[j]
                                ri[j] = 0
                            nncov_tmp[i] = rr[column]
                            break
                elif sum(1 for v in li[row] if v > 0) > 1:
                    nrow, ncol = nn_index[i + 1]
                    lnext = nn_tmp[i + 1]
                    rmin = [min(li[row][j], lnext[j][ncol]) for j in rng4]
                    order = _argsort4_desc(rmin)
                    if sum(1 for v in rmin if v > 0) > 1:
                        for idx in order:
                            if idx != column:
                                merged = iupac.union_char(
                                    [lst[i + 1], BASES[idx]])
                                lst[i + 1] = BASES[idx]
                                cov_renew += self._coverage_of(lst, cover)
                                lst[i + 1] = merged
                                for r in li:
                                    r[column] += r[idx]
                                    r[idx] = 0
                                rn = lnext[nrow]
                                rx = lnext[idx]
                                for j in rng4:
                                    rn[j] += rx[j]
                                    rx[j] = 0
                                nncov_tmp[i] = li[row][column]
                                nncov_tmp[i + 1] = rn[ncol]
                                break
            elif i == last:
                li = nn_tmp[i]
                rrow = li[row]
                order = _argsort4_desc(rrow)
                if sum(1 for v in rrow if v > 0) > 1:
                    for idx in order:
                        if idx != column:
                            merged = iupac.union_char([lst[i + 1], BASES[idx]])
                            lst[i + 1] = BASES[idx]
                            cov_renew += self._coverage_of(lst, cover)
                            lst[i + 1] = merged
                            for r in li:
                                r[column] += r[idx]
                                r[idx] = 0
                            nncov_tmp[i] = li[row][column]
                            break
            else:
                nrow, ncol = nn_index[i + 1]
                li = nn_tmp[i]
                lnext = nn_tmp[i + 1]
                rmin = [min(li[row][j], lnext[j][ncol]) for j in rng4]
                order = _argsort4_desc(rmin)
                if sum(1 for v in rmin if v > 0) > 1:
                    for idx in order:
                        if idx != column:
                            merged = iupac.union_char([lst[i + 1], BASES[idx]])
                            lst[i + 1] = BASES[idx]
                            cov_renew += self._coverage_of(lst, cover)
                            lst[i + 1] = merged
                            for r in li:
                                r[column] += r[idx]
                                r[idx] = 0
                            rn = lnext[nrow]
                            rx = lnext[idx]
                            for j in rng4:
                                rn[j] += rx[j]
                                rx[j] = 0
                            nncov_tmp[i] = li[row][column]
                            nncov_tmp[i + 1] = rn[ncol]
                            break
            cand_primers.append(lst)
            cand_nncov.append(nncov_tmp)
            cand_cov.append(cov_renew)
            cand_nn.append(nn_tmp)
        best = cand_cov.index(max(cand_cov))
        chosen = cand_primers[best]
        dege = 1
        n_dege = 0
        for ch in chosen:
            m = _MEMBER_COUNT[ch]
            dege *= m
            if m > 1:
                n_dege += 1
        return (chosen, cand_cov[best], cand_nncov[best], cand_nn[best],
                dege, n_dege)

    @staticmethod
    def _coverage_of(primer_list, cover):
        return sum(cover.get(e, 0)
                   for e in iupac.expand("".join(primer_list)) if e in cover)

    def _mis_primer_check(self, keys, key_chars, counts, optimal_primer,
                          non_gap_seq_id):
        """Mismatch coverage with forbidden 3'/5' positions, vectorised over
        the distinct cover keys.

        v20/v16: per-position forbidden sets (mis_primer_check,
        core.py:1103-1130).  v15: margin-based, asymmetric F/R bookkeeping
        including the quirk that a 3'-region mismatch adds the key to
        F_non_cover while still counting it for R (core_V15.py:1161-1197).
        """
        p = self.p
        plen = len(optimal_primer)
        optimal_set = set(iupac.expand(optimal_primer))
        pa = np.frombuffer(optimal_primer.encode(), np.uint8)
        # not-covered matrix over all keys at once: [K, plen]
        mis = ~self._covered[pa[None, :], key_chars]
        nmis = mis.sum(axis=1).tolist()     # plain ints: the per-key loop
        # below indexes these thousands of times; ndarray scalar boxing
        # costs more than the whole vector pass
        f_non, r_non = {}, {}
        f_mis = r_mis = 0
        # The reference iterates ``set(cover.keys()) - optimal_primer_set``
        # (core.py:765,1106-1109), so its F/R non-cover JSON key order
        # follows CPython's per-process randomized set layout — the one
        # byte stream in its output contract that differs between two runs
        # of the SAME reference script.  We iterate in first-occurrence
        # (insertion) order instead: every derived value (mis counts,
        # pairing unions, coverage) is order-insensitive, the JSON mappings
        # are semantically identical, and our sidecars become byte-stable
        # across processes — which the sharded fan-out byte-parity relies
        # on (shadow tests compare sidecars via json.loads for this reason).
        key_index = {k: i for i, k in enumerate(keys)}
        uncover_iter = [k for k in keys if k not in optimal_set]
        if p.algo == "v15":
            margin = p.position_margin
            pos = np.arange(plen)
            lo_bad = (mis & (pos < margin)[None, :]).any(axis=1).tolist()
            hi_bad = (mis & (pos > plen - margin)[None, :]).any(axis=1).tolist()
            for key in uncover_iter:
                i = key_index[key]
                if nmis[i] > p.variation:
                    f_non[key] = non_gap_seq_id[key]
                    r_non[key] = non_gap_seq_id[key]
                elif lo_bad[i]:
                    r_non[key] = non_gap_seq_id[key]
                    if hi_bad[i]:
                        f_non[key] = non_gap_seq_id[key]
                    else:
                        f_mis += counts[i]
                else:
                    if hi_bad[i]:
                        f_non[key] = non_gap_seq_id[key]
                        r_mis += counts[i]
                    else:
                        f_mis += counts[i]
                        r_mis += counts[i]
        else:
            f_bad = (mis & self._y_strict_arr[None, :]).any(axis=1).tolist()
            r_bad = (mis & self._y_strict_r_arr[None, :]).any(axis=1).tolist()
            for key in uncover_iter:
                i = key_index[key]
                if nmis[i] > p.variation:
                    f_non[key] = non_gap_seq_id[key]
                    r_non[key] = non_gap_seq_id[key]
                else:
                    if f_bad[i]:
                        f_non[key] = non_gap_seq_id[key]
                    else:
                        f_mis += counts[i]
                    if r_bad[i]:
                        r_non[key] = non_gap_seq_id[key]
                    else:
                        r_mis += counts[i]
        return f_mis, f_non, r_mis, r_non


_FORK_WORKER = None


def _call_fork_worker(chunk):
    return _FORK_WORKER(chunk)


class _DesignWorker:
    """Per-chunk design worker, reached in children through the fork-inherited
    `_FORK_WORKER` module global (never pickled per task)."""

    def __init__(self, engine, extractor, seq_ids, n, threshold):
        self.engine = engine
        self.extractor = extractor
        self.seq_ids = seq_ids
        self.n = n
        self.threshold = threshold

    def __call__(self, chunk):
        out = []
        wins = self.extractor.windows(chunk)
        gap_blk = (wins == ord("-")).sum(axis=2)
        imp_blk = _IMPURE_TABLE[wins].any(axis=2)
        same_blk = (wins == wins[:1]).all(axis=(0, 2))
        for wi, position in enumerate(chunk):
            res = self.engine._design_window(
                int(position), wins[:, wi, :], self.seq_ids, self.n,
                self.threshold, gates=(gap_blk[:, wi], imp_blk[:, wi],
                                       bool(same_blk[wi])))
            if res is not None:
                out.append(res)
        return out


import functools


@functools.lru_cache(maxsize=100000)
def _substring_maxstart_cached(primer, min_len=5):
    """{substring: max start offset} over all expansions, lengths
    min_len..len(primer).  Every expansion of any primer substring / suffix
    is a substring of some full expansion, so one index serves the hairpin
    and self-dimer scans.  Cached per primer string — the pairing engine
    consults the same primers across thousands of pair candidates."""
    idx = {}
    for exp in iupac.expand(primer):
        n = len(exp)
        for start in range(n):
            hi = n - start
            for ln in range(min_len, hi + 1):
                sub = exp[start:start + ln]
                prev = idx.get(sub, -1)
                if start > prev:
                    idx[sub] = start
    return idx


def _viterbi(freq, nn):
    """Max-sum consensus path over the frequency/NN tensors
    (get_optimal_primer_by_viterbi, core.py:579-593).  Integer exact;
    ties resolve to the lowest base index like np.argmax.

    Native int64 DP when the library is available (exact same arithmetic
    and tie rule, fuzz-tested); pure-Python int loop otherwise — the DP is
    4 states x primer_len steps, far below NumPy's per-call overhead (the
    node/transition scores are exact small ints)."""
    out = native.viterbi_path(freq, nn)
    if out is not None:
        return out
    nodes = freq.T.tolist()              # [L][4] ints
    trans = nn.tolist()                  # [L-1][4][4]
    length = len(nodes)
    scores = nodes[0]
    backptr = [None] * length
    for t in range(1, length):
        tr = trans[t - 1]
        nd = nodes[t]
        s0, s1, s2, s3 = scores
        new = [0, 0, 0, 0]
        bp = [0, 0, 0, 0]
        for j in range(4):
            best = s0 + tr[0][j]
            bi = 0
            v = s1 + tr[1][j]
            if v > best:
                best, bi = v, 1
            v = s2 + tr[2][j]
            if v > best:
                best, bi = v, 2
            v = s3 + tr[3][j]
            if v > best:
                best, bi = v, 3
            new[j] = best + nd[j]
            bp[j] = bi
        scores = new
        backptr[t] = bp
    best = scores[0]
    bi = 0
    for j in range(1, 4):
        if scores[j] > best:
            best, bi = scores[j], j
    path = [0] * length
    path[-1] = bi
    for t in range(length - 1, 0, -1):
        path[t - 1] = backptr[t][path[t]]
    return np.array(path, dtype=np.int64)


HEADERS = ["Position", "Entropy of cover (bit)", "Entropy of total (bit)",
           "Optimal_primer", "primer_degenerate_number",
           "nonsense_primer_number", "Optimal_coverage", "Mis-F-coverage",
           "Mis-R-coverage", "Tm", "Information"]


_JSON_PLAIN = None


def _fast_json_dump(obj, fh):
    """json.dump(obj, fh, indent=4) byte-identical, ~6x faster.

    json.dump with indent streams through the pure-Python _iterencode
    generator (the C encoder only serves the one-shot no-indent path),
    which dominated the design wall-clock: the two sidecars carry ~700k
    accession strings.  This builds the exact indent=4 rendering with
    join-based loops for the int/str-keyed dict-of-nested-string-lists
    shape the sidecars have, delegating any string needing escapes to
    json.dumps and any non-conforming value to the stock encoder."""
    import json
    import re
    global _JSON_PLAIN
    if _JSON_PLAIN is None:
        _JSON_PLAIN = re.compile(r'[^ !#-\[\]-~]').search  # " or \ or non-ascii

    parts = []
    add = parts.append

    def emit(v, ind):
        if isinstance(v, str):
            if _JSON_PLAIN(v) is None:
                add('"' + v + '"')
            else:
                add(json.dumps(v))
        elif isinstance(v, list):
            if not v:
                add("[]")
            else:
                nxt = ind + "    "
                # dominant shape: a list of plain accession strings — one
                # C-speed plainness scan + one join instead of a per-item
                # Python loop (space is in the plain class, '"' is not, so
                # a clean space-join proves every element clean)
                try:
                    joined = " ".join(v)
                except TypeError:
                    joined = None
                if joined is not None and _JSON_PLAIN(joined) is None:
                    add('[\n' + nxt + '"'
                        + ('",\n' + nxt + '"').join(v)
                        + '"\n' + ind + ']')
                    return
                add("[\n" + nxt)
                last = len(v) - 1
                for i, item in enumerate(v):
                    emit(item, nxt)
                    add(",\n" + nxt if i != last else "\n" + ind + "]")
        elif isinstance(v, bool) or not isinstance(v, (int, dict)):
            add(json.dumps(v, indent=4).replace(
                "\n", "\n" + ind))  # rare fallback, keeps relative indent
        elif isinstance(v, int):
            add(str(v))
        else:
            if not v:
                add("{}")
                return
            add("{\n")
            nxt = ind + "    "
            last = len(v) - 1
            for i, (k, val) in enumerate(v.items()):
                key = k if isinstance(k, str) else str(k)
                if _JSON_PLAIN(key) is None:
                    add(nxt + '"' + key + '": ')
                else:
                    add(nxt + json.dumps(key) + ": ")
                emit(val, nxt)
                add(",\n" if i != last else "\n" + ind + "}")

    emit(obj, "")
    fh.write("".join(parts))


def write_table(results, outfile):
    """The .top.primer.out TSV (core.py:1146-1152).  v2 rows carry the
    extra degeneracy column after primer_degenerate_number."""
    results = sorted(results, key=lambda r: r.position)
    v2 = results and hasattr(results[0], "degeneracy")
    headers = HEADERS if not v2 else \
        HEADERS[:5] + ["degeneracy"] + HEADERS[5:]
    with open(outfile, "w") as fo:
        fo.write("\t".join(headers) + "\n")
        for r in results:
            row = r.row()[1:]
            if v2:
                row = row[:4] + [r.degeneracy] + row[4:]
            fo.write(str(r.position) + "\t"
                     + "\t".join(map(str, row)) + "\n")


def write_sidecars(results, outfile):
    """The two JSON sidecars (core.py:1172-1177 formats).  Pure function
    of `results` — safe to run on a background thread while pairing
    consumes the same results in memory (pairing only reads them)."""
    results = sorted(results, key=lambda r: r.position)
    with open(outfile + ".non_coverage_seq_id_json", "w") as fj:
        _fast_json_dump({r.position: [r.f_non_cover, r.r_non_cover]
                         for r in results}, fj)
    with open(outfile + ".gap_seq_id_json", "w") as fg:
        _fast_json_dump({r.position: r.gap_ids for r in results}, fg)


def clear_memo_caches():
    """Reset the per-primer lru_cache memos (design, pairing, thermo,
    IUPAC).  Primer strings rarely repeat across clusters, so in a
    many-cluster fan-out the caches only grow: ~1.3 MB/cluster RSS and a
    gen-2 GC walk that made cluster #300 ~30% slower than cluster #1 in a
    300-singleton test.  The pipeline driver calls this between clusters;
    bench.py calls it between timed runs."""
    from ..thermo import exact as _thermo
    from ..utils import iupac as _iupac
    from . import pairing as _pairing
    for mod in (globals(), vars(_pairing), vars(_thermo), vars(_iupac)):
        for obj in (mod.values() if isinstance(mod, dict) else mod):
            if hasattr(obj, "cache_clear"):
                obj.cache_clear()


def fork_safe():
    """True when os.fork is available and CUDA is not initialised in this
    process (a CUDA context does not survive fork) — the shared probe for
    every fork-based fan-out (sidecar writer, the pipeline driver's pools)."""
    import sys
    if not hasattr(os, "fork"):
        return False
    torch = sys.modules.get("torch")
    return torch is None or not torch.cuda.is_initialized()


def write_sidecars_forked(results, outfile):
    """Write the JSON sidecars in a forked child so the (CPU-bound) JSON
    emit genuinely overlaps the parent's pairing — a background *thread*
    just timeshares the GIL with pairing and measures slower than running
    the two sequentially.  Returns an idempotent waiter callable; falls
    back to a synchronous write when fork is unsafe (CUDA initialised) or
    unavailable."""
    if not fork_safe():
        write_sidecars(results, outfile)
        return lambda: None
    # Small payloads write faster than a fork costs (~5 ms of JSON vs
    # ~15-25 ms of fork+waitpid for a singleton cluster); only overlap
    # when the JSON volume justifies it.
    payload = sum(len(r.f_non_cover) + len(r.r_non_cover) + len(r.gap_ids)
                  for r in results)
    if payload + len(results) < 5000:
        write_sidecars(results, outfile)
        return lambda: None
    pid = os.fork()
    if pid == 0:
        code = 1
        try:
            write_sidecars(results, outfile)
            code = 0
        finally:
            os._exit(code)
    done = []

    def wait():
        if done:                       # idempotent, like Thread.join
            return
        done.append(True)
        _, status = os.waitpid(pid, 0)
        if status != 0:
            # deterministic fallback: redo in-process
            write_sidecars(results, outfile)
    return wait


def pairing_inputs(results):
    """(gap_ids, non_cover) dicts exactly as a json.load of the sidecars
    would yield them, minus the serialize/parse round-trip: the payloads
    are accession strings and plain dicts/lists, so identity is exact
    (int keys instead of JSON's stringified ones — pairing falls back to
    int-key lookup)."""
    gap_ids = {r.position: r.gap_ids for r in results}
    non_cover = {r.position: [r.f_non_cover, r.r_non_cover]
                 for r in results}
    return gap_ids, non_cover


def write_outputs(results, outfile):
    """Write the .top.primer.out TSV and the two JSON sidecars with the
    reference's formats (core.py:1146-1177)."""
    write_table(results, outfile)
    write_sidecars(results, outfile)
