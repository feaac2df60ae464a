# Copied from multiprime_tpu/thermo/exact.py (host code, no JAX).
"""Bit-exact host thermodynamics matching the reference implementations.

These scalar functions reproduce, operation-for-operation, the float behaviour
of the reference's ``Calc_Tm_v2`` / ``deltaG`` (multiPrime-core.py:249-336,
:466-485) including its known quirks:

* In ``Calc_Tm_v2`` the magnesium-branch correction drops the GC and length
  terms: lines 324-326 of the reference are free-standing expression
  statements (a stray-semicolon style bug), so only ``a + b*ln(free_divalent)``
  contributes.  With the hard-coded PCR concentrations the magnesium branch is
  always taken, making the correction a sequence-independent constant.  We
  replicate exactly.
* ``get_multiPrime.py``'s ``deltaG`` (:399-416) omits the 3'-terminal
  initiation adjustment that the core/finDimer variants include; the
  ``both_ends`` flag selects which variant is reproduced.

Everything is memoized: across a design run only a few 10k distinct
expansions occur, so the scalar paths are cheap; the batched JAX versions in
``multiprime_tpu.thermo.batched`` are used for throughput-mode scoring.
"""

from __future__ import annotations

import math
from functools import lru_cache

from . import tables as tb
from ..utils import iupac

_BIT = tb.BASE_INDEX


@lru_cache(maxsize=None)
def is_symmetric(seq: str) -> bool:
    """The reference's ``symmetry()`` (multiPrime-core.py:237-246, identical
    in CalcTm.py:141-150 and finDimer.py:115-124): it computes
    ``RC(second_half[::-1])`` — but RC/complement there ALSO reverses, so the
    two reversals cancel and the effective condition is first half ==
    ELEMENTWISE complement of the second half (position i pairs with
    position half+i), NOT the true reverse-complement palindrome.
    Kept bug-for-bug: e.g. ATGCAT (a real RC-palindrome) is NOT "symmetric"
    here, while ACGTGC (halves ACG / TGC, elementwise complements) is."""
    if len(seq) % 2 == 1:
        return False
    half = len(seq) // 2
    # rc() reverses; undo that to get the plain elementwise complement.
    return seq[:half] == iupac.rc(seq[half:])[::-1]


@lru_cache(maxsize=None)
def delta_h_s(seq: str) -> tuple:
    """Sequential-order dH (cal/mol) and dS accumulation (core.py:249-261)."""
    dh = 0.0
    ds = 0.0
    for n in range(len(seq) - 1):
        i, j = _BIT[seq[n + 1]], _BIT[seq[n]]
        dh += tb.DH_L[i][j]
        ds += tb.DS_L[i][j]
    s = seq.replace("#", "")
    dh += tb.DH_INIT[s[0]] + tb.DH_INIT[s[-1]]
    ds += tb.DS_INIT[s[0]] + tb.DS_INIT[s[-1]]
    if is_symmetric(s):
        ds += tb.DS_SYMMETRY
    return dh * 1000, ds


def _tm_salt_correction() -> float:
    """The (constant) salt correction actually produced by the reference's
    buggy magnesium branch, computed with the identical float operations."""
    mono = tb.MONOVALENT_MM
    if tb.DNTP_MM >= tb.DIVALENT_MM:
        free_divalent = 0.00000000001
    else:
        free_divalent = (tb.DIVALENT_MM - tb.DNTP_MM) / 1000.0
    ratio = math.sqrt(free_divalent) / (mono / 1000)
    if ratio < tb.CROSSOVER_POINT:  # pragma: no cover - dead with defaults
        raise AssertionError("monovalent branch is sequence-dependent; "
                             "handled in tm() directly")
    a = 3.92 * pow(10, -5)
    b = -9.11 * pow(10, -6)
    if ratio < 6.0:
        a = 3.92 * pow(10, -5) * (
            0.843 - (0.352 * math.sqrt(mono / 1000.0) * math.log(mono / 1000.0, math.e)))
    # GC-content and length terms are *discarded* by the reference's bug.
    return a + (b * math.log(free_divalent, math.e))


_MG_CORRECTION = _tm_salt_correction()


@lru_cache(maxsize=None)
def tm(seq: str) -> float:
    """Melting temperature of a non-degenerate sequence (Calc_Tm_v2)."""
    dh, ds = delta_h_s(seq)
    correction = _MG_CORRECTION
    conc = tb.PRIMER_CONC_NG_UL
    if is_symmetric(seq):
        return round(
            1 / ((1 / (dh / (ds + 1.9872 * math.log(conc / (1 * pow(10, 9)), math.e))))
                 + correction) - tb.KELVIN, 2)
    return round(
        1 / ((1 / (dh / (ds + 1.9872 * math.log(conc / (4 * pow(10, 9)), math.e))))
             + correction) - tb.KELVIN, 2)


@lru_cache(maxsize=None)
def tm_degenerate_mean(primer: str) -> float:
    """Mean Tm over all expansions, rounded like the reference
    (multiPrime-core.py:848-852 uses statistics.mean + round)."""
    expansions = iupac.expand(primer)
    values = None
    if "#" not in primer:
        from .. import native
        values = native.tm_batch(expansions)   # exact port incl. round(x,2)
    if values is None:
        values = [tm(s) for s in expansions]
    return round(_stat_mean(values), 2)


def _stat_mean(values) -> float:
    # statistics.mean uses exact rational arithmetic over floats.  Every
    # finite float is m / 2**k, so the exact sum is integer math over the
    # largest denominator; CPython's int/int true division is correctly
    # rounded, identical to float(Fraction(num, den)) — bit-parity without
    # per-element Fraction/gcd overhead.
    if len(values) == 1:
        # mean of [x] is exactly x (the rational reduces to x itself);
        # most windows expand to a single sequence, so this is the hot case
        return float(values[0])
    if len(values) == 2:
        # a+b rounds once and halving is an exact scaling that commutes
        # with round-to-nearest, so (a+b)/2 == float(Fraction(a+b, 2)) for
        # finite sums — the per-emitted-pair avg-Tm hot case
        s = float(values[0]) + float(values[1])
        if math.isfinite(s):
            return s / 2.0
    nums = []
    dens = []
    max_d = 1
    for v in values:
        n, d = float(v).as_integer_ratio()
        nums.append(n)
        dens.append(d)
        if d > max_d:
            max_d = d
    total = 0
    for n, d in zip(nums, dens):
        total += n * (max_d // d)
    return total / (max_d * len(nums))


@lru_cache(maxsize=None)
def delta_g(sequence: str, both_ends: bool = True) -> float:
    """Zacharias-model dG of a (possibly degenerate) sequence: max over
    expansions, rounded to 2 (core.py:466-485 / get_multiPrime.py:399-416)."""
    na = 50
    out = []
    for seq in iupac.expand(sequence):
        dg = 0.0
        for n in range(len(seq) - 1):
            i, j = _BIT[seq[n + 1]], _BIT[seq[n]]
            dg += tb.ZACH_FREE_L[i][j] * tb.ZACH_HBONDS_L[i][j] + tb.ZACH_PENALTY_L[i][j]
        term5 = sequence[-2:]
        if both_ends:
            if term5 == "TA":
                dg += tb.ZACH_INIT[seq[0]] + tb.ZACH_INIT[seq[-1]] + tb.ZACH_TERMINAL_TA
            else:
                dg += tb.ZACH_INIT[seq[0]] + tb.ZACH_INIT[seq[-1]]
        else:
            if term5 == "TA":
                dg += tb.ZACH_INIT[seq[0]] + tb.ZACH_TERMINAL_TA
            else:
                dg += tb.ZACH_INIT[seq[0]]
        dg -= (0.175 * math.log(na / 1000, math.e) + 0.20) * len(seq)
        if is_symmetric(seq):
            dg += tb.ZACH_SYMMETRY
        out.append(dg)
    return round(max(out), 2)


def gc_fraction(seq: str) -> float:
    """round((G+C)/len, 3) (core.py:277-278)."""
    return round((seq.count("G") + seq.count("C")) / len(seq), 3)


def tm_conditions(seq: str, mono=50.0, div=1.5, dntp=0.25, conc=100.0) -> float:
    """Calc_Tm_v2 with CLI-settable conditions (CalcTm.py:195-257), keeping
    the reference's magnesium-branch bug (GC/length terms discarded)."""
    dh, ds = delta_h_s(seq)
    if dntp >= div:
        free_divalent = 0.00000000001
    else:
        free_divalent = (div - dntp) / 1000.0
    ratio = math.sqrt(free_divalent) / (mono / 1000)
    if ratio < tb.CROSSOVER_POINT:
        ln_na = math.log(mono / 1000.0, math.e)
        correction = (((4.29 * gc_fraction(seq)) - 3.95) * pow(10, -5) * ln_na) \
            + (9.40 * pow(10, -6) * pow(ln_na, 2))
    else:
        a = 3.92 * pow(10, -5)
        b = -9.11 * pow(10, -6)
        if ratio < 6.0:
            a = 3.92 * pow(10, -5) * (
                0.843 - (0.352 * math.sqrt(mono / 1000.0)
                         * math.log(mono / 1000.0, math.e)))
        correction = a + (b * math.log(free_divalent, math.e))
    factor = 1 if is_symmetric(seq) else 4
    return round(
        1 / ((1 / (dh / (ds + 1.9872 * math.log(
            conc / (factor * pow(10, 9)), math.e)))) + correction)
        - tb.KELVIN, 2)


def delta_g_cli(sequence: str, mode="unified") -> float:
    """free_energy.py:151-187 semantics, including its quirks: dG accumulates
    ACROSS expansions without reset, and "symmetry" means palindrome
    (seq == seq[::-1]), unlike the core's RC-symmetry."""
    from ..utils import iupac
    na = 50
    out = []
    dg = 0.0
    for seq in iupac.expand(sequence):
        if mode == "unified":
            for n in range(len(seq) - 1):
                i, j = _BIT[seq[n + 1]], _BIT[seq[n]]
                dg += tb.DG37_L[i][j]
        else:
            for n in range(len(seq) - 1):
                i, j = _BIT[seq[n + 1]], _BIT[seq[n]]
                dg += tb.ZACH_FREE_L[i][j] * tb.ZACH_HBONDS_L[i][j] \
                    + tb.ZACH_PENALTY_L[i][j]
        term5 = seq[-2:] if mode == "unified" else sequence[-2:]
        if term5 == "TA":
            dg += tb.ZACH_INIT[seq[0]] + tb.ZACH_INIT[seq[-1]] \
                + tb.ZACH_TERMINAL_TA
        else:
            dg += tb.ZACH_INIT[seq[0]] + tb.ZACH_INIT[seq[-1]]
        dg -= (0.175 * math.log(na / 1000, math.e) + 0.20) * len(seq)
        if seq == seq[::-1]:
            dg += tb.ZACH_SYMMETRY
        out.append(dg)
    return round(max(out), 2)


@lru_cache(maxsize=None)
def gc_degenerate_mean(primer: str) -> float:
    """Mean GC over expansions rounded to 2 (core.py:401-407)."""
    values = [gc_fraction(s) for s in iupac.expand(primer)]
    return round(_stat_mean(values), 2)


@lru_cache(maxsize=200000)
def gc_degenerate_mean_unrounded(primer: str) -> float:
    """statistics.mean without the final round (get_multiPrime.py:453-459)."""
    values = [gc_fraction(s) for s in iupac.expand(primer)]
    return _stat_mean(values)


@lru_cache(maxsize=None)
def entropy_term(count: int, denom: int) -> float:
    """(c/d) * log2(c/d) with the reference's math.log(x, 2) semantics."""
    frac = count / denom
    return frac * math.log(frac, 2)


def shannon_pair(cover_counts, cover_number, gap_counts, gap_number):
    """(cBit, tBit) entropies (multiPrime-core.py:602-614).

    cBit is over covered windows only; tBit over covered + gappy windows.
    Sequential accumulation order preserved (cover first, then gaps).
    """
    c_bit = 0.0
    t_bit = 0.0
    total = cover_number + gap_number
    for c in cover_counts:
        c_bit += entropy_term(c, cover_number)
        t_bit += entropy_term(c, total)
    for g in gap_counts:
        t_bit += entropy_term(g, total)
    return round(-c_bit, 2), round(-t_bit, 2)


def penalty_points(length: int, gc: int, d1: int, d2: int) -> float:
    """SADDLE-style dimer loss (multiPrime-core.py:192-193)."""
    return math.log10((2 ** length * 2 ** gc) / ((2 ** d1 - 0.9) * (2 ** d2 - 0.9)))


def penalty_points_linear(length: int, gc: int, d1: int, d2: int) -> float:
    """Older linear-denominator loss (multiPrime-core_V15.py:240-242, also
    primer_coverage_validation_by_BWT.py:149-150)."""
    return math.log10((2 ** length * 2 ** gc) / ((d1 + 0.1) * (d2 + 0.1)))
