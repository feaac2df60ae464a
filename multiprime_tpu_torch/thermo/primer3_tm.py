# Copied from multiprime_tpu/thermo/primer3_tm.py (host code, no JAX).
"""Native re-implementation of primer3's oligotm / seqtm Tm calculator.

Role: the reference cross-validates its own ``Calc_Tm_v2`` against the
primer3 C library through ``CalcTm_primer3.py`` (reference
scripts/CalcTm_primer3.py:133-142, a thin wrapper over ``primer3.calcTm``
with CLI defaults mv=50 mM, dv=1.5 mM, dntp=0.6 mM, dna=150 nM).  The
primer3 C library is not present in this image, so the cross-check is
re-derived from the published algorithm (SantaLucia PNAS 1998 unified NN
parameters; Owczarzy 2004/2008 and SantaLucia salt corrections; the
oligotm.c accumulation/branch structure of primer3 2.6.1) as a second,
independent implementation — independent in the sense that it shares no
code path with ``thermo/exact.py``'s reference-quirk-faithful scalar Tm
(notably: *correct* reverse-complement symmetry detection where the
reference's ``symmetry()`` is elementwise-buggy, and the full Owczarzy
eq-16 correction where the reference's Calc_Tm_v2 silently drops the
GC/length terms).  Disagreement between the two flags table or branch
regressions exactly the way the reference's primer3 cross-check did.

Semantics mirrored from oligotm.c:

* NN sums accumulate as integers in 0.1-unit steps (dh in -100 cal units,
  ds in -0.1 eu units) and are scaled once at the end.
* ``len`` in the salt formulas is ``strlen - 1`` (phosphate count).
* divalent cations convert to equivalent monovalent via
  ``120 * sqrt(dv - dntp)`` for the schildkraut/santalucia corrections
  (dv==0 forces dntp=0; dv<dntp clamps to dntp), but stay separate for
  owczarzy, which uses free Mg2+ = (dv - dntp)/1000 with the 0.22 / 6.0
  crossover-ratio regimes.
* sequences longer than ``max_nn_length`` (60) use the GC-fraction
  long-sequence formula 81.5 + 16.6 log10(Na) + 41 fGC - 600/len.
* non-ACGT characters yield ``OLIGOTM_ERROR`` exactly like the C library
  (the reference script would print that value for degenerate primers);
  ``calc_tm_degenerate`` averages expansions instead as a documented
  extension.
"""

import math

from ..utils import iupac
from . import tables as tb

OLIGOTM_ERROR = -999999.9999
MAX_NN_LENGTH = 60
R_CAL = 1.987          # gas constant used by oligotm.c, cal/(K*mol)
T_KELVIN = 273.15

_IDX = {"A": 0, "C": 1, "G": 2, "T": 3}

# Integer deci-unit NN tables exactly as oligotm.c stores them: positive
# ints, negated and scaled on use (delta_H = dh * -100 cal/mol, delta_S =
# ds * -0.1 eu).  Built from the shared published SantaLucia 1998 tables so
# the constants cannot drift between the two implementations.
_DH_INT = [[int(round(tb.DH[i][j] * -10)) for j in range(4)] for i in range(4)]
_DS_INT = [[int(round(tb.DS[i][j] * -10)) for j in range(4)] for i in range(4)]

_COMPL = {"A": "T", "T": "A", "C": "G", "G": "C"}


def symmetry(seq: str) -> bool:
    """True reverse-complement palindrome test (oligotm.c symmetry()):
    even length and every s[i] complementary to s[len-1-i].  NOT the
    reference's elementwise-buggy version (see exact.is_symmetric)."""
    n = len(seq)
    if n % 2 == 1:
        return False
    for i in range(n // 2):
        if _COMPL.get(seq[i]) != seq[n - 1 - i]:
            return False
    return True


def divalent_to_monovalent(divalent: float, dntp: float) -> float:
    """oligotm.c divalent_to_monovalent: 120*sqrt(dv-dntp) mM."""
    if divalent == 0:
        dntp = 0
    if divalent < 0 or dntp < 0:
        raise ValueError("negative ion concentration")
    if divalent < dntp:
        divalent = dntp
    return 120 * math.sqrt(divalent - dntp)


def long_seq_tm(seq: str, salt_mM: float, dv_mM: float, dntp_mM: float) -> float:
    """GC-fraction formula for sequences beyond the NN model's range."""
    gc = sum(1 for c in seq if c in "GC")
    salt = salt_mM + divalent_to_monovalent(dv_mM, dntp_mM)
    length = len(seq)
    return (81.5 + (16.6 * math.log10(salt / 1000.0))
            + (41.0 * gc / length) - (600.0 / length))


def calc_tm(seq: str, mv_conc: float = 50.0, dv_conc: float = 0.0,
            dntp_conc: float = 0.8, dna_conc: float = 50.0,
            salt_corrections_method: str = "santalucia",
            max_nn_length: int = MAX_NN_LENGTH) -> float:
    """primer3.calcTm equivalent (tm_method=santalucia).

    Returns OLIGOTM_ERROR for sequences containing non-ACGT characters,
    like the C library."""
    seq = seq.upper()
    if len(seq) > max_nn_length:
        if any(c not in _IDX for c in seq):
            return OLIGOTM_ERROR
        return long_seq_tm(seq, mv_conc, dv_conc, dntp_conc)
    if len(seq) < 2 or any(c not in _IDX for c in seq):
        return OLIGOTM_ERROR

    dh = 0
    ds = 0
    gc_count = 0
    for c in (seq[0], seq[-1]):          # terminal initiation, each end
        if c in "AT":
            ds += -41
            dh += -23
        else:
            ds += 28
            dh += -1
    sym = symmetry(seq)
    if sym:
        ds += 14
    for n in range(len(seq) - 1):
        i, j = _IDX[seq[n + 1]], _IDX[seq[n]]
        dh += _DH_INT[i][j]
        ds += _DS_INT[i][j]
    gc_count = sum(1 for c in seq if c in "GC")

    delta_h = dh * -100.0                # cal/mol
    delta_s = ds * -0.1                  # cal/(K*mol)
    length = len(seq) - 1                # phosphate count, per oligotm.c

    mono = mv_conc
    if salt_corrections_method != "owczarzy":
        mono += divalent_to_monovalent(dv_conc, dntp_conc)
    ct_denom = 1e9 if sym else 4e9

    if salt_corrections_method == "schildkraut":
        tm = (delta_h / (delta_s + R_CAL * math.log(dna_conc / ct_denom))
              - T_KELVIN + 16.6 * math.log10(mono / 1000.0))
    elif salt_corrections_method == "santalucia":
        delta_s = delta_s + 0.368 * length * math.log(mono / 1000.0)
        tm = (delta_h / (delta_s + R_CAL * math.log(dna_conc / ct_denom))
              - T_KELVIN)
    elif salt_corrections_method == "owczarzy":
        gc_frac = gc_count / (length + 1)
        # free divalent cations; dNTPs chelate Mg2+ 1:1
        if dntp_conc >= dv_conc and dntp_conc > 0.0:
            free_divalent = 0.00000000001
        else:
            free_divalent = (dv_conc - dntp_conc) / 1000.0
        a = 3.92e-5
        b = -9.11e-6
        c = 6.26e-5
        d = 1.42e-5
        e = -4.82e-4
        f = 5.25e-4
        g = 8.31e-5
        if mono == 0:
            crossover = True             # pure-Mg eq 16
        else:
            ratio = math.sqrt(free_divalent) / (mono / 1000.0)
            crossover = ratio >= tb.CROSSOVER_POINT
            if crossover and ratio < 6.0:
                ln_na = math.log(mono / 1000.0)
                a = 3.92e-5 * (
                    0.843 - 0.352 * math.sqrt(mono / 1000.0) * ln_na)
                d = 1.42e-5 * (
                    1.279 - 4.03e-3 * ln_na - 8.03e-3 * ln_na * ln_na)
                g = 8.31e-5 * (
                    0.486 - 0.258 * ln_na + 5.25e-3 * ln_na ** 3)
        if crossover:
            ln_mg = math.log(free_divalent)
            correction = (a + b * ln_mg + gc_frac * (c + d * ln_mg)
                          + (1 / (2.0 * length))
                          * (e + f * ln_mg + g * ln_mg * ln_mg))
        else:
            ln_na = math.log(mono / 1000.0)
            correction = ((4.29 * gc_frac - 3.95) * 1e-5 * ln_na
                          + 9.40e-6 * ln_na * ln_na)
        tm_nosalt = delta_h / (delta_s + R_CAL * math.log(dna_conc / ct_denom))
        tm = 1 / (1 / tm_nosalt + correction) - T_KELVIN
    else:
        raise ValueError(
            "unknown salt_corrections_method: %r" % salt_corrections_method)
    return tm


def calc_tm_degenerate(primer: str, **kw) -> float:
    """Mean Tm over IUPAC expansions (extension — the C library errors)."""
    vals = [calc_tm(s, **kw) for s in iupac.expand(primer.upper())]
    if any(v == OLIGOTM_ERROR for v in vals):
        return OLIGOTM_ERROR
    return sum(vals) / len(vals)
