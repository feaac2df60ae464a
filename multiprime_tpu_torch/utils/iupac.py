# Copied from multiprime_tpu/utils/iupac.py (host code, no JAX).
"""IUPAC degenerate-base algebra on 4-bit masks.

The reference (joybio/multiPrime) represents degenerate bases as strings and a
fractional "score table" whose values are additive over the member bases
(multiPrime/scripts/multiPrime-core.py:105-124).  Here every base is a
4-bit mask (A=1, C=2, G=4, T=8); a degenerate code is the OR of its members and
a gap is 0.  All string tricks of the reference map onto exact bit algebra:

* degeneracy            -> popcount product
* ``Y_distance``        -> subset test per position (see ``mismatch_positions``)
* score-table merging   -> mask union
* degenerate expansion  -> cartesian product over member lists

Member *order* inside each code matters for bit-parity of expansion order
(e.g. S expands to ["G", "C"], not ["C", "G"]); we keep the reference's
orders (multiPrime-core.py:105-107).
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np

# Mask bits.
A, C, G, T = 1, 2, 4, 8
GAP = 0

# IUPAC code -> ordered member bases, matching multiPrime-core.py:105-107.
CODE_MEMBERS = {
    "-": ["-"],
    "A": ["A"], "G": ["G"], "C": ["C"], "T": ["T"],
    "R": ["A", "G"], "Y": ["C", "T"], "M": ["A", "C"], "K": ["G", "T"],
    "S": ["G", "C"], "W": ["A", "T"],
    "H": ["A", "T", "C"], "B": ["G", "T", "C"], "V": ["G", "A", "C"],
    "D": ["G", "A", "T"], "N": ["A", "T", "G", "C"],
}

BASE_BIT = {"A": A, "C": C, "G": G, "T": T, "-": GAP}

CHAR_TO_MASK = {
    ch: (0 if ch == "-" else sum(BASE_BIT[m] for m in members))
    for ch, members in CODE_MEMBERS.items()
}
MASK_TO_CHAR = {m: ch for ch, m in CHAR_TO_MASK.items() if ch != "-"}
MASK_TO_CHAR[0] = "-"

# Fractional score table (multiPrime-core.py:109-110); kept for the rare spots
# where the reference's numeric degeneracy product (floor of scores) is used.
SCORE_TABLE = {
    "-": 100, "#": 0.00, "A": 1, "G": 1.11, "C": 1.21, "T": 1.40,
    "R": 2.11, "Y": 2.61, "M": 2.21, "K": 2.51, "S": 2.32, "W": 2.40,
    "H": 3.61, "B": 3.72, "V": 3.32, "D": 3.51, "N": 4.72,
}

# ASCII lookup tables for vectorised conversion.
_ASCII_TO_MASK = np.zeros(256, dtype=np.uint8)
for ch, m in CHAR_TO_MASK.items():
    _ASCII_TO_MASK[ord(ch)] = m
_MASK_TO_ASCII = np.zeros(16, dtype=np.uint8)
for m, ch in MASK_TO_CHAR.items():
    _MASK_TO_ASCII[m] = ord(ch)

_POPCNT4 = np.array([bin(i).count("1") for i in range(16)], dtype=np.uint8)

# Reverse complement of a 4-bit mask: swap A<->T bits and C<->G bits.
_COMP4 = np.zeros(16, dtype=np.uint8)
for m in range(16):
    c = 0
    if m & A:
        c |= T
    if m & T:
        c |= A
    if m & C:
        c |= G
    if m & G:
        c |= C
    _COMP4[m] = c

RC_TRANS = str.maketrans("ATGCRYMKSWHBVDN", "TACGYRKMSWDVBHN")
COMP_TRANS = str.maketrans("ATCG", "TAGC")


def seq_to_masks(seq: str) -> np.ndarray:
    """IUPAC string -> uint8 mask vector (unknown chars -> 0/gap)."""
    return _ASCII_TO_MASK[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def masks_to_seq(masks: np.ndarray) -> str:
    return _MASK_TO_ASCII[masks & 15].tobytes().decode("ascii")


def bytes_to_masks(arr: np.ndarray) -> np.ndarray:
    """uint8 ASCII array (any shape) -> mask array."""
    return _ASCII_TO_MASK[arr]


def popcount4(masks: np.ndarray) -> np.ndarray:
    return _POPCNT4[masks & 15]


def comp_masks(masks: np.ndarray) -> np.ndarray:
    return _COMP4[masks & 15]


def rc_masks(masks: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis."""
    return comp_masks(masks)[..., ::-1]


def rc(seq: str) -> str:
    """Reverse complement with IUPAC support (multiPrime-core.py:218-222)."""
    return seq.translate(RC_TRANS)[::-1]


def degeneracy(seq: str) -> int:
    """Product of per-position member counts (score_trans, core.py:210-211)."""
    out = 1
    for ch in seq:
        out *= max(1, int(_POPCNT4[CHAR_TO_MASK.get(ch, 0)])) if ch != "-" else 100
    return out


def degeneracy_masks(masks: np.ndarray) -> int:
    """Degeneracy product over a mask vector; gaps count as 100 like the
    reference's floor(score('-')) == 100."""
    pc = popcount4(masks).astype(object)
    pc[masks == 0] = 100
    out = 1
    for v in pc:
        out *= int(v)
    return out


def num_degenerate_positions(seq: str) -> int:
    """Count of positions whose code has >1 member (dege_number, core.py:214-215).
    Gaps score 100 -> counted as degenerate by the reference; replicated."""
    n = 0
    for ch in seq:
        if ch == "-":
            n += 1
        elif int(_POPCNT4[CHAR_TO_MASK.get(ch, 0)]) > 1:
            n += 1
    return n


_PURE_EXPAND = frozenset("ACGT-")


@lru_cache(maxsize=500000)
def expand(seq: str) -> tuple:
    """All expansions of a degenerate sequence, in the reference's product
    order (degenerate_seq, multiPrime-core.py:368-380).  Gaps stay as '-'."""
    if not (set(seq) - _PURE_EXPAND):
        return (seq,)           # pure/gap-only: expands to itself
    member_lists = []
    for ch in seq:
        member_lists.append(CODE_MEMBERS.get(ch, [ch]))
    return tuple("".join(p) for p in itertools.product(*member_lists))


def expansion_count(seq: str) -> int:
    n = 1
    for ch in seq:
        n *= len(CODE_MEMBERS.get(ch, [ch]))
    return n


def mismatch_positions(primer: str, target: str) -> list:
    """Positions where `target`'s base is NOT covered by `primer`'s code.

    Exact equivalent of the reference's ``Y_distance`` score-subtraction trick
    (multiPrime-core.py:229-233): the fractional score table is additive over
    member bases, so diff-in-table <=> target base is a member of the primer
    code (or both equal).  Gaps on either side are mismatches.
    """
    pm = seq_to_masks(primer)
    tm = seq_to_masks(target)
    covered = (tm != 0) & (pm & tm == tm)
    return np.nonzero(~covered)[0].tolist()


def mismatch_count_matrix(primer_masks: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Vectorised mismatch counts: primer [L] vs targets [N, L] -> [N]."""
    covered = (targets != 0) & ((primer_masks[None, :] & targets) == targets)
    return (~covered).sum(axis=1)


def union_char(chars) -> str:
    """IUPAC code for the union of the given codes (score-table merge)."""
    m = 0
    for ch in chars:
        m |= CHAR_TO_MASK.get(ch, 0)
    return MASK_TO_CHAR[m]
