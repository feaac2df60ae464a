"""IUPAC codes as 4-bit masks (A=1, C=2, G=4, T=8; a gap is 0), the
expansion order of multiPrime-core.py:105-107 and the reverse complement."""

import itertools

import numpy as np

CODE_MEMBERS = {
    "A": "A", "G": "G", "C": "C", "T": "T",
    "R": "AG", "Y": "CT", "M": "AC", "K": "GT", "S": "GC", "W": "AT",
    "H": "ATC", "B": "GTC", "V": "GAC", "D": "GAT", "N": "ATGC",
}
BIT = {"A": 1, "C": 2, "G": 4, "T": 8}
CHAR_TO_MASK = {ch: sum(BIT[m] for m in members)
                for ch, members in CODE_MEMBERS.items()}

ASCII_TO_MASK = np.zeros(256, np.uint8)
for _ch, _m in CHAR_TO_MASK.items():
    ASCII_TO_MASK[ord(_ch)] = _m

# a target base's code: A, C, G, T -> 0..3; anything else matches nothing
ASCII_TO_BASE = np.full(256, 4, np.uint8)
for _i, _ch in enumerate("ACGT"):
    ASCII_TO_BASE[ord(_ch)] = _i

_RC = str.maketrans("ATGCRYMKSWHBVDN", "TACGYRKMSWDVBHN")


def rc(seq):
    """Reverse complement, IUPAC codes included."""
    return seq.translate(_RC)[::-1]


def expand(seq):
    """Every expansion of a degenerate sequence, in the product order of
    the members above."""
    if not set(seq) - set("ACGT-"):
        return (seq,)
    return tuple("".join(p) for p in itertools.product(
        *(CODE_MEMBERS.get(ch, ch) for ch in seq)))


def degeneracy(seq):
    n = 1
    for ch in seq:
        n *= len(CODE_MEMBERS.get(ch, ch))
    return n
