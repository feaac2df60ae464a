# Copied from multiprime_tpu/thermo/tables.py (host code, no JAX).
"""Nearest-neighbor thermodynamic parameter tables.

Values from SantaLucia 1998 (dH/dS at 37C, 1 M NaCl) and Zacharias 2020
(H-bond / stacking decomposition of dG37), as used by the reference
(multiPrime/scripts/multiPrime-core.py:129-183, CalcTm.py:114-136,
free_energy.py:96-134).  Row/column index order is A, C, G, T (+ 5th slot for
the '#' padding symbol in the dH/dS tables).
"""

import numpy as np

# Index order A, C, G, T, '#'
BASE_INDEX = {"A": 0, "C": 1, "G": 2, "T": 3, "#": 4}

# dH (kcal/mol) for dinucleotide step x->y indexed [next, prev] like the
# reference's Htable2[base2bit[seq[n+1]], base2bit[seq[n]]].
DH = np.array([
    [-7.9, -8.5, -8.2, -7.2, 0.0],
    [-8.4, -8.0, -9.8, -8.2, 0.0],
    [-7.8, -10.6, -8.0, -8.5, 0.0],
    [-7.2, -7.8, -8.4, -7.9, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0],
])

DS = np.array([
    [-22.2, -22.7, -22.2, -21.3, 0.0],
    [-22.4, -19.9, -24.4, -22.2, 0.0],
    [-21.0, -27.2, -19.9, -22.7, 0.0],
    [-20.4, -21.0, -22.4, -22.2, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0],
])

DG37 = np.array([
    [-1.0, -1.45, -1.3, -0.58, 0.0],
    [-1.44, -1.84, -2.24, -1.3, 0.0],
    [-1.28, -2.17, -1.84, -1.45, 0.0],
    [-0.88, -1.28, -1.44, -1.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0],
])

DH_INIT = {"A": 2.3, "T": 2.3, "C": 0.1, "G": 0.1}
DS_INIT = {"A": 4.1, "T": 4.1, "C": -2.8, "G": -2.8}
DG_INIT = {"A": 1.03, "T": 1.03, "C": 0.98, "G": 0.98}
DS_SYMMETRY = -1.4
DG_SYMMETRY = 0.4

# Zacharias 2020 decomposition: dG = stack_free * n_hbonds + stack_penalty.
ZACH_FREE = np.array([
    [-0.7, -0.81, -0.65, -0.65],
    [-0.67, -0.72, -0.8, -0.65],
    [-0.69, -0.87, -0.72, -0.81],
    [-0.61, -0.69, -0.67, -0.7],
])
ZACH_PENALTY = np.array([
    [0.4, 0.575, 0.33, 0.73],
    [0.23, 0.32, 0.17, 0.33],
    [0.41, 0.45, 0.32, 0.575],
    [0.33, 0.41, 0.23, 0.4],
])
ZACH_HBONDS = np.array([
    [2.0, 2.5, 2.5, 2.0],
    [2.5, 3.0, 3.0, 2.5],
    [2.5, 3.0, 3.0, 2.5],
    [2.0, 2.5, 2.5, 2.0],
])
ZACH_INIT = {"A": 0.98, "T": 0.98, "C": 1.03, "G": 1.03}
ZACH_TERMINAL_TA = 0.4
ZACH_SYMMETRY = 0.4

# Plain-list views for the bit-exact scalar paths (pure Python floats, so
# rounding/repr semantics match the reference's list-of-list tables).
DH_L = DH.tolist()
DS_L = DS.tolist()
DG37_L = DG37.tolist()
ZACH_FREE_L = ZACH_FREE.tolist()
ZACH_PENALTY_L = ZACH_PENALTY.tolist()
ZACH_HBONDS_L = ZACH_HBONDS.tolist()

# PCR condition constants (multiPrime-core.py:176-183).
PRIMER_CONC_NG_UL = 100
MONOVALENT_MM = 50
DIVALENT_MM = 1.5
DNTP_MM = 0.25
KELVIN = 273.15
CROSSOVER_POINT = 0.22  # Owczarzy 2008
