"""A viral CDS corpus for one ``run`` job, made from a seed: families of
members of one length at stated divergences from the family's base (every
``copy_every``-th member an exact copy of it), then random singletons of
the same length.  The distribution of chip_smoke.py's generate_corpus
(the 21k scale corpus), drawn in bulk with NumPy.

Parameters (the traffic file's ``corpus``): families, members,
singletons, length, divergences (one a family, cycled), copy_every.
"""

import numpy as np

_LUT = np.frombuffer(b"ACGT", np.uint8)


def generate(params, seed):
    """-> (ids, sequences as uint8 ASCII rows [N, length])."""
    rng = np.random.default_rng(seed)
    n_fams = int(params["families"])
    members = int(params["members"])
    length = int(params["length"])
    divs = [float(d) for d in params["divergences"]]
    every = int(params["copy_every"])
    ids, rows = [], []
    for fam in range(n_fams):
        base = rng.integers(0, 4, size=length)
        block = np.repeat(base[None, :], members, axis=0)
        mutate = rng.random((members, length)) < divs[fam % len(divs)]
        mutate[::every] = False               # members 0, every, ...: copies
        block[mutate] = rng.integers(0, 4, size=int(mutate.sum()))
        rows.append(block)
        ids += ["F%d_%d" % (fam, m) for m in range(members)]
    n_single = int(params["singletons"])
    rows.append(rng.integers(0, 4, size=(n_single, length)))
    ids += ["S%d" % s for s in range(n_single)]
    return ids, _LUT[np.concatenate(rows)]


def write_fasta(path, ids, rows):
    with open(path, "wb") as f:
        for name, row in zip(ids, rows):
            f.write(b">" + name.encode() + b"\n" + row.tobytes() + b"\n")
