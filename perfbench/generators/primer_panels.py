"""Primer panels for ``specificity`` jobs, made from a seed: a pool of
primer pairs, and panels drawn from it.

A primer is ``min_len``-``max_len`` random bases with up to
``max_degenerate`` degenerate positions (IUPAC codes of two or three
members) outside its last ``end`` bases, the product of its member counts
at most ``max_degeneracy``.  A panel takes ``sizes[k]`` pairs of the pool,
the sizes cycled in an order drawn from the seed, so every seed gives the
same set of sizes.

Parameters (the traffic file's ``pool`` and ``panels``): pairs, min_len,
max_len, max_degenerate, max_degeneracy, end; sizes, count.
"""

import numpy as np

_LUT = np.array(list("ACGT"))
_CODES = {"R": 2, "Y": 2, "M": 2, "K": 2, "S": 2, "W": 2,
          "H": 3, "B": 3, "V": 3, "D": 3}


def _primer(rng, p):
    n = int(rng.integers(int(p["min_len"]), int(p["max_len"]) + 1))
    seq = list(_LUT[rng.integers(0, 4, size=n)])
    names = sorted(_CODES)
    while True:
        k = int(rng.integers(0, int(p["max_degenerate"]) + 1))
        codes = [names[int(i)] for i in rng.integers(0, len(names), size=k)]
        if np.prod([_CODES[c] for c in codes]) <= int(p["max_degeneracy"]):
            break
    at = rng.choice(n - int(p["end"]), size=k, replace=False)
    for i, c in zip(at, codes):
        seq[int(i)] = c
    return "".join(seq)


def pool(params, seed):
    """-> [(F, R)] of ``params["pairs"]`` pairs."""
    rng = np.random.default_rng([seed, 1])
    return [(_primer(rng, params), _primer(rng, params))
            for _ in range(int(params["pairs"]))]


def panels(params, pairs, seed):
    """-> ``params["count"]`` panels, each a list of (name, sequence)."""
    rng = np.random.default_rng([seed, 2])
    sizes = [int(s) for s in params["sizes"]]
    order = rng.permutation(len(sizes))
    out = []
    for j in range(int(params["count"])):
        size = sizes[order[j % len(sizes)]]
        picks = rng.choice(len(pairs), size=size, replace=False)
        panel = []
        for i in sorted(int(i) for i in picks):
            panel += [("pair%d_F" % i, pairs[i][0]),
                      ("pair%d_R" % i, pairs[i][1])]
        out.append(panel)
    return out


def write_fasta(path, panel):
    with open(path, "w") as f:
        for name, seq in panel:
            f.write(">%s\n%s\n" % (name, seq))
