"""A whole-genome corpus for one ``run`` job, made from a seed: families of
members drawn from a base genome whose length is drawn from a range, each
member with substitutions at the family's divergence and short indels
(every ``copy_every``-th member an exact copy of the base), then random
singletons with lengths from the same range.  Drawn in bulk with NumPy.

Parameters (the configuration's keys): families, members, singletons,
length_range [lo, hi] (inclusive), divergences (one a family, cycled),
copy_every, indel_rate (a base), indel_len_p (the geometric distribution's
p) and indel_max (the longest indel).  Each indel is an insertion of random
bases or a deletion, with equal odds.
"""

import numpy as np

_LUT = np.frombuffer(b"ACGT", np.uint8)


def _indels(rng, seq, rate, p, longest):
    """``seq`` with indels at ``rate`` a base: at each drawn position an
    insertion (before the base) or a deletion (from it), of a length drawn
    from a geometric distribution capped at ``longest``; a position inside
    the previous deletion is skipped."""
    at = np.flatnonzero(rng.random(len(seq)) < rate)
    if not len(at):
        return seq
    lens = np.minimum(rng.geometric(p, size=len(at)), longest)
    insert = rng.random(len(at)) < 0.5
    ins = rng.integers(0, 4, size=int(lens[insert].sum()))
    pieces, prev, used = [], 0, 0
    for pos, n, is_ins in zip(at.tolist(), lens.tolist(), insert.tolist()):
        if pos < prev:
            if is_ins:
                used += n
            continue
        pieces.append(seq[prev:pos])
        if is_ins:
            pieces.append(ins[used:used + n])
            used += n
            prev = pos
        else:
            prev = pos + n
    pieces.append(seq[prev:])
    return np.concatenate(pieces)


def generate(params, seed):
    """-> (ids, sequences as uint8 ASCII rows of their own lengths)."""
    rng = np.random.default_rng(seed)
    lo, hi = (int(x) for x in params["length_range"])
    divs = [float(d) for d in params["divergences"]]
    every = int(params["copy_every"])
    rate = float(params["indel_rate"])
    p, longest = float(params["indel_len_p"]), int(params["indel_max"])
    members = int(params["members"])
    ids, rows = [], []
    for fam in range(int(params["families"])):
        base = rng.integers(0, 4, size=int(rng.integers(lo, hi + 1)))
        block = np.repeat(base[None, :], members, axis=0)
        mutate = rng.random(block.shape) < divs[fam % len(divs)]
        mutate[::every] = False               # members 0, every, ...: copies
        block[mutate] = rng.integers(0, 4, size=int(mutate.sum()))
        for m in range(members):
            rows.append(block[m] if m % every == 0
                        else _indels(rng, block[m], rate, p, longest))
            ids.append("G%d_%d" % (fam, m))
    for s in range(int(params["singletons"])):
        rows.append(rng.integers(0, 4, size=int(rng.integers(lo, hi + 1))))
        ids.append("S%d" % s)
    return ids, [_LUT[r] for r in rows]


def write_fasta(path, ids, rows):
    with open(path, "wb") as f:
        for name, row in zip(ids, rows):
            f.write(b">" + name.encode() + b"\n" + row.tobytes() + b"\n")
