"""A background of bacterial-size genomes for ``specificity``, made from a
seed, with amplicons of a primer pool planted in it: chip_smoke.py's
phase-11 background (write_background, plant_amplicons), the pool in
place of a run's candidate pairs.

Each plant is one expansion of an F primer and, ``min_gap``-``max_gap``
bases after F's 3' ``plen``-mer, the reverse complement of one expansion
of its R primer; each site carries at most one substitution in its scanned
``plen``-mer outside its last ``term`` bases.  The first ``straddles`` put
F's ``plen``-mer across a multiple of the scan's segment stride
(``seg_len`` - ``plen`` + 1).  Plants lie 3,000 bases apart or more.

Parameters (the configuration's ``background``): lengths, plants,
straddles, seg_len, plen, term, min_gap, max_gap.
"""

import itertools

import numpy as np

_LUT = np.frombuffer(b"ACGT", np.uint8)
_MEMBERS = {"A": "A", "C": "C", "G": "G", "T": "T", "R": "AG", "Y": "CT",
            "M": "AC", "K": "GT", "S": "GC", "W": "AT", "H": "ATC",
            "B": "GTC", "V": "GAC", "D": "GAT", "N": "ATGC"}
_RC = str.maketrans("ATGCRYMKSWHBVDN", "TACGYRKMSWDVBHN")


def _expansions(seq):
    return ["".join(p) for p in itertools.product(*(_MEMBERS[c]
                                                    for c in seq))]


def _substitute(rng, s, lo, hi):
    at = int(rng.integers(max(lo, 0), hi))
    return s[:at] + str(rng.choice([c for c in "ACGT" if c != s[at]])) \
        + s[at + 1:]


def _plant(rng, genomes, pairs, p):
    plen, term = int(p["plen"]), int(p["term"])
    stride = int(p["seg_len"]) - plen + 1
    lo_gap, hi_gap = int(p["min_gap"]), int(p["max_gap"])
    boundaries = [(g, k * stride) for g in range(len(genomes))
                  for k in range(1, (len(genomes[g]) - 1500) // stride + 1)]
    picks = rng.choice(len(boundaries), size=int(p["straddles"]),
                       replace=False)
    taken = {g: [] for g in range(len(genomes))}
    sites = []
    while len(sites) < int(p["plants"]):
        f, r = pairs[int(rng.integers(0, len(pairs)))]
        fx = _expansions(f)
        fx = fx[int(rng.integers(0, len(fx)))]
        rx = _expansions(r)
        rx = rx[int(rng.integers(0, len(rx)))]
        if rng.random() < 0.5:
            fx = _substitute(rng, fx, len(fx) - plen, len(fx) - term)
        if rng.random() < 0.5:       # R's 3' bases past its last term
            rx = _substitute(rng, rx, len(rx) - plen + term, len(rx))
        if len(sites) < int(p["straddles"]):
            g, b = boundaries[picks[len(sites)]]
            start = b - int(rng.integers(1, plen))
        else:
            g = int(rng.integers(0, len(genomes)))
            start = int(rng.integers(100, len(genomes[g]) - 1600))
        at = start - max(len(fx) - plen, 0)
        stop = start + int(rng.integers(lo_gap, hi_gap + 1))
        site = rx.translate(_RC)[::-1]
        if at < 0 or stop + len(site) > len(genomes[g]) or any(
                abs(start - t) < 3000 for t in taken[g]):
            continue
        genomes[g][at:at + len(fx)] = np.frombuffer(fx.encode(), np.uint8)
        genomes[g][stop:stop + len(site)] = np.frombuffer(site.encode(),
                                                          np.uint8)
        taken[g].append(start)
        sites.append((g, start, stop))
    return sites


def generate(params, seed, pairs):
    """-> (ids, genomes as uint8 ASCII arrays, planted sites (genome,
    F's plen-mer start, R site start))."""
    rng = np.random.default_rng([seed, 3])
    genomes = [_LUT[rng.integers(0, 4, size=int(n))]
               for n in params["lengths"]]
    sites = _plant(rng, genomes, pairs, params)
    return ["bg%d" % g for g in range(len(genomes))], genomes, sites


def write_fasta(path, ids, genomes):
    """80 columns a line."""
    with open(path, "wb") as f:
        for name, arr in zip(ids, genomes):
            f.write(b">%s synthetic genome\n" % name.encode())
            cut = len(arr) // 80 * 80
            lines = arr[:cut].reshape(-1, 80)
            f.write(np.concatenate([lines, np.full((len(lines), 1), 10,
                                                   np.uint8)], axis=1
                                   ).tobytes())
            if len(arr) % 80:
                f.write(arr[cut:].tobytes() + b"\n")
