"""The seeded generators: the same seed gives the same inputs, and the
shapes the configurations state."""

import json
import os

import numpy as np

from perfbench.generators import (bacterial_background, primer_panels,
                                  viral_corpus)
from perfbench.harness import ROOT
from perfbench.reference import iupac


def _load(*parts):
    with open(os.path.join(ROOT, "perfbench", *parts)) as f:
        return json.load(f)


def test_corpus_is_deterministic_and_shaped():
    cfg = _load("configs", "viral-cds-panel.json")
    ids, rows = viral_corpus.generate(cfg, [2 ** 31 + 11, 1])
    ids2, rows2 = viral_corpus.generate(cfg, [2 ** 31 + 11, 1])
    assert ids == ids2 and np.array_equal(rows, rows2)
    _, other = viral_corpus.generate(cfg, [2 ** 31 + 12, 1])
    assert not np.array_equal(rows, other)
    assert rows.shape == (4 * 1000 + 200, 900)
    assert set(np.unique(rows).tolist()) <= set(b"ACGT")
    assert sum(i.startswith("S") for i in ids) == 200
    for fam, div in enumerate(cfg["divergences"]):
        block = rows[fam * 1000:(fam + 1) * 1000]
        base = block[0]
        # every tenth member an exact copy of the base
        assert (block[::10] == base).all()
        # the others differ at the stated rate less the draws of the
        # same base (a quarter of them)
        rest = np.delete(block, np.s_[::10], axis=0)
        share = (rest != base).mean()
        assert abs(share - div * 0.75) < 0.2 * div + 0.002


def test_panels_are_deterministic_with_one_set_of_sizes():
    tr = _load("traffic", "spec-panels.json")
    pool = primer_panels.pool(tr["pool"], 5)
    assert pool == primer_panels.pool(tr["pool"], 5)
    assert len(pool) == tr["pool"]["pairs"]
    for f, r in pool:
        for p in (f, r):
            assert 18 <= len(p) <= 24
            assert iupac.degeneracy(p) <= tr["pool"]["max_degeneracy"]
            assert set(p[-tr["pool"]["end"]:]) <= set("ACGT")
    sizes = {}
    for seed in (5, 2 ** 31 + 99):
        panels = primer_panels.panels(tr["panels"], pool, seed)
        assert panels == primer_panels.panels(tr["panels"], pool, seed)
        n = len(tr["panels"]["sizes"])
        sizes[seed] = sorted(len(p) // 2 for p in panels[:n])
    assert sizes[5] == sizes[2 ** 31 + 99] == sorted(tr["panels"]["sizes"])


def test_background_is_deterministic_with_its_plants():
    bg = dict(_load("configs", "spec-bacterial-64mb.json")["background"],
              lengths=[300000, 250000], plants=8, straddles=3)
    pool = primer_panels.pool(_load("traffic", "spec-panels.json")["pool"],
                              3)
    ids, genomes, sites = bacterial_background.generate(bg, 3, pool)
    _, genomes2, sites2 = bacterial_background.generate(bg, 3, pool)
    assert sites == sites2 and all(np.array_equal(a, b)
                                   for a, b in zip(genomes, genomes2))
    assert ids == ["bg0", "bg1"] and len(sites) == 8
    assert [len(g) for g in genomes] == [300000, 250000]
    stride = bg["seg_len"] - bg["plen"] + 1
    for g, start, _ in sites[:3]:
        # across a multiple of the segment stride
        assert start // stride != (start + bg["plen"] - 1) // stride
