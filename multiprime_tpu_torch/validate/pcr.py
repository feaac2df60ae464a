# Copied from multiprime_tpu/validate/pcr.py (host code, no JAX).
"""Perfect-match in-silico PCR (extract_PCR_product equivalent).

Re-implements multiPrime/scripts/extract_PCR_product.py (class
Product:120-263): for each primer pair, find the first matching F expansion in
each one-line target sequence, then the first R expansion whose reverse
complement occurs downstream; emit per-pair product / non-product FASTAs and
the Coverage_stast.xls summary.

The scan itself is substring search over expansions, exactly like the
reference; the batched mismatch-tolerant version (which subsumes this as
mm=0) lives in multiprime_tpu.ops.mismatch_scan / validate.scan.
"""

from __future__ import annotations

import os
from pathlib import Path

from ..utils import iupac

RC_ACGT = str.maketrans("ATGC", "TACG")


def _rc(seq):
    return seq.translate(RC_ACGT)[::-1]


def parse_pairs_xls(path):
    """final_maxprimers_set.xls -> {key: (F, R)} (extract_PCR_product.py:144-156)."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.strip().split("\t")
            if len(fields) < 7:
                # path-only row for a pair-exhausted cluster (see
                # stages.primerset_format): the reference's own parse
                # (extract_PCR_product.py:144-156) crashes on it
                continue
            cluster_id = fields[0].split("/")[-1].split(".")[0]
            start = fields[6].split(":")[0]
            stop = fields[6].split(":")[1]
            key = "%s_%s_F_%s_%s" % (cluster_id, start, cluster_id, stop)
            out[key] = (fields[2], fields[3])
    return out


def parse_pairs_fa(path):
    """4-line groups: >Fid, F, >Rid, R (extract_PCR_product.py:157-168)."""
    out = {}
    lines = [l.strip() for l in open(path) if l.strip()]
    for i in range(0, len(lines) - 3, 4):
        key = lines[i].lstrip(">") + "_" + lines[i + 2].lstrip(">")
        out[key] = (lines[i + 1], lines[i + 3])
    return out


def pcr_products(primer_f, primer_r, ref_file):
    """-> (products {id: seq}, non_products {id: seq})."""
    f_exp = iupac.expand(primer_f)
    r_exp = iupac.expand(primer_r)
    products, non_products = {}, {}
    with open(ref_file) as r:
        key = None
        for line in r:
            if line.startswith(">"):
                key = line.strip()
                continue
            value = ""
            for fseq in f_exp:
                if fseq in line:
                    tail = line.split(fseq)[1]
                    product = fseq + tail
                    for rseq in r_exp:
                        rc = _rc(rseq)
                        if rc in product:
                            value = product.split(rc)[0].strip() + rc
                            break
                    if value:
                        break
            if value:
                products[key] = value
            else:
                non_products[key] = line.strip()
    return products, non_products


class _Corpus:
    """All target lines read once, with a cached corpus-wide substring
    locator: occurrences of an expansion across every target in ONE
    C-level find loop instead of a per-pair re-read + per-target scan
    (the reference re-reads the FASTA for every pair,
    extract_PCR_product.py:189-215)."""

    def __init__(self, ref_file):
        # One record per NON-HEADER LINE, keyed by the most recent header —
        # exactly the reference reader's streaming semantics (wrapped FASTA
        # lines are separate records that overwrite the same dict key there
        # too; a header with no line contributes nothing).
        self.headers = []        # per-line record key (current header)
        lines = []               # raw sequence lines incl. trailing newline
        with open(ref_file) as r:
            key = None
            for line in r:
                if line.startswith(">"):
                    key = line.strip()
                else:
                    self.headers.append(key)
                    lines.append(line)
        starts = []
        pos = 0
        for ln in lines:
            starts.append(pos)
            pos += len(ln)
        starts.append(pos)                   # sentinel
        self._starts = starts
        self._corpus = "".join(lines)        # '\n' separators: patterns ACGT
        self._occ = {}                       # expansion -> {tidx: first idx}

    def line(self, t):
        return self._corpus[self._starts[t]:self._starts[t + 1]]

    def first_occurrences(self, pattern):
        """{target_index: first in-line offset} for a pure-ACGT pattern."""
        got = self._occ.get(pattern)
        if got is not None:
            return got
        from bisect import bisect_right
        out = {}
        corpus = self._corpus
        starts = self._starts
        i = corpus.find(pattern)
        while i >= 0:
            t = bisect_right(starts, i) - 1
            if t not in out:
                out[t] = i - starts[t]
            # jump to the end of this target: only the FIRST occurrence
            # per target matters (str.split semantics)
            i = corpus.find(pattern, starts[t + 1])
        self._occ[pattern] = out
        return out


def _pcr_products_corpus(primer_f, primer_r, corpus):
    """pcr_products over a preloaded corpus — identical semantics: per
    target, the first F expansion (in expansion order) whose occurrence
    yields a downstream R match wins; targets with no such pair are
    non-products."""
    f_exp = iupac.expand(primer_f)
    r_exp = iupac.expand(primer_r)
    occ_maps = [corpus.first_occurrences(fseq) for fseq in f_exp]
    r_rcs = [_rc(rseq) for rseq in r_exp]
    products, non_products = {}, {}
    for t, key in enumerate(corpus.headers):
        line = corpus.line(t)
        value = ""
        for fseq, occ in zip(f_exp, occ_maps):
            idx = occ.get(t)
            if idx is None:
                continue
            product = fseq + line[idx + len(fseq):]
            for rc in r_rcs:
                ridx = product.find(rc)
                if ridx >= 0:
                    value = product[:ridx].strip() + rc
                    break
            if value:
                break
        if value:
            products[key] = value
        else:
            non_products[key] = line.strip()
    return products, non_products


def _batch_occurrences(pairs, corpus):
    """Occurrence lists for EVERY pair's expansions via one native exact
    scan over the corpus — replaces len(pairs) * len(expansions) C-level
    `str.find` sweeps (46 ms/pair at 21k scale -> one ~2 s scan).

    -> {pattern: {target_index: sorted positions}} or None when the batch
    path is ineligible (no native runtime, non-ACGT patterns, or patterns
    too short for the seed index).  Eligibility is all-or-nothing so a
    single code path serves every pair.
    """
    from .. import native
    from ..ops import mismatch_scan as ms
    if not native.available():
        return None
    patterns = []
    seen = set()
    for primer_f, primer_r in pairs.values():
        for e in iupac.expand(primer_f):
            if e not in seen:
                seen.add(e)
                patterns.append(e)
        for e in iupac.expand(primer_r):
            rc = _rc(e)
            if rc not in seen:
                seen.add(rc)
                patterns.append(rc)
    if not patterns:
        return {}
    for p in patterns:
        if len(p) < 8 or any(c not in "ACGT" for c in p):
            return None
    occ = {p: {} for p in patterns}
    lines = [corpus.line(t) for t in range(len(corpus.headers))]
    codes, lens = ms.encode_target_codes(lines)
    by_len = {}
    for p in patterns:
        by_len.setdefault(len(p), []).append(p)
    for plen, group in sorted(by_len.items()):
        if codes.shape[1] < plen:
            continue
        masks = ms.encode_pattern_masks(group)
        hits = native.seed_scan(codes, lens, masks, 0, 0)
        if hits is None:
            return None
        # nonzero contract: ascending (target, pos, pattern) -> per-
        # (pattern, target) position lists arrive sorted
        for t, pos, pi, _ in hits.tolist():
            occ[group[pi]].setdefault(t, []).append(pos)
    return occ


def _pcr_products_occ(primer_f, primer_r, corpus, occ, want_bodies=True):
    """_pcr_products_corpus driven by precomputed occurrence lists —
    identical semantics: first F expansion (in expansion order) whose
    first occurrence yields a downstream R match wins; `product.find(rc)`
    becomes a bisect over rc's line-absolute positions >= the F start.

    ``want_bodies=False`` (the summary mode) skips the sequence bodies:
    products map to True, non-products to None — the same keys in the
    same line order (covered/uncovered sets and all counts identical),
    and only lines with an F occurrence are visited at all (a 1011-pair x
    21k-target run spends ~30 s just walking every target per pair)."""
    from bisect import bisect_left
    f_exp = iupac.expand(primer_f)
    r_rcs = [_rc(rseq) for rseq in iupac.expand(primer_r)]
    f_occ = [occ.get(fseq, {}) for fseq in f_exp]
    r_occ = [occ.get(rc, {}) for rc in r_rcs]

    def body(t):
        line = corpus.line(t)
        for fseq, occd in zip(f_exp, f_occ):
            positions = occd.get(t)
            if not positions:
                continue
            idx = positions[0]
            for rc, roccd in zip(r_rcs, r_occ):
                rpos = roccd.get(t)
                if not rpos:
                    continue
                j = bisect_left(rpos, idx)
                if j < len(rpos):
                    ridx = rpos[j] - idx
                    return line[idx:idx + ridx].strip() + rc
        return ""

    products, non_products = {}, {}
    if want_bodies:
        for t, key in enumerate(corpus.headers):
            value = body(t)
            if value:
                products[key] = value
            else:
                non_products[key] = corpus.line(t).strip()
        return products, non_products
    candidates = set()
    for occd in f_occ:
        candidates.update(occd)
    produced = set()
    for t in sorted(candidates):          # line order, like the full walk
        if body(t):
            produced.add(t)
            products[corpus.headers[t]] = True
    # summary mode returns the produced index set instead of a dense
    # non-product dict: materialising {key: None} for every uncovered
    # target per pair walked N_targets x N_pairs entries (47 s of the
    # 100k run's 63 s pcr stage); run() derives the count as
    # N - len(produced) and the final uncovered set from the running
    # intersection of produced sets — identical counts and sets
    # (tests/test_cli_pipeline.py::test_pcr_products_modes)
    return products, produced


def run(pairs, ref_file, out_dir, coverage_file, products="full"):
    """Drive all pairs; write per-pair FASTAs + the coverage summary
    (extract_PCR_product.py:218-263).

    ``products`` controls the per-pair FASTA bodies — the piece that
    dominates the large-scale tail (12.5 GB across a 1000-pair 21k-seq
    run while the counts take seconds):

    * ``"full"``  — reference-contract plain FASTAs (default);
    * ``"gzip"``  — same bodies, gzip-streamed to ``.fa.gz``;
    * ``"summary"`` — skip the bodies entirely; Coverage_stast.xls (and the
      return value) are identical in every mode.
    """
    import gzip
    os.makedirs(out_dir, exist_ok=True)
    covered, uncovered = set(), set()
    corpus = _Corpus(ref_file)
    occ = _batch_occurrences(pairs, corpus) if len(pairs) > 4 else None
    inter_produced = None      # summary+occ: intersection of produced sets
    dup_groups = dup_idx = n_distinct = None
    if occ is not None and products == "summary":
        # duplicate-header bookkeeping: the reference's non-product dict
        # collapses lines by header, so the summary count must be the
        # number of DISTINCT headers with some non-producing line
        hc = {}
        for h in corpus.headers:
            hc[h] = hc.get(h, 0) + 1
        n_distinct = len(hc)
        dup_groups = {}
        for t, h in enumerate(corpus.headers):
            if hc[h] > 1:
                dup_groups.setdefault(h, []).append(t)
        dup_idx = {t for ts in dup_groups.values() for t in ts}
    with open(coverage_file, "a+") as cov:
        for key, (primer_f, primer_r) in pairs.items():
            if occ is not None and products == "summary":
                # produced-index form: the per-pair dense non-product dict
                # never materialises (it walked N_targets x N_pairs entries
                # — 47 s of the 100k run's 63 s pcr stage)
                products_d, produced = _pcr_products_occ(
                    primer_f, primer_r, corpus, occ, want_bodies=False)
                if dup_groups:
                    full = sum(1 for ts in dup_groups.values()
                               if all(t in produced for t in ts))
                    uniq_prod = len(produced) - sum(
                        1 for t in produced if t in dup_idx)
                    n_non = n_distinct - uniq_prod - full
                else:
                    n_non = n_distinct - len(produced)
                cov.write("Number of Product/non_Product, primer-F and "
                          "primer-R: {}\t{}\t{}\t{}\t{}\n".format(
                              key, len(products_d), n_non,
                              primer_f, primer_r))
                covered.update(products_d)
                inter_produced = produced if inter_produced is None \
                    else inter_produced & produced
                continue
            if occ is not None:
                products_d, non_products = _pcr_products_occ(
                    primer_f, primer_r, corpus, occ)
            else:
                products_d, non_products = _pcr_products_corpus(
                    primer_f, primer_r, corpus)
            cov.write("Number of Product/non_Product, primer-F and primer-R: "
                      "{}\t{}\t{}\t{}\t{}\n".format(
                          key, len(products_d), len(non_products),
                          primer_f, primer_r))
            # Path.with_suffix like the reference (extract_PCR_product.py:
            # 232-234): a dotted key has its final ".suffix" REPLACED.
            base = str(Path(out_dir).joinpath(key).with_suffix(""))
            # one join + one write per file: the per-pair product FASTAs
            # dominate the large-scale tail (GBs across a 1000-pair set)
            covered.update(products_d)
            uncovered.update(non_products)
            if products == "summary":
                continue
            opener, ext = ((gzip.open, ".gz") if products == "gzip"
                           else (open, ""))
            with opener(base + ".PCR.product.fa" + ext, "wt") as p:
                p.write("".join(
                    rid + "\n" + seq + "\n"
                    for rid, seq in products_d.items()))
            with opener(base + ".non_PCR.product.fa" + ext, "wt") as np_:
                np_.write("".join(
                    rid + "\n" + seq + "\n"
                    for rid, seq in non_products.items()))
    if inter_produced is not None:
        # a header is uncovered iff SOME pair lacked a product for it ==
        # not produced by every pair
        uncovered.update(h for t, h in enumerate(corpus.headers)
                         if t not in inter_produced)
    n_seqs = 0
    with open(ref_file, encoding="utf-8") as f:
        for chunk in iter(lambda: f.read(1 << 20), ""):
            n_seqs += chunk.count("\n")
    n_seqs = int(n_seqs / 2)
    with open(coverage_file, "a+") as cov:
        cov.write("Total number of sequences:\t{}\n"
                  "Coveraged number of sequence:\t{}\n"
                  "Rate of coverage:\t>= {}\n".format(
                      n_seqs, len(covered),
                      round(float(len(covered)) / n_seqs, 2)))
    return covered, uncovered
