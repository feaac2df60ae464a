# Port of multiprime_tpu/validate/specificity.py: the scans run on ``device``.
"""Primer specificity vs a background database — primer_specificity.py
equivalent (multiPrime/scripts/primer_specificity.py:211-440).

Same engine family as the coverage validation scan but pointed at an
off-target background.  The reference maps the (optionally 3'-l-mer-
truncated) expanded primers with bowtie/bowtie2 loose seeds and joins F x R
positions per gene; here the exhaustive scan IS the looser search — every
site with <= mm mismatches (and a clean 3'-terminal run, the MD-tag filter
at :276-292) is reported, so bowtie's heuristic misses cannot occur.  Rows
hitting the background are predicted off-target amplicons.

Reference CLI surface (argsParse :64-111): -i primers, -r background,
-l term length (default 18; the 3'-l-mer mode), -t term threshold (4),
-m seed mismatches (1), -s product size "100,1500", -o out.  Output files:
.term.fa, .out (6 columns), .out.pair.num, .out.total.acc.num — the last
with the reference's exact single-line format (:416-417, no trailing
newline, no target-count line, no unmatched.fa — those belong to the
coverage script only).

Backgrounds longer than ``ScanParams.seg_len`` (65,536 bases) are scanned
as overlapping segments (``scan.scan_hits_long``); the device scans run on
``device`` (the CUDA hit-code kernel on a GPU), the corpus uploaded once
for the F and R scans.
"""

from __future__ import annotations

from . import scan as vscan
from ..utils import iupac, trace


def write_outputs(rows, outfile):
    """.out / .pair.num / .total.acc.num in primer_specificity.py's formats
    (:391-417)."""
    pair_count = {}
    pair_acc = {}
    acc_ids = set()
    with open(outfile, "w") as fo:
        fo.write("\t".join(["Chrom (or Genes)", "Start", "Stop", "Primer_F",
                            "Primer_R", "Product length"]) + "\n")
        for row in rows:
            key = row[3] + "\t" + row[4]
            pair_count[key] = pair_count.get(key, 0) + 1
            pair_acc.setdefault(key, []).append(row[0])
            acc_ids.add(row[0])
            fo.write("\t".join(map(str, row)) + "\n")
    with open(outfile + ".pair.num", "w") as fo:
        fo.write("Primer_F\tPrimer_R\tPair_num\ttarget accession number\n")
        for key, cnt in sorted(pair_count.items(), key=lambda x: x[1],
                               reverse=True):
            fo.write(key + "\t" + str(cnt) + "\t"
                     + str(len(set(pair_acc[key]))) + "\n")
    with open(outfile + ".total.acc.num", "w") as fo:
        fo.write("total coverage of primer set (PS) is: {}".format(
            len(acc_ids)))
    return pair_count


def run(primer_fa, background_fa, outfile, *, term_len=18, term=4, mm=1,
        product_size=(100, 1500), batch_seqs=256, backend="auto",
        exhaustive_join=False, device="cuda"):
    """Scan primers (3'-l-mers when term_len > 0) against a background DB;
    any F/R join inside an amplifiable window is a predicted off-target
    amplicon.  Returns the joined rows.

    exhaustive_join=True replaces the reference's per-gene early-exit join
    (primer_specificity.py:351-353: one start with an empty product window
    abandons the gene) with the complete join — required for genome-scale
    backgrounds where independent pairs' sites are megabases apart; the
    default stays bug-for-bug parity.  ``device`` is where the device scans
    run (default cuda; raises without a GPU, before any file is written)."""
    import os
    from ..utils import link as linkmod
    dev = linkmod.resolve_device(device)
    params = vscan.ScanParams(term_len=term_len, term=term, mm=mm,
                              product_size=tuple(product_size),
                              batch_seqs=batch_seqs, backend=backend)
    term_fa = os.path.splitext(primer_fa)[0] + ".term.fa"
    with trace.span("specificity.expand"):
        patterns, labels, keys, key_labels = vscan.expand_primer_fasta(
            primer_fa, params.term_len, term_fa, with_keys=True)
    if keys is not None:
        patterns, labels = keys, key_labels
    with trace.span("specificity.parse"):
        gene_ids, target_seqs = vscan.parse_fasta(background_fa)
        rc_patterns = [iupac.rc(p) for p in patterns]
    with vscan.shared_corpus(params):
        f_hits = vscan.scan_hits_long(target_seqs, patterns, params, dev)
        r_hits = vscan.scan_hits_long(target_seqs, rc_patterns, params, dev)
    with trace.span("specificity.join"):
        rows = vscan.pcr_join(gene_ids, f_hits, r_hits, labels,
                              params.product_size,
                              exhaustive=exhaustive_join)
    trace.count("rows", len(rows))
    with trace.span("specificity.write"):
        write_outputs(rows, outfile)
    return rows
