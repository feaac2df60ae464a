# Port of multiprime_tpu/validate/update.py: the scans run on ``device``.
"""Incremental primer-set maintenance (Primer_set_update equivalent).

The reference's Primer_set_update.py:247-507 checks NEW candidate primers
against an existing core set: (a) cross-dimer scan with that script's OWN
finDimer variant (Dimer class :246-318 — linear penalty denominator,
single-initiation dG without salt/symmetry terms, `Loss > 3 or dG < -5`
verdict, core x uniq-new plus new x merged sweep order), (b) off-target /
PCR prediction of the merged set against a reference DB via bowtie — here
the exhaustive device scan (on ``device``: the CUDA hit-code kernel on a
GPU, the corpus uploaded once for the four scans).

``func="DO"`` (the reference's flag) runs both; "dimer" / "offtarget" run a
single half.
"""

from __future__ import annotations

import math

from . import findimer
from . import scan as vscan
from ..thermo import tables as tb
from ..utils import iupac

_BIT = {"A": 0, "C": 1, "G": 2, "T": 3}

# Primer_set_update.py:132-134 carries its OWN initiation constants (the
# SantaLucia duplex-initiation values), unlike every other script's
# 0.98/1.03 Zacharias ones — kept verbatim for parity.
_UPDATE_INIT = {"A": 2.8, "T": 2.8, "C": 1.82, "G": 1.82}


def delta_g_update(sequence):
    """Primer_set_update.py:204-218's dG variant: per-expansion NN sum +
    5'-initiation (that script's 2.8/1.82 table) + unconditional
    symmetry_correction (0.4) + terminal-TA bonus keyed on the *degenerate*
    sequence's last two chars; NO salt term, NO palindrome check, NO
    3'-initiation — unlike every other script's dG."""
    out = []
    for seq in iupac.expand(sequence):
        dg = 0.0
        for n in range(len(seq) - 1):
            i, j = _BIT[seq[n + 1]], _BIT[seq[n]]
            dg += tb.ZACH_FREE_L[i][j] * tb.ZACH_HBONDS_L[i][j] \
                + tb.ZACH_PENALTY_L[i][j]
        if sequence[-2:] == "TA":
            dg += _UPDATE_INIT[seq[0]] + tb.ZACH_TERMINAL_TA \
                + tb.ZACH_SYMMETRY
        else:
            dg += _UPDATE_INIT[seq[0]] + tb.ZACH_SYMMETRY
        out.append(dg)
    return round(max(out), 2)


def parse_primers(path):
    """seq -> '>name' dict in file order, later duplicates overwrite
    (Primer_set_update.py parse_primers:222-238, sans the pickle cache)."""
    primer_dict = {}
    with open(path) as f:
        name = None
        for line in f:
            if line.startswith(">"):
                name = line.strip()
            else:
                primer_dict[line.strip()] = name
    return primer_dict


def _process_dict(dict1, dict2):
    """(uniq-dict1, merged) with the reference's set-driven construction
    (:183-196) — dict orders follow the same set iteration orders, so runs
    with matching PYTHONHASHSEED are order-identical to the reference."""
    common = set(dict1.keys()) & set(dict2.keys())
    d1_uniq, out = {}, {}
    for k1 in set(dict1.keys()) - common:
        out[k1] = dict1[k1]
        d1_uniq[k1] = dict1[k1]
    for k2 in set(dict2.keys()) - common:
        out[k2] = dict2[k2]
    for c in common:
        out[c] = dict1[c] + "|" + dict2[c]
    return d1_uniq, out


def _dimer_check(primer, primer_set, merged, rows):
    """Dimer.dimer_check (:257-283): one row max per partner — the first
    (longest, set-ordered) 3'-end whose first RC-matching expansion trips
    `Loss > 3 or dG < -5`."""
    ends = sorted(set(findimer.current_end(primer)),
                  key=lambda e: len(e), reverse=True)
    for ps, ps_name in primer_set.items():
        hit = None
        for end in ends:
            rce = iupac.rc(end)
            for p in iupac.expand(ps):
                idx = p.find(rce)
                if idx >= 0:
                    d2 = len(p) - len(end) - idx
                    gc = end.count("G") + end.count("C")
                    loss = math.log10(
                        (2 ** len(end) * 2 ** gc) / (0.1 * (d2 + 0.1)))
                    dg = delta_g_update(end)
                    if loss > 3 or dg < -5:
                        hit = (merged[primer], primer, end, dg, len(end),
                               0, gc, ps_name, ps, d2, loss)
                        break
            if hit:
                break
        if hit:
            rows.append(hit)


def check_new_primers(new_fa, core_fa, outfile):
    """Cross-dimer report: core primers vs uniq-new, then new primers vs the
    merged set (Dimer.run :285-318).  Writes the 11-column report +
    .dimer_num with the reference's SeqName row-sum format."""
    new = parse_primers(new_fa)
    core = parse_primers(core_fa)
    uniq_new, merged = _process_dict(new, core)
    rows = []
    for primer in core:
        _dimer_check(primer, uniq_new, merged, rows)
    for primer in new:
        _dimer_check(primer, merged, merged, rows)
    primer_id_sum = {}
    dimer_id_sum = {}
    with open(outfile, "w") as fo:
        fo.write("\t".join([
            "Primer_ID", "Primer seq", "Primer end", "Delta G",
            "Primer end length", "End (distance 1)", "End (GC)",
            "Dimer-primer_ID", "Dimer-primer seq", "End (distance 2)",
            "Loss"]) + "\n")
        for res in rows:
            primer_id_sum[res[0]] = primer_id_sum.get(res[0], 0) + 1
            dimer_id_sum[res[7]] = dimer_id_sum.get(res[7], 0) + 1
            fo.write("\t".join(map(str, res)) + "\n")
    with open(outfile + ".dimer_num", "w") as fo:
        fo.write("SeqName\tPrimer_ID\tDimer-primer_ID\tRowSum\n")
        for k, p_id in primer_id_sum.items():
            d_id = dimer_id_sum.get(k, 0)
            fo.write("\t".join(map(str, [k, p_id, d_id, p_id + d_id]))
                     + "\n")
    return rows


def predict_merged_set(new_fa, core_fa, ref_fa, outfile,
                       params: vscan.ScanParams = None, device="cuda"):
    """Off-target / PCR prediction of the updated set — the reference's
    off_targets.run (:456-508): three per-gene joins (coreF x newR,
    coreR x newF, newF x newR; core x core pairs were vetted when the core
    set was built) concatenated into one .out, plus the .num per-primer
    forward/reverse counts table (its headers re-use the dimer names,
    quirk kept).  ``device`` is where the device scans run (default cuda;
    raises without a GPU)."""
    import os
    from ..utils import link as linkmod
    dev = linkmod.resolve_device(device)
    params = params or vscan.ScanParams(term_len=18, term=4, mm=1,
                                        product_size=(100, 1500))
    gene_ids, targets = vscan.parse_fasta(ref_fa)
    hits = {}
    labels = {}
    with vscan.shared_corpus(params):    # one upload serves all four scans
        for tag, path in (("core", core_fa), ("new", new_fa)):
            term_fa = os.path.splitext(path)[0] + ".term.fa"
            pats, labels[tag], keys, key_labels = vscan.expand_primer_fasta(
                path, params.term_len, term_fa, with_keys=True)
            if keys is not None:
                pats, labels[tag] = keys, key_labels
            hits[tag, "F"] = vscan.scan_hits_long(targets, pats, params, dev)
            hits[tag, "R"] = vscan.scan_hits_long(
                targets, [iupac.rc(p) for p in pats], params, dev)
    rows = []
    for f_tag, r_tag in (("core", "new"), ("new", "core"), ("new", "new")):
        rows.extend(vscan.pcr_join(
            gene_ids, hits[f_tag, "F"], hits[r_tag, "R"], labels[f_tag],
            params.product_size, labels_r=labels[r_tag]))
    fwd_id, rev_id = {}, {}
    with open(outfile, "w") as fo:
        fo.write("\t".join(["Chrom (or Genes)", "Start", "Stop", "Primer_F",
                            "Primer_R", "Product length"]) + "\n")
        for res in rows:
            fwd_id[res[3]] = fwd_id.get(res[3], 0) + 1
            rev_id[res[4]] = rev_id.get(res[4], 0) + 1
            fo.write("\t".join(map(str, res)) + "\n")
    with open(outfile + ".num", "w") as fo:
        fo.write("SeqName\tPrimer_ID\tDimer-primer_ID\tRowSum\n")
        for k, p_id in fwd_id.items():
            d_id = rev_id.get(k, 0)
            fo.write("\t".join(map(str, [k, p_id, d_id, p_id + d_id]))
                     + "\n")
    return rows


def run(new_fa, core_fa, ref_fa, out_prefix, func="DO",
        scan_params: vscan.ScanParams = None, device="cuda"):
    """Reference main dispatch (:510-536): "D" in func -> <out>.dimer,
    "O" in func -> <out>.offtargets.  The off-target scans run on
    ``device``; asking for CUDA without a GPU raises before any file is
    written when they would run."""
    from ..utils import link as linkmod
    if ("O" in func or func == "offtarget") and ref_fa:
        device = linkmod.resolve_device(device)
    results = {}
    if "D" in func or func == "dimer":
        results["dimer"] = check_new_primers(
            new_fa, core_fa, out_prefix + ".dimer")
    if ("O" in func or func == "offtarget") and ref_fa:
        results["offtarget"] = predict_merged_set(
            new_fa, core_fa, ref_fa, out_prefix + ".offtargets", scan_params,
            device)
    return results


def select_nondimer(new_fa, pool_fa, out_fa):
    """primer_filter.sh / select.nondimer.primer.sh equivalent: keep the new
    primers that form NO dimer against the pooled set (the shell helpers
    run finDimer/Primer_set_update over the merged fasta, join against the
    candidate fasta, and keep records with no dimer row).  The verdicts are
    the tools' own fixed gates (Primer_set_update.py:270: Loss > 3 or
    dG < -5) — neither shell helper exposes a threshold.

    -> list of kept primer names (without '>').
    """
    import os
    rows = check_new_primers(new_fa, pool_fa, out_fa + ".dimer.tmp")
    try:
        os.remove(out_fa + ".dimer.tmp")
        os.remove(out_fa + ".dimer.tmp.dimer_num")
    except OSError:
        pass
    involved = {r[1] for r in rows} | {r[8] for r in rows}
    new = findimer.parse_primer_fasta(new_fa)
    kept = []
    with open(out_fa, "w") as f:
        for primer, name in new.items():
            if primer in involved:
                continue
            f.write(">%s\n%s\n" % (name.lstrip(">"), primer))
            kept.append(name.lstrip(">"))
    return kept
