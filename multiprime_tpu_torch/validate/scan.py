# Port of multiprime_tpu/validate/scan.py: the device branch runs on torch.
"""Mismatch-tolerant primer coverage validation — bowtie2/samtools replacement.

Re-implements multiPrime/scripts/primer_coverage_validation_by_BWT.py
(class off_targets:172-397) with an exhaustive on-device scan instead of
seed-and-extend mapping:

* degenerate primers are expanded (optionally only their 3' l-mer) into the
  same merged-ID records the reference writes to .term.fa (:205-240);
* forward hits = occurrences of the expanded primer in a target with
  <= mm mismatches; reverse hits = occurrences of its reverse complement —
  exactly what bowtie reports as flag-0 / flag-16 alignments;
* the reference's MD-tag filter keeps only alignments whose trailing exact
  match run is >= term (:242-262).  The trailing run is measured at the
  *right edge of the reference-orientation region* for both strands, so for
  reverse hits it guards the primer's 5' side — a quirk we replicate by
  applying the suffix veto to the scanned pattern (primer or its RC) as-is;
* per-gene F x R position join within the product-size window with the
  reference's strict bounds (:303-342).

The host branch (native seed/mask scans) is the JAX package's; the device
branch uploads the corpus with torch and scans it with the port's
ops.mismatch_scan (the CUDA hit-code kernel on a GPU, its plain PyTorch
version on the CPU).

Being exhaustive, the scan finds every alignment bowtie's heuristics can
find (bowtie2 -a with seed mismatches may miss some); on identical hit sets
the outputs are byte-compatible.
"""

from __future__ import annotations

import os
import re
from bisect import bisect_left
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import iupac
from ..ops import mismatch_scan as ms

# Which backend the most recent scan_hits call resolved to
# ("host" / "device"); surfaced in pipeline metrics.
LAST_BACKEND = None


@dataclass
class ScanParams:
    term_len: int = 0           # -l: 0 = full primer, else 3' l-mer
    term: int = 4               # -t: no mismatch within 3' terminal N bases
    mm: int = 1                 # -m: max mismatches
    product_size: tuple = (100, 1500)
    batch_seqs: int = 512       # numpy-path tile over the target axis
    device_batch_seqs: int = 2048   # device-path tile (fewer round-trips)
    backend: str = "auto"       # auto: the device (MPTPU_FORCE_BACKEND=host
                                # overrides); numpy: native host scan;
                                # device/conv/pallas: the device scan
    want_mism: bool = False     # per-hit mismatch counts (the F/R join
                                # doesn't need them; halves transfer bytes)
    corpus_cache: dict = None   # device-resident target tensors, keyed by
                                # (pad_len, batch).  shared_corpus() sets
                                # {} so the F scan's one upload serves the
                                # R scan, every retry, and any later
                                # pattern set — the transfer term is paid
                                # once per corpus
    seg_len: int = 1 << 16      # targets longer than this are scanned as
                                # overlapping segments (the sequence-parallel
                                # split of the position axis; the reference
                                # warns at >100 kb, README.md:35)


def expand_primer_fasta(primer_fa, term_len=0, term_fa_out=None,
                        with_keys=False):
    """Primer fasta -> (expanded seqs, labels) with the reference's merged-ID
    naming (get_term, primer_coverage_validation_by_BWT.py:205-240).

    with_keys=True additionally returns (keys, key_labels): the DEGENERATE
    patterns themselves with their merged labels, or (None, None) when any
    expansion is shared between two keys.  When no expansion is shared, a
    mask scan of the keys yields the same per-(gene, pos, label) hit
    existence as scanning every expansion — a window matches some expansion
    of key k with <= mm mismatches and a clean 3' run iff it matches k's
    position masks that way (the optimal expansion picks the matching member
    wherever the target base is inside the mask; any other expansion only
    adds mismatches) — and in the same key order, so pcr_join's
    last-hit-wins dict produces identical rows."""
    term_list = {}
    with open(primer_fa) as f:
        name = None
        for line in f:
            if line.startswith(">"):
                name = line.strip().lstrip(">")
            else:
                key = line.strip() if term_len == 0 else line.strip()[-term_len:]
                term_list.setdefault(key, []).append(name)
    seq_id = {}
    for key, names in term_list.items():
        uniq = list(dict.fromkeys(names))
        merged = "_".join(uniq)
        expansions = iupac.expand(key)
        if len(expansions) > 1:
            for j, e in enumerate(expansions):
                seq_id.setdefault(e, []).append(merged + "_" + str(j))
        else:
            seq_id.setdefault(key, []).append(merged + "_0")
    if term_fa_out:
        with open(term_fa_out, "w") as fo:
            for seq, ids in seq_id.items():
                fo.write(">" + "_".join(ids) + "\n" + seq + "\n")
    seqs, labels = [], []
    for seq, ids in seq_id.items():
        header = "_".join(ids)
        labels.append(re.split(r"_\d+$", header)[0])
        seqs.append(seq)
    if not with_keys:
        return seqs, labels
    if any(len(ids) > 1 for ids in seq_id.values()):
        return seqs, labels, None, None     # shared expansion: exact labels
                                            # need the expansion scan
    keys, key_labels = [], []
    for key, names in term_list.items():
        merged = "_".join(dict.fromkeys(names))
        keys.append(key)
        key_labels.append(re.split(r"_\d+$", merged + "_0")[0])
    return seqs, labels, keys, key_labels


def parse_fasta(path):
    ids, seqs = [], []
    cur = []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
                ids.append(line.strip().split(" ")[0].lstrip(">"))
            else:
                cur.append(line.strip().upper())
    if cur:
        seqs.append("".join(cur))
    return ids, seqs


_DEVICE_BACKENDS = ("device", "conv", "pallas")


def _resolve_backend(backend):
    """-> "numpy" (native host scan) or "device".  The JAX package's
    measured crossover is TPU-specific and not carried over: "auto" takes
    the device unless MPTPU_FORCE_BACKEND=host; "conv"/"pallas" are
    synonyms of the device path.  Outputs are identical either way."""
    from ..utils import link as linkmod
    if backend == "auto":
        return "numpy" if linkmod.forced_backend() == "host" else "device"
    if backend == "numpy":
        return backend
    if backend in _DEVICE_BACKENDS:
        return "device"
    raise ValueError("unknown scan backend %r" % backend)


def scan_hits(target_seqs, patterns, params: ScanParams, device="cuda"):
    """-> list of (seq_idx, pos, pattern_idx, mismatches) over all targets.

    Mixed-length pattern sets are scanned in per-length groups (the device
    kernel wants a rectangular pattern tensor).  ``device`` is where the
    device branch runs; asking for CUDA without a GPU raises."""
    from ..utils import link as linkmod
    dev = linkmod.resolve_device(device)
    if not patterns or not target_seqs:
        return []
    lengths = {len(p) for p in patterns}
    if len(lengths) > 1:
        hits = []
        for plen in sorted(lengths):
            group = [(i, p) for i, p in enumerate(patterns) if len(p) == plen]
            sub_hits = scan_hits(target_seqs, [p for _, p in group], params,
                                 dev)
            remap = [i for i, _ in group]
            hits.extend((s, o, remap[p], m) for s, o, p, m in sub_hits)
        return hits
    plen = len(patterns[0])
    p1h = ms.encode_primers(patterns)
    s1h = p1h.copy()
    if params.term > 0:
        s1h[:, :-params.term, :] = 0
    else:
        s1h[:] = 0
    # Bucket the pattern axis to a multiple of 8, as the JAX package does
    # (same batches, same hit order); zero rows can never hit.
    n_real = p1h.shape[0]
    pad_p = -n_real % 8
    if pad_p:
        z = np.zeros((pad_p,) + p1h.shape[1:], p1h.dtype)
        p1h = np.concatenate([p1h, z])
        s1h = np.concatenate([s1h, z])
    hits = []
    bs = params.batch_seqs
    # Canonical shapes (pad N to the batch size, L to one global 512-multiple)
    global_max = max((len(s) for s in target_seqs), default=0)
    pad_len = max(-global_max % 512 + global_max, 512)
    from .. import native
    global LAST_BACKEND
    backend = _resolve_backend(params.backend)
    if backend == "numpy":
        LAST_BACKEND = "host"
        # native scans: identical hits (fuzzed against find_hits_numpy and
        # each other in tests/test_scan.py).  seed_scan amortises its index
        # over large row batches; the early-exit mask walk serves small
        # pattern sets and mm>3.
        if native.available():
            masks = ms.encode_pattern_masks(patterns)
            use_seed = len(patterns) >= 32 and 0 <= params.mm <= 3
            nbs = 65536 if use_seed else bs
            hits = []
            for lo in range(0, len(target_seqs), nbs):
                chunk = target_seqs[lo:lo + nbs]
                codes, lens = ms.encode_target_codes(chunk)
                if codes.shape[1] < plen:
                    continue
                fn = native.seed_scan if use_seed else native.mask_scan
                out = fn(codes, lens, masks, params.mm,
                         max(params.term, 0))
                for s, o, pi, m in out.tolist():
                    hits.append((lo + s, o, pi, m))
            return hits
        for lo in range(0, len(target_seqs), bs):
            chunk = target_seqs[lo:lo + bs]
            t1h, lens = ms.encode_targets(chunk)
            if t1h.shape[1] < plen:
                continue
            out = ms.find_hits_numpy(t1h, lens, p1h, s1h, mm=params.mm,
                                     term=max(params.term, 0))
            for s, o, pi, m in out:
                if pi < n_real:
                    hits.append((lo + int(s), int(o), int(pi), int(m)))
        return hits
    if pad_len < plen:
        LAST_BACKEND = "device"
        return hits
    n_out = pad_len - plen + 1
    bs = ms.safe_batch_size(params.device_batch_seqs, n_out, p1h.shape[0])
    n_batches = -(-len(target_seqs) // bs)
    # Device-resident stacked corpus [B, bs, L] of compact 4-bit masks
    # (1/4 the one-hot bytes), scanned batch by batch on the device with one
    # host sync at the end (ops.mismatch_scan.find_hits_batched).  The
    # upload stays in params.corpus_cache so the R scan, retries and later
    # pattern sets reuse it (run() holds the cache).
    stacked = None
    # cache key carries a cheap corpus fingerprint so a params object
    # reused across DIFFERENT target sets can never serve stale masks
    cache_key = (str(dev), pad_len, bs, len(target_seqs),
                 len(target_seqs[0]), len(target_seqs[-1]))
    if params.corpus_cache is not None:
        stacked = params.corpus_cache.get(cache_key)
    if stacked is None:
        tm = np.zeros((n_batches, bs, pad_len), np.uint8)
        lm = np.zeros((n_batches, bs), np.int32)
        for bi in range(n_batches):
            chunk = target_seqs[bi * bs:(bi + 1) * bs]
            t1h, lens = ms.encode_target_masks(chunk, length=pad_len)
            tm[bi, :len(chunk)] = t1h
            lm[bi, :len(chunk)] = lens
        stacked = (torch.from_numpy(tm).to(dev), torch.from_numpy(lm).to(dev))
        if params.corpus_cache is not None:
            params.corpus_cache[cache_key] = stacked
    t_all, l_all = stacked
    planes, suffix_planes = ms.pack_patterns(p1h, s1h, device=dev)
    # per-batch hit cap, grown and rescanned when a batch overflows it
    max_hits = 1 << 17
    while True:
        packs = ms.find_hits_batched(
            t_all, l_all, planes, suffix_planes, plen=plen, mm=params.mm,
            term=max(params.term, 0), max_hits=max_hits,
            want_mism=params.want_mism).cpu().numpy()
        worst = int(packs[:, 0].max()) if len(packs) else 0
        if worst <= max_hits:
            break
        max_hits = 1 << (2 * worst - 1).bit_length()
    LAST_BACKEND = "device"          # only once the scan succeeded
    for bi in range(n_batches):
        seq, pos, pat, mm_, _ = ms.decode_packed(
            packs[bi], n_out, p1h.shape[0], max_hits)
        lo = bi * bs
        for s, o, p, m in zip(seq.tolist(), pos.tolist(), pat.tolist(),
                              mm_.tolist()):
            if p < n_real:      # drop bucket-padding rows
                hits.append((lo + s, o, p, m))
    return hits


def scan_hits_long(target_seqs, patterns, params: ScanParams,
                   device="cuda"):
    """scan_hits with genome-scale targets: sequences longer than
    params.seg_len are split into segments overlapping by (max pattern
    length - 1), scanned batched, and hit positions mapped back to absolute
    coordinates.  A hit in a segment's trailing overlap is reported by the
    NEXT segment instead (dedup rule: keep local positions < stride, plus
    everything in a target's last segment) so each occurrence appears
    exactly once.  Short target sets pass straight through."""
    if not patterns or not target_seqs:
        return []
    seg_len = params.seg_len
    if max(len(s) for s in target_seqs) <= seg_len:
        return scan_hits(target_seqs, patterns, params, device)
    overlap = max(len(p) for p in patterns) - 1
    if seg_len <= overlap:
        raise ValueError(
            "seg_len=%d must exceed the longest pattern (%d)"
            % (seg_len, overlap + 1))
    stride = seg_len - overlap
    segs, origin = [], []            # origin: (target_idx, offset, is_last)
    for ti, s in enumerate(target_seqs):
        if len(s) <= seg_len:
            segs.append(s)
            origin.append((ti, 0, True))
            continue
        off = 0
        while True:
            chunk = s[off:off + seg_len]
            last = off + seg_len >= len(s)
            segs.append(chunk)
            origin.append((ti, off, last))
            if last:
                break
            off += stride
    raw = scan_hits(segs, patterns, params, device)
    hits = []
    for si, o, pi, m in raw:
        ti, off, last = origin[si]
        if o < stride or last:
            hits.append((ti, off + o, pi, m))
    return hits


def closest(sorted_list, lo_val, hi_val):
    """bisect window (primer_coverage_validation_by_BWT.py:162-169)."""
    left = bisect_left(sorted_list, lo_val)
    if hi_val > sorted_list[-1]:
        right = len(sorted_list) - 1
    else:
        right = bisect_left(sorted_list, hi_val) - 1
    return left, right


def pcr_join(gene_ids, f_hits, r_hits, labels, product_size, labels_r=None,
             exhaustive=False):
    """Per-gene F x R join -> rows (gene, start, stop, F, R, length)
    (PCR_product, :303-342).  Later hits at the same position overwrite
    earlier ones, like the reference's dict() conversion.  labels_r lets the
    F and R hit sets come from different primer files (Primer_set_update's
    core x new joins).

    exhaustive=False keeps the reference's early-exit bug-for-bug: when a
    start position finds no stop inside its product window, the WHOLE
    gene's remaining starts are skipped (primer_coverage_validation_by_BWT
    .py:318-320, identically primer_specificity.py:351-353) — benign for
    gene-scale targets with dense hits, silently lossy on genome-scale
    backgrounds where F/R sites of independent pairs are megabases apart.
    exhaustive=True skips only the current start (and still terminates
    once every remaining stop lies below the window) — the complete join
    the genome-scale specificity path documents as superseding."""
    if labels_r is None:
        labels_r = labels
    lo, hi = int(product_size[0]), int(product_size[1])
    f_by_gene, r_by_gene = {}, {}
    for s, o, p, _ in f_hits:
        f_by_gene.setdefault(s, {})[o] = labels[p]
    for s, o, p, _ in r_hits:
        r_by_gene.setdefault(s, {})[o] = labels_r[p]
    rows = []
    for s in sorted(set(f_by_gene) & set(r_by_gene)):
        primer_f = f_by_gene[s]
        primer_r = r_by_gene[s]
        starts = sorted(primer_f)
        stops = sorted(primer_r)
        if stops[0] - starts[-1] > hi:
            continue
        if stops[-1] - starts[0] < lo:
            continue
        for start in starts:
            i0, i1 = closest(stops, start + lo, start + hi)
            if i0 > i1:
                if not exhaustive:
                    break
                if i0 >= len(stops):
                    # every stop is below start+lo; starts ascend, so no
                    # later window can contain one either
                    break
                continue
            for stop in stops[i0:i1 + 1]:
                distance = stop - start + 1
                if distance > hi:
                    break
                elif lo < distance < hi:
                    rows.append((gene_ids[s], start, stop,
                                 primer_f[start], primer_r[stop], distance))
    return rows


def write_outputs(rows, outfile, targets_dict=None):
    """.out / .pair.num / .total.acc.num / .unmatched.fa
    (primer_coverage_validation_by_BWT.py:354-397)."""
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
    target_seq = set()
    with open(outfile + ".pair.num", "w") as fo:
        fo.write("Primer_F\tPrimer_R\tPair_num\ttarget accession number\n")
        for key, cnt in sorted(pair_count.items(), key=lambda x: x[1],
                               reverse=True):
            accs = set(pair_acc[key])
            target_seq |= accs
            fo.write(key + "\t" + str(cnt) + "\t" + str(len(accs)) + "\n")
    with open(outfile + ".total.acc.num", "w") as fo:
        fo.write("total coverage of primer set (PS) is: {}\n".format(
            len(acc_ids)))
    if targets_dict is not None:
        with open(outfile + ".total.acc.num", "a+") as fo:
            fo.write("total target number is: {}\n".format(len(targets_dict)))
        # corpus (dict-insertion) order, NOT set order: the reference
        # iterates a set difference here, whose order depends on the
        # process hash seed — the one nondeterministic byte stream in its
        # whole output contract.  Same records, stable order.
        with open(outfile + ".unmatched.fa", "w") as out:
            for um in targets_dict:
                if um not in target_seq:
                    out.write(targets_dict[um])
    return pair_count


@contextmanager
def shared_corpus(params: ScanParams):
    """Every scan with ``params`` inside the block shares one device-resident
    corpus cache (each corpus encoded and uploaded once for all of them),
    released at the end; a cache the caller set already is the caller's."""
    if params.corpus_cache is not None:
        yield params
        return
    params.corpus_cache = {}
    try:
        yield params
    finally:
        params.corpus_cache = None       # release the device tensors


def run(primer_fa, ref_fa, outfile, params: ScanParams, targets_dict=None,
        device="cuda"):
    """Full coverage-validation flow; the device scans run on ``device``."""
    from ..utils import link as linkmod
    dev = linkmod.resolve_device(device)
    term_fa = os.path.splitext(primer_fa)[0] + ".term.fa"
    patterns, labels, keys, key_labels = expand_primer_fasta(
        primer_fa, params.term_len, term_fa, with_keys=True)
    if keys is not None:
        # degenerate mask scan: one pattern per key instead of per expansion
        # (identical rows — see expand_primer_fasta; fuzzed in test_scan.py)
        patterns, labels = keys, key_labels
    gene_ids, target_seqs = parse_fasta(ref_fa)
    rc_patterns = [iupac.rc(p) for p in patterns]
    with shared_corpus(params):
        f_hits = scan_hits_long(target_seqs, patterns, params, dev)
        r_hits = scan_hits_long(target_seqs, rc_patterns, params, dev)
    rows = pcr_join(gene_ids, f_hits, r_hits, labels, params.product_size)
    write_outputs(rows, outfile, targets_dict)
    return rows
