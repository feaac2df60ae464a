# Copied from multiprime_tpu/pipeline/stages.py (host code, no JAX).
"""Small format/glue stages of the pipeline.

Each function mirrors one reference glue script byte-for-byte, including
their `str.strip(chars)` path surgery quirks:

* primerset_format       — primerset_format.py:67-77
* txt2fa                 — candidate_primer_txt2fa.py:49-65
* core_extraction        — core_primerset_extraction.py:41-49
* seq_format             — seq_format.py:101-161
"""

from __future__ import annotations

import os
import re


def primerset_format(infile, outfile):
    """final_maxprimers_set.xls -> >Cluster_F/R fasta."""
    with open(infile) as fin, open(outfile, "w") as out:
        for line in fin:
            if line.startswith("#"):
                continue
            parts = line.strip().split("/")
            info = parts[-1].replace(".candidate.primers.txt", "").split("\t")
            if len(info) < 4:
                # cluster that exhausted every candidate pair against the
                # accumulated set: get_Maxprimerset writes a path-only row
                # with empty cells (get_Maxprimerset.py:346-348) and the
                # reference's primerset_format.py:74-77 CRASHES on it —
                # str.strip() eats the empty tab cells.  First fired at
                # the 1M-seq envelope (111 such rows); the cluster has no
                # pair in the final set (its candidates are in .next.xls),
                # so the only non-crashing contract is to skip the row.
                continue
            out.write(">" + info[0] + "_F\n" + info[2] + "\n"
                      + ">" + info[0] + "_R\n" + info[3] + "\n")


def txt2fa(infile, out_dir, number_file, step=5):
    """Candidate cluster rows -> per-cluster pair fasta + pair counts.

    The reported count is pairs+1 (the reference's counter starts at 1,
    candidate_primer_txt2fa.py:54-65)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(infile) as f, open(number_file, "w") as out:
        for line in f:
            fields = line.strip().split("\t")
            n = 1
            primer_number = 1
            cluster = fields[0].split("/")[-1].strip(".candidate.primers.txt")
            with open(os.path.join(
                    out_dir, cluster + ".candidate.primers.fa"), "w") as fa:
                while n < len(fields):
                    start, stop = fields[n + 4].split(":")
                    fa.write(">" + cluster + "_" + start + "_F\n" + fields[n]
                             + "\n>" + cluster + "_" + stop + "_R\n"
                             + fields[n + 1] + "\n")
                    n += step
                    primer_number += 1
            out.write(cluster + "\t" + str(primer_number) + "\n")


def core_extraction(infile, outfile, core_number=10):
    """Keep cluster rows whose member count (parsed from the Cluster_i_N
    filename) is >= core_number."""
    with open(infile) as fin, open(outfile, "w") as out:
        for line in fin:
            fields = line.strip().split("\t")
            name = fields[0].split("/")[-1]
            cluster_number = int(name.split("_")[-1].split(".")[0])
            if cluster_number >= core_number:
                out.write(line)


def seq_format(infile, outfile, gc_threshold=0.8, min_length=200,
               complete_only=False):
    """FASTA normalisation (seq_format.py): one-line sequences, ID cleanup
    (first token, split at :/-/|, >20 chars -> head_tail), strip
    non-IUPAC chars (U is *dropped*, not translated — the reference defines a
    U->T table but never applies it); drop short or GC-skewed records into
    <out>.filtered.fa.

    Quirk preserved: the length filter counts *raw line lengths including
    newlines* (seq_format.py:112), and the ID length check includes the
    trailing newline of the stored key.
    """
    seqs = {}
    lengths = {}
    complete_number = 0
    order = []
    with open(infile) as f:
        for line in f:
            if line.startswith(">"):
                key = line.strip().split(" ")[0]
                key = key.split(":")[0].split("-")[0].split("|")[0] + "\n"
                if len(key) > 20:
                    key = key[:9] + "_" + key[-9:]
                if key not in seqs:
                    order.append(key)
                    seqs[key] = ""
                    lengths[key] = 0
                if re.search("complete", line):
                    complete_number += 1
            elif line == "^--\n":
                pass
            else:
                value = re.sub("[^ACGTRYMKSWHBVDN]", "", line.strip().upper())
                seqs[key] += value
                lengths[key] += len(line)
    filtered = outfile.rstrip("fa") + "filtered.fa"
    with open(outfile, "w") as out, open(filtered, "w") as temp:
        for key in order:
            seq = seqs[key]
            if complete_only and complete_number > 0 \
                    and not re.search("complete", key):
                continue
            if lengths[key] < min_length:
                temp.write(key + seq + "\n")
                continue
            if not seq:
                temp.write(key + seq + "\n")
                continue
            gc = (seq.count("G") + seq.count("C")) / len(seq)
            if gc > gc_threshold or gc < 1 - gc_threshold:
                temp.write(key + seq + "\n")
            else:
                out.write(key + seq + "\n")


def prepare_pickle_txt(infile, outfile, column=0, value="T"):
    """prepare_pickle.py txt mode (:73-85): TSV -> {key_column: whole line}
    (value "T") or {key_column: [value_column, ...]} pickle."""
    import pickle
    from collections import defaultdict
    table = defaultdict(list)
    with open(infile) as f:
        for raw in f:
            line = raw.strip()
            fields = line.split("\t")
            key = fields[column]
            if value == "T":
                table[key] = line
            else:
                table[key].append(fields[int(value)])
    with open(outfile, "wb") as out:
        pickle.dump(table, out)


def prepare_pickle_fa(infile, outfile, headinfo="T"):
    """prepare_pickle.py fa mode (:88-115): fasta -> {accession: header+seq}
    pickle.  Reference quirks preserved: merged ">A ... >B ..." headers map
    every accession to the record, and for multi-line sequences each
    sequence line OVERWRITES the value (the dict keeps header + LAST line
    only)."""
    import pickle
    import re
    table = {}
    header, keys = None, []
    with open(infile) as f:
        for raw in f:
            if raw.startswith(">"):
                header = raw
                body = raw.lstrip(">")
                if re.search(">", body):
                    keys = [part.split(" ")[0]
                            for part in body.split(">")]
                else:
                    keys = [body.split(" ")[0]]
            else:
                value = (header + raw) if headinfo == "T" else raw
                for k in keys:
                    table[k] = value
    with open(outfile, "wb") as out:
        pickle.dump(table, out)


def extract_value_from_dict(infile, pickle_path, outfile, column=0,
                            head="F"):
    """extract_value_from_dict.py (:15-39): for every fasta header in
    ``infile`` whose TAB-split field ``column`` is a key of the pickled
    dict, write the stored record (head != "F") or only its first line."""
    import pickle
    with open(pickle_path, "rb") as f:
        table = pickle.load(f)
    with open(infile) as data, open(outfile, "w") as out:
        for raw in data:
            if not raw.startswith(">"):
                continue
            key = raw.lstrip(">").strip().split("\t")[column]
            if key in table:
                if head != "F":
                    out.write(table[key])
                else:
                    out.write(table[key].split("\n")[0] + "\n")
