# Copied from multiprime_tpu/cli/tools.py (host code, no JAX).
"""Standalone tool CLIs mirroring the reference's utility scripts:

* tm          — CalcTm.py (NN Tm with settable PCR conditions)
* tm-primer3  — CalcTm_primer3.py (native oligotm re-implementation)
* dg          — free_energy.py (unified / H_bonds dG)
* expand      — dege_expand.py (degenerate fasta -> expanded fasta)
* kmer-filter — kmer_filter.py (GC / run / clamp filter for k-mer fastas)
"""

import argparse
import sys

from ..thermo import exact as thermo
from ..utils import iupac


def _iter_fasta(path):
    name = None
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                name = line.strip()
            elif line.strip():
                yield name, line.strip()


def tm_main(argv=None):
    p = argparse.ArgumentParser(description="NN melting temperature (CalcTm)")
    p.add_argument("-i", "--input", required=True,
                   help="fasta of primers, or a bare sequence with -f seq")
    p.add_argument("-f", "--format", default="fa", choices=["fa", "seq"])
    p.add_argument("-m", "--mono", type=float, default=50)
    p.add_argument("-d", "--divalent", type=float, default=1.5)
    p.add_argument("-n", "--dntp", type=float, default=0.25)
    p.add_argument("-c", "--conc", type=float, default=100)
    p.add_argument("-o", "--out", default="-")
    args = p.parse_args(argv)
    out = sys.stdout if args.out == "-" else open(args.out, "w")

    def emit(name, seq):
        tms = [thermo.tm_conditions(s, args.mono, args.divalent, args.dntp,
                                    args.conc)
               for s in iupac.expand(seq.upper())]
        mean_tm = round(thermo._stat_mean(tms), 2)
        out.write("%s\t%s\t%s\n" % (name or seq, seq, mean_tm))

    if args.format == "seq":
        emit(None, args.input)
    else:
        for name, seq in _iter_fasta(args.input):
            emit(name, seq)
    if out is not sys.stdout:
        out.close()


def tm_primer3_main(argv=None):
    """CalcTm_primer3.py equivalent (reference scripts/CalcTm_primer3.py:
    46-144): same flags/defaults, same output rows (info\\tprimer\\tTm with
    full float repr), backed by the native oligotm re-implementation in
    thermo/primer3_tm.py instead of the absent primer3 C library."""
    from ..thermo import primer3_tm
    p = argparse.ArgumentParser(
        description="primer3-backed Tm cross-check (CalcTm_primer3)")
    p.add_argument("-i", "--input", required=True,
                   help="fasta of primers, or a bare sequence with -f seq")
    p.add_argument("-f", "--format", default="fa", choices=["fa", "seq"])
    p.add_argument("-o", "--out", default="primer_Tm.xls")
    p.add_argument("-p", "--primer_conc", type=float, default=150,
                   help="primer concentration, nM (default 150)")
    p.add_argument("-m", "--mono_conc", type=float, default=50,
                   help="monovalent concentration, mM (default 50)")
    p.add_argument("-d", "--diva_conc", type=float, default=1.5,
                   help="divalent concentration, mM (default 1.5)")
    p.add_argument("-n", "--dntp_conc", type=float, default=0.6,
                   help="dNTP concentration, mM (default 0.6)")
    p.add_argument("--expand", action="store_true",
                   help="average Tm over IUPAC expansions instead of "
                        "reporting the library's error value (extension)")
    args = p.parse_args(argv)

    def one_tm(seq):
        fn = (primer3_tm.calc_tm_degenerate if args.expand
              else primer3_tm.calc_tm)
        return fn(seq, mv_conc=args.mono_conc, dv_conc=args.diva_conc,
                  dntp_conc=args.dntp_conc, dna_conc=args.primer_conc)

    with open(args.out, "w") as o:
        if args.format == "fa":
            for name, seq in _iter_fasta(args.input):
                o.write("%s\t%s\t%s\n" % (name, seq, one_tm(seq)))
        else:
            tm_val = one_tm(args.input)
            print("{}: {}".format(args.input, tm_val))
            o.write(args.input + "\t" + str(tm_val) + "\n")


def dg_main(argv=None):
    p = argparse.ArgumentParser(description="Free energy (free_energy.py)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-f", "--format", default="fa", choices=["fa", "seq", "xls"])
    p.add_argument("-g", "--gini", default="unified",
                   choices=["unified", "H_bonds"])
    p.add_argument("-p", "--position", type=int, default=0,
                   help="column index for xls format")
    p.add_argument("-o", "--out", default="-")
    args = p.parse_args(argv)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    if args.format == "seq":
        dg = thermo.delta_g_cli(args.input.upper(), args.gini)
        out.write(args.input + "\t" + str(dg) + "\n")
    elif args.format == "xls":
        for line in open(args.input):
            fields = line.strip().split("\t")
            dg = thermo.delta_g_cli(fields[args.position].upper(), args.gini)
            out.write(line.strip() + "\t" + str(dg) + "\n")
    else:
        for name, seq in _iter_fasta(args.input):
            dg = thermo.delta_g_cli(seq.upper(), args.gini)
            out.write(name + "\t" + seq + "\t" + str(dg) + "\n")
    if out is not sys.stdout:
        out.close()


def expand_main(argv=None):
    """dege_expand.py: each record's expansions get _0.._k suffixes."""
    p = argparse.ArgumentParser(description="Expand degenerate fasta")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", default="-")
    args = p.parse_args(argv)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for name, seq in _iter_fasta(args.input):
        for j, e in enumerate(iupac.expand(seq.upper())):
            out.write("%s_%d\n%s\n" % (name, j, e))
    if out is not sys.stdout:
        out.close()


def kmer_filter_main(argv=None):
    """kmer_filter.py: keep k-mers passing GC bounds, no di/tri-nucleotide
    runs, no GC-rich 3' clamp."""
    from ..models.mcdpd import DesignEngine, DesignParams
    p = argparse.ArgumentParser(description="Filter k-mer fasta")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-g", "--gc", default="0.2,0.7")
    p.add_argument("-o", "--out", default="-")
    args = p.parse_args(argv)
    lo, hi = (float(x) for x in args.gc.split(","))
    eng = DesignEngine(DesignParams(gc=(lo, hi)))
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for name, seq in _iter_fasta(args.input):
        seq = seq.upper()
        gc = thermo.gc_degenerate_mean(seq)
        if not lo <= gc <= hi:
            continue
        # kmer_filter.py:135-142: the clamp is GC of the LAST 5 bases only
        # (unlike the design engine's 4..16-suffix scan).
        if eng.di_nucleotide(seq) or thermo.gc_degenerate_mean(seq[-5:]) > 0.6:
            continue
        out.write(name + "\n" + seq + "\n")
    if out is not sys.stdout:
        out.close()
