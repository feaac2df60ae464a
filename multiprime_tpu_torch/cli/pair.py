# Copied from multiprime_tpu/cli/pair.py (host code, no JAX).
"""Primer-pair selection CLI — drop-in for get_multiPrime.py."""

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description="Primer-pair selection")
    p.add_argument("-i", "--input", required=True,
                   help="design output (.top.primer.out); its two JSON "
                        "sidecars must sit next to it")
    p.add_argument("-r", "--ref", required=True, help="cluster fasta (.tfa)")
    p.add_argument("-g", "--gc", type=str, default="0.2,0.7", help="parsed but pre-filter uses 0.4,0.6 like the reference")
    p.add_argument("-f", "--fraction", type=float, default=0.6)
    p.add_argument("-e", "--end", type=int, default=4)
    p.add_argument("-p", "--proc", type=int, default=1)
    p.add_argument("-s", "--size", type=str, default="250,500")
    p.add_argument("-d", "--dist", type=int, default=4)
    p.add_argument("-t", "--Tm", type=float, default=5,
                   help="max Tm difference F vs R (the golden runs used 5)")
    p.add_argument("-a", "--adaptor", type=str,
                   default="TCTTTCCCTACACGACGCTCTTCCGATCT,"
                           "TCTTTCCCTACACGACGCTCTTCCGATCT")
    p.add_argument("-m", "--maxseq", type=int, default=0)
    p.add_argument("-o", "--out", required=True)
    return p


def main(argv=None):
    from ..models import pairing
    args = build_parser().parse_args(argv)
    adaptor = tuple(args.adaptor.split(","))
    # NB: gc deliberately NOT forwarded — the reference main() drops -g and
    # the pre-filter always runs at the class default (0.4, 0.6).
    params = pairing.PairingParams(
        size=tuple(int(x) for x in args.size.split(",")),
        fraction=args.fraction, end_dege=args.end,
        hairpin_distance=args.dist, diff_tm=args.Tm, adaptor=adaptor,
        max_seq=args.maxseq, nproc=args.proc)
    primers = pairing.parse_primer_table(args.input)
    with open(args.input + ".gap_seq_id_json") as f:
        gap_ids = json.load(f)
    with open(args.input + ".non_coverage_seq_id_json") as f:
        non_cover = json.load(f)
    number = pairing.count_ref_seqs(args.ref, args.maxseq)
    eng = pairing.PairingEngine(params)
    pairs, _ = eng.pair(primers, gap_ids, non_cover, number)
    if pairs is None:
        print("Max PCR product legnth < min len!")
        pairing.write_empty_output(args.out)
        return
    print("Candidate primer pairs: {}".format(len(pairs)))
    pairing.write_outputs(pairs, args.out)


if __name__ == "__main__":
    t0 = time.time()
    main()
    print("INFO {} Total times: {}".format(
        time.strftime("%Y-%m-%d %H:%M:%S"), round(time.time() - t0, 2)))
