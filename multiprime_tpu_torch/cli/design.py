# Port of multiprime_tpu/cli/design.py: the same flags plus --device.
"""Degenerate primer design CLI, drop-in for multiPrime-core.py.

Same flags as multiPrime/scripts/multiPrime-core.py:60-102 plus ``--algo``
to pick the reference generation to reproduce (v16 = the one that
generated the shipped golden results), ``--stage-a`` to run Stage A as
batched torch ops, and ``--device {cuda,cpu}`` (default cuda; asking for
cuda without a GPU is an error, whatever the Stage-A backend).
"""

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description="Degenerate primer design (MC-DPD/MC-EDPD)")
    p.add_argument("-i", "--input", required=True, help="MSA fasta")
    p.add_argument("-l", "--plen", type=int, default=18)
    p.add_argument("-n", "--dnum", type=int, default=4)
    p.add_argument("-d", "--degeneracy", type=int, default=10)
    p.add_argument("-v", "--variation", type=int, default=1)
    p.add_argument("-e", "--entropy", type=float, default=3.6)
    p.add_argument("-g", "--gc", type=str, default="0.2,0.7")
    p.add_argument("-s", "--size", type=int, default=100)
    p.add_argument("-f", "--fraction", type=float, default=0.8)
    p.add_argument("-c", "--coordinate", type=str, default="1,2,-1",
                   help="v20/v16: comma list of forbidden mismatch positions; "
                        "v15: single int margin")
    p.add_argument("-p", "--proc", type=int, default=1)
    p.add_argument("-a", "--away", type=int, default=4)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--algo", choices=["v20", "v16", "v15", "v2"], default="v20",
                   help="design engine generation")
    p.add_argument("--stage-a", choices=["host", "device", "auto"],
                   default="host", dest="stage_a",
                   help="Stage-A backend: batched torch ops on --device, or "
                        "the bit-exact host path (identical outputs); auto "
                        "takes the device")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of device Stage A (default cuda; cpu "
                        "runs the torch ops on the host)")
    return p


def main(argv=None):
    from ..models import mcdpd
    from ..utils import link as linkmod
    args = build_parser().parse_args(argv)
    device = linkmod.resolve_device(args.device)
    gc = tuple(float(x) for x in args.gc.split(","))
    margin = 4
    coordinate = args.coordinate
    if args.algo == "v15":
        margin = int(args.coordinate.split(",")[0])
    params = mcdpd.DesignParams(
        primer_length=args.plen, coverage=args.fraction, dege_number=args.dnum,
        degeneracy=args.degeneracy, variation=args.variation,
        entropy_threshold=args.entropy, gc=gc, min_product=args.size,
        coordinate=coordinate, position_margin=margin,
        hairpin_distance=args.away, nproc=args.proc, algo=args.algo,
        stage_a=args.stage_a, device=device)
    ids, chars = mcdpd.parse_msa(args.input)
    eng = mcdpd.DesignEngine(params)
    try:
        results = eng.design(ids, chars)
    except ValueError as e:
        print("Error: {}".format(e))
        sys.exit(1)
    mcdpd.write_outputs(results, args.out)
    return 0


if __name__ == "__main__":
    t0 = time.time()
    main()
    print("INFO {} Total times: {}".format(
        time.strftime("%Y-%m-%d %H:%M:%S"), round(time.time() - t0, 2)))
