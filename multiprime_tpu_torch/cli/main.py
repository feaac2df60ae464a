# Port of multiprime_tpu/cli/main.py: the run, design, pair and scan
# subcommands.
"""CLI of the PyTorch/CUDA port of the multiplex primer design framework.

  python -m multiprime_tpu_torch.cli.main run     full pipeline from a fasta
  python -m multiprime_tpu_torch.cli.main design  MC-DPD/MC-EDPD window design
  python -m multiprime_tpu_torch.cli.main pair    primer-pair selection
  python -m multiprime_tpu_torch.cli.main scan    mismatch coverage validation

run, design and scan take --device {cuda,cpu} (default cuda; asking for
cuda without a GPU is an error); pair is host-only.  The JAX package's
other subcommands are not ported yet (ROADMAP.md); they exit with status 2.
"""

import sys

_NOT_PORTED = ("solve", "findimer", "pcr", "tm",
               "tm-primer3", "dg", "expand", "kmer-filter", "seq-format",
               "ont", "update", "specificity", "roc", "wrc", "run-dege",
               "build-native", "nondimer-filter", "onestep")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "run":
        return _run(rest)
    if cmd == "design":
        from . import design
        return design.main(rest)
    if cmd == "pair":
        from . import pair
        return pair.main(rest) or 0
    if cmd == "scan":
        return _scan(rest)
    if cmd in _NOT_PORTED:
        print("%s: not ported yet (see ROADMAP.md)" % cmd)
        return 2
    print("unknown subcommand: " + cmd)
    print(__doc__)
    return 2


def _device_flag(p, default="cuda"):
    p.add_argument("--device", choices=["cuda", "cpu"], default=default,
                   help="torch device of the coverage scan and the device "
                        "Stage A and align backends (default cuda; cpu runs "
                        "the kernels' plain PyTorch versions)")


def _run(argv):
    import argparse
    from ..pipeline.driver import run_pipeline
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch run")
    p.add_argument("-c", "--config", help="multiPrime.yaml-compatible config")
    p.add_argument("-i", "--input")
    p.add_argument("-r", "--results",
                   help="results dir (default: 'results', or the config's)")
    p.add_argument("--algo", choices=["v20", "v16", "v15", "v2"],
                   help="design engine generation (default: v20/config; "
                        "v2 is not ported yet)")
    p.add_argument("--backend", choices=["mcdpd", "wrc"],
                   help="design backend: mcdpd (multiPrime); wrc is not "
                        "ported yet")
    p.add_argument("--variant", choices=["main", "original"],
                   help="pipeline variant: main (multiPrime.py DAG) or "
                        "original (multiPrime-original.py: no dict/ANI/"
                        "targets, core_V15 engine)")
    p.add_argument("--coverage", type=float)
    p.add_argument("--devices", type=int, metavar="N",
                   help="number of GPUs (default 1; more is not ported yet)")
    p.add_argument("--stage-a", choices=["host", "device", "auto"],
                   dest="stage_a",
                   help="design Stage-A backend (default: host/config): "
                        "device runs it as torch ops on --device, auto "
                        "takes the device")
    p.add_argument("--cluster-shard", dest="cluster_shard", metavar="i/P",
                   help="run only every P-th cluster of the fan-out "
                        "(multi-host: each host runs its shard against a "
                        "shared results dir; any later run completes the "
                        "solve/validate tail via file-level resume)")
    p.add_argument("--pcr-products", dest="pcr_products",
                   choices=["full", "gzip", "summary"],
                   help="per-pair PCR-product FASTA bodies (default full; "
                        "summary/gzip cut the large-scale IO tail)")
    p.add_argument("--nproc", type=int,
                   help="host worker processes of the per-cluster fan-out "
                        "(default 1/config)")
    _device_flag(p, default=None)
    args = p.parse_args(argv)
    # only explicit flags override the config file
    overrides = {}
    if args.input:
        overrides["input_fa"] = args.input
    if args.results is not None:
        overrides["results_dir"] = args.results
    elif not args.config:
        overrides["results_dir"] = "results"
    for key in ("algo", "coverage", "devices", "stage_a", "cluster_shard",
                "pcr_products", "nproc", "device"):
        if getattr(args, key) is not None:
            overrides[key] = getattr(args, key)
    if args.backend is not None:
        overrides["design_backend"] = args.backend
    if args.variant is not None:
        overrides["pipeline_variant"] = args.variant
    pipe, log = run_pipeline(args.config, **overrides)
    for name, status, dt in log:
        print("%-20s %-8s %ss" % (name, status, dt))
    return 0


def _scan(argv):
    import argparse
    import pickle
    from ..validate import scan as vscan
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch scan")
    p.add_argument("-i", "--input", required=True, help="primer fasta")
    p.add_argument("-r", "--ref", required=True, help="targets fasta")
    p.add_argument("-l", "--len", type=int, default=0)
    p.add_argument("-t", "--term", type=int, default=4)
    p.add_argument("-m", "--seedmms", type=int, default=1)
    p.add_argument("-s", "--size", default="100,1500")
    p.add_argument("-d", "--dict", default="None")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "numpy", "device"],
                   help="scan backend (default auto = device; numpy = the "
                        "native host scan)")
    _device_flag(p)
    args = p.parse_args(argv)
    targets_dict = None
    if args.dict != "None":
        with open(args.dict, "rb") as f:
            targets_dict = pickle.load(f)
    params = vscan.ScanParams(
        term_len=args.len, term=args.term, mm=args.seedmms,
        product_size=tuple(int(x) for x in args.size.split(",")),
        backend=args.backend)
    vscan.run(args.input, args.ref, args.out, params, targets_dict,
              device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
