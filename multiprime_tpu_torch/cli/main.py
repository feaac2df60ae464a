# Port of multiprime_tpu/cli/main.py: every subcommand; those that reach
# the coverage scan or device Stage A take --device.
"""CLI of the PyTorch/CUDA port of the multiplex primer design framework.

Subcommands map 1:1 onto the reference's script zoo (python -m
multiprime_tpu_torch.cli.main <cmd>):

  run          full pipeline from a fasta (replaces snakemake multiPrime.py)
  design       MC-DPD/MC-EDPD window design   (multiPrime-core.py)
  pair         primer-pair selection          (get_multiPrime.py)
  solve        greedy minimal set             (get_Maxprimerset.py)
  findimer     all-vs-all dimer scan          (finDimer.py)
  scan         mismatch coverage validation   (primer_coverage_validation_by_BWT.py)
  pcr          perfect-match in-silico PCR    (extract_PCR_product.py)
  tm           melting temperatures           (CalcTm.py)
  tm-primer3   oligotm cross-check Tm         (CalcTm_primer3.py)
  dg           free energies                  (free_energy.py)
  expand       degenerate expansion           (dege_expand.py)
  kmer-filter  k-mer prefilter                (kmer_filter.py)
  seq-format   fasta normalisation            (seq_format.py)
  ont          classify ONT read ends         (FindONTprimerV3.py)
  update       check new primers vs core set  (Primer_set_update.py)
  specificity  background off-target scan     (primer_specificity.py)
  roc          capture-prediction metrics     (test_data/ROC/ROC.py)
  wrc          DEGEPRIME-style WRC design     (DegePrime.pl)
  run-dege     DegePrime driver wrapper       (run_dege.py)
  build-native pre-build the C++ runtime .so  (wheel/install helper)
  nondimer-filter  keep new primers dimer-free vs a pool
                                              (primer_filter.sh / select.nondimer.primer.sh)
  onestep      design + pair + coverage scan  (multiPrime_onestep_all.py)

run, design, scan, specificity, update and onestep take --device
{cuda,cpu} (default cuda; asking for cuda without a GPU is an error; cpu
runs the kernels' plain PyTorch versions).  The others are host code.
run and onestep take --devices N: a mesh of N devices of --device's type
(cuda:0..N-1, which must be present; or N CPU entries) that shards the
device Stage A and the coverage scan, with the same outputs as one device.
"""

import importlib
import sys

from ..utils import trace

# subcommand -> (module of this package, function); module None is this one
COMMANDS = {
    "run": (None, "_run"),
    "design": ("design", "main"),
    "pair": ("pair", "main"),
    "solve": (None, "_solve"),
    "findimer": (None, "_findimer"),
    "scan": (None, "_scan"),
    "pcr": (None, "_pcr"),
    "tm": ("tools", "tm_main"),
    "tm-primer3": ("tools", "tm_primer3_main"),
    "dg": ("tools", "dg_main"),
    "expand": ("tools", "expand_main"),
    "kmer-filter": ("tools", "kmer_filter_main"),
    "seq-format": (None, "_seq_format"),
    "ont": (None, "_ont"),
    "update": (None, "_update"),
    "specificity": (None, "_specificity"),
    "roc": (None, "_roc"),
    "wrc": (None, "_wrc"),
    "run-dege": (None, "_run_dege"),
    "build-native": (None, "_build_native"),
    "nondimer-filter": (None, "_nondimer_filter"),
    "onestep": (None, "_onestep"),
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print("unknown subcommand: " + cmd)
        print(__doc__)
        return 2
    module, name = COMMANDS[cmd]
    if module is None:
        fn = globals()[name]
    else:
        fn = getattr(importlib.import_module("." + module, __package__), name)
    # one request a command: its spans are recorded only under an active
    # torch.profiler session (utils/trace.py)
    with trace.request(cmd):
        return fn(rest) or 0


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
                   help="design engine generation (default: v20/config)")
    p.add_argument("--backend", choices=["mcdpd", "wrc"],
                   help="design backend: mcdpd (multiPrime) or wrc "
                        "(multi-DegePrime flow)")
    p.add_argument("--variant", choices=["main", "original"],
                   help="pipeline variant: main (multiPrime.py DAG) or "
                        "original (multiPrime-original.py: no dict/ANI/"
                        "targets, core_V15 engine)")
    p.add_argument("--coverage", type=float)
    p.add_argument("--devices", type=int, metavar="N",
                   help="shard the device design Stage A and the coverage "
                        "scan over a mesh of N devices of --device's type "
                        "(default 1; N GPUs must be present)")
    p.add_argument("--stage-a", choices=["host", "device", "auto"],
                   dest="stage_a",
                   help="design Stage-A backend (default: host/config): "
                        "device runs it as CUDA kernels on --device, auto "
                        "takes the side the measured crossover picks")
    p.add_argument("--refine", choices=["host", "device"],
                   help="where the MSA polish passes run (default: "
                        "host/config): host runs the native DP, device the "
                        "refine DP kernels on --device; the rows are the "
                        "same")
    p.add_argument("--cluster-shard", dest="cluster_shard", metavar="i/P",
                   help="run only every P-th cluster of the fan-out "
                        "(multi-host: each host runs its shard against a "
                        "shared results dir; any later run completes the "
                        "solve/validate tail via file-level resume; "
                        "defaults to this process's rank/world size under "
                        "an initialised torch.distributed group)")
    p.add_argument("--pcr-products", dest="pcr_products",
                   choices=["full", "gzip", "summary"],
                   help="per-pair PCR-product FASTA bodies (default full; "
                        "summary/gzip cut the large-scale IO tail)")
    p.add_argument("--nproc", type=int,
                   help="host worker processes of the per-cluster fan-out "
                        "(default 1/config)")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a torch.profiler trace of the whole run "
                        "(CPU, and CUDA on a GPU; TensorBoard trace files "
                        "under DIR) and the program's spans, the pool's "
                        "workers' included (DIR/spans.json, a Chrome "
                        "trace), beside the per-stage wall-clock timings "
                        "in pipeline_metrics.json; without --nproc the run "
                        "takes one process")
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
                "pcr_products", "nproc", "device", "refine"):
        if getattr(args, key) is not None:
            overrides[key] = getattr(args, key)
    if args.backend is not None:
        overrides["design_backend"] = args.backend
    if args.variant is not None:
        overrides["pipeline_variant"] = args.variant
    if args.profile:
        pipe, log = _profiled(args.profile, args.device, args.config,
                              overrides)
    else:
        pipe, log = run_pipeline(args.config, **overrides)
    for name, status, dt in log:
        if name in _SUMMED:
            name += " (summed over workers)"
        print("%-20s %-8s %ss" % (name, status, dt))
    return 0


# stages whose printed seconds are busy time summed over the fan-out's
# workers, not wall
_SUMMED = ("align", "design", "pair")


def _profiled(trace_dir, device, config, overrides):
    """run_pipeline inside torch.profiler: CPU activities, plus CUDA when
    the run's device is a GPU; the trace is written under trace_dir by
    tensorboard_trace_handler, and the run's spans, its pool's workers'
    included, as trace_dir/spans.json (utils/trace.py; the profiler itself
    does not follow the workers).  Without an explicit --nproc the run
    takes one process."""
    import json
    import os

    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                tensorboard_trace_handler)
    from ..pipeline.driver import PipelineConfig, run_pipeline
    if device is None:
        device = (PipelineConfig.from_yaml(config) if config
                  else PipelineConfig()).device
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    overrides.setdefault("nproc", 1)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        with trace.request("run"):
            # one range over the whole run: its span is the run's wall
            with record_function("run_pipeline"):
                out = run_pipeline(config, **overrides)
        request = trace.last_request()
    os.makedirs(trace_dir, exist_ok=True)
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump(trace.chrome(trace.spans(request)), f)
    return out


def _solve(argv):
    import argparse
    from ..solve import maxset
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch solve")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-s", "--step", type=int, default=5)
    p.add_argument("-m", "--method", default="T")
    p.add_argument("-o", "--out", required=True)
    args = p.parse_args(argv)
    import os
    import re
    if re.search("/", args.input):
        parts = args.input.split("/")
        sort = "/".join(parts[:-1]) + "/sort." + parts[-1]
    else:
        sort = "sort." + args.input
    primers = maxset.parse_and_sort(args.input, sort)
    if args.method == "T":
        nxt = args.out.rstrip(".xls") + ".next.xls"
        maxset.greedy_maximal(primers, args.out, nxt, step=args.step)
    else:
        maxset.greedy_maximum(primers, args.out, step=args.step)
    return 0


def _findimer(argv):
    import argparse
    from ..validate import findimer
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch findimer")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-t", "--threshold", type=float, default=3.96)
    p.add_argument("-n", "--num", type=int, default=1)
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)
    rows = findimer.scan(findimer.parse_primer_fasta(args.input),
                         threshold=args.threshold)
    findimer.write_outputs(rows, args.output)
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


def _pcr(argv):
    import argparse
    from ..validate import pcr
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch pcr")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-r", "--ref", required=True)
    p.add_argument("-f", "--format", default="fa", choices=["fa", "xls", "seq"])
    p.add_argument("-o", "--out", required=True, help="products directory")
    p.add_argument("-s", "--stast", required=True, help="coverage summary")
    p.add_argument("--products", default="full",
                   choices=["full", "gzip", "summary"],
                   help="per-pair FASTA bodies: full (reference contract), "
                        "gzip (.fa.gz), summary (counts only)")
    args = p.parse_args(argv)
    if args.format == "seq":
        f, r = args.input.split(",")
        pairs = {"PCR_info": (f, r)}
    elif args.format == "xls":
        pairs = pcr.parse_pairs_xls(args.input)
    else:
        pairs = pcr.parse_pairs_fa(args.input)
    pcr.run(pairs, args.ref, args.out, args.stast, products=args.products)
    return 0


def _seq_format(argv):
    import argparse
    from ..pipeline import stages
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch seq-format")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-g", "--gc", type=float, default=0.8)
    p.add_argument("-l", "--length", type=int, default=200)
    p.add_argument("-c", "--complete", default="F")
    args = p.parse_args(argv)
    stages.seq_format(args.input, args.out, gc_threshold=args.gc,
                      min_length=args.length,
                      complete_only=args.complete == "T")
    return 0


def _ont(argv):
    import argparse
    from ..validate import ont
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch ont")
    p.add_argument("-i", "--input", required=True, help="reads (fa/fq[.gz])")
    p.add_argument("-s", "--set", required=True, help="primer fasta")
    p.add_argument("-l", "--len", type=int, default=18)
    p.add_argument("-m", "--min-ident", type=float, default=0.8)
    p.add_argument("-f", "--format", default="fq", choices=["fq", "fa"])
    p.add_argument("--metric", default="difflib",
                   choices=["difflib", "banded"])
    p.add_argument("--variant", action="store_true",
                   help="report the matching expansion variant "
                        "(FindONTexpandprimer behaviour)")
    p.add_argument("-o", "--out", required=True)
    a = p.parse_args(argv)
    ont.run(a.input, a.set, a.out, a.len, a.min_ident, a.format, a.metric,
            a.variant)
    return 0


def _update(argv):
    import argparse
    from ..validate import update
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch update")
    p.add_argument("-i", "--input", required=True, help="new primer fasta")
    p.add_argument("-c", "--core", required=True, help="core set fasta")
    p.add_argument("-r", "--ref", default="", help="reference DB fasta")
    p.add_argument("-f", "--func", default="DO",
                   help='"D" = dimer, "O" = off-targets, "DO" = both '
                        "(Primer_set_update.py -f)")
    p.add_argument("-o", "--out", required=True, help="output prefix")
    _device_flag(p)
    a = p.parse_args(argv)
    update.run(a.input, a.core, a.ref, a.out, a.func, device=a.device)
    return 0


def _specificity(argv):
    import argparse
    from ..validate import specificity
    # flag set mirrors primer_specificity.py's argsParse (:64-111)
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch specificity")
    p.add_argument("-i", "--input", required=True, help="primer fasta")
    p.add_argument("-r", "--ref", required=True, help="background DB fasta")
    p.add_argument("-l", "--len", type=int, default=18, dest="len_",
                   help="scan only the 3'-terminal l-mer (0 = full primer)")
    p.add_argument("-t", "--term", type=int, default=4)
    p.add_argument("-m", "--seedmms", type=int, default=1)
    p.add_argument("-s", "--size", default="100,1500")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--exhaustive-join", action="store_true",
                   help="complete F x R join (skip the reference's "
                        "per-gene early exit; use for genome-scale "
                        "backgrounds)")
    _device_flag(p)
    a = p.parse_args(argv)
    specificity.run(a.input, a.ref, a.out, term_len=a.len_, mm=a.seedmms,
                    term=a.term,
                    product_size=tuple(int(x) for x in a.size.split(",")),
                    exhaustive_join=a.exhaustive_join, device=a.device)
    return 0


def _roc(argv):
    import argparse
    from ..validate import metrics
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch roc")
    p.add_argument("-i", "--input", required=True,
                   help="csv: sample,real,predict")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-d", "--plot-dir", default=None,
                   help="write roc.<auc>.png/.pdf here (ROC.py plotauc)")
    a = p.parse_args(argv)
    result = metrics.roc_analysis(a.input, a.out, plot_dir=a.plot_dir)
    print("acc={acc} mcc={mcc} auc={auc}".format(
        acc=result["acc"], mcc=result["mcc"], auc=result["auc"]))
    return 0


def _wrc(argv):
    import argparse
    from ..models import wrc
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch wrc")
    p.add_argument("-i", "--input", required=True, help="MSA fasta")
    p.add_argument("-l", "--plen", type=int, default=18)
    p.add_argument("-d", "--maxdeg", type=int, default=96)
    p.add_argument("-n", "--iterations", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trim", type=float, default=0.0,
                   help="min column occupancy (TrimAlignment -min; the "
                        "pipeline default keeps every column)")
    p.add_argument("--skip", type=int, default=20,
                   help="skip this many bases at both sequence ends "
                        "(DegePrime -skip)")
    p.add_argument("--depth", type=int, default=1,
                   help="min zero-indel spanning mers (DegePrime -depth)")
    p.add_argument("-o", "--out", required=True)
    a = p.parse_args(argv)
    ids, rows = wrc.read_fasta_raw(a.input)
    trimmed, kept = wrc.trim_alignment(rows, min_occupancy=a.trim)
    table = wrc.design_windows(trimmed, plen=a.plen, max_deg=a.maxdeg,
                               iterations=a.iterations, seed=a.seed,
                               min_depth=a.depth, skip_length=a.skip)
    wrc.write_design(table, a.out)
    return 0


def _run_dege(argv):
    """The run_dege.py wrapper role (multiPrime/scripts/run_dege.py:
    81-95): drive the WRC designer over an alignment with DegePrime's -l/-d
    flags, write through a .tmp rename, print the reference's
    `INFO <ts> Total times:` line."""
    import argparse
    import os
    import time
    from ..models import wrc
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch run-dege")
    p.add_argument("-i", "--input", required=True, help="aligned fasta")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-l", "--length", type=int, default=18,
                   help="primer length")
    p.add_argument("-d", "--deg", type=int, default=4,
                   help="max degeneracy")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    t0 = time.time()
    ids, rows = wrc.read_fasta_raw(a.input)
    table = wrc.design_windows(rows, plen=a.length, max_deg=a.deg,
                               seed=a.seed)
    tmp = a.out + ".tmp"
    wrc.write_design(table, tmp)
    os.rename(tmp, a.out)
    print("INFO {} Total times: {}".format(
        time.strftime("%Y-%m-%d %H:%M:%S"), round(time.time() - t0, 2)))
    return 0


def _build_native(argv):
    """Pre-build the native runtime (.so) so first `import` on a fresh
    install never needs g++ at run time — the wheel-shipping story for the
    lazy builder (native/__init__.py)."""
    from .. import native
    lib = native.load()
    if lib is None:
        print("native build FAILED — check g++; NumPy fallbacks active")
        return 1
    print("native runtime ready:", native._SO)
    return 0


def _nondimer_filter(argv):
    import argparse
    from ..validate import update
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch nondimer-filter")
    p.add_argument("-i", "--input", required=True, help="new primers fasta")
    p.add_argument("-p", "--pool", required=True, help="pool/core fasta")
    p.add_argument("-o", "--out", required=True, help="clean fasta")
    a = p.parse_args(argv)
    kept = update.select_nondimer(a.input, a.pool, a.out)
    print("kept %d dimer-free primers -> %s" % (len(kept), a.out))
    return 0


def _onestep(argv):
    """MSA -> design -> pair -> mismatch coverage scan in one process
    (multiPrime_onestep_all.py:63-122,1846-1864: NN_degenerate then
    Primers_filter — diff_Tm IS forwarded here, default 4, unlike
    get_multiPrime's main() — then off_targets on the pair fasta with
    term_length = full primer length).  The scan runs on --device."""
    import argparse
    import contextlib
    from ..utils import link as linkmod
    p = argparse.ArgumentParser(prog="multiprime_tpu_torch onestep")
    p.add_argument("-i", "--input", required=True, help="MSA fasta")
    p.add_argument("-r", "--ref", required=True,
                   help="all cluster sequences in one fasta (.tfa)")
    p.add_argument("-l", "--plen", type=int, default=18)
    p.add_argument("-n", "--dnum", type=int, default=4)
    p.add_argument("-d", "--degeneracy", type=int, default=10)
    p.add_argument("-v", "--variation", type=int, default=1)
    p.add_argument("--entropy", type=float, default=3.6)
    p.add_argument("-e", "--end", type=int, default=4)
    p.add_argument("-g", "--gc", default="0.2,0.7")
    p.add_argument("-s", "--size", default="250,500")
    p.add_argument("--predictSize", default="50,1500")
    p.add_argument("-t", "--Tm", type=float, default=4)
    p.add_argument("--adaptor",
                   default="TCTTTCCCTACACGACGCTCTTCCGATCT,"
                           "TGGAGTTCAGACGTGTGCTCTTCCGATCT")
    p.add_argument("-f", "--fraction", type=float, default=0.6)
    p.add_argument("-c", "--coordinate", default="1,2,-1")
    p.add_argument("-p", "--proc", type=int, default=1)
    p.add_argument("-a", "--away", type=int, default=4)
    p.add_argument("--algo", default="v20", choices=["v20", "v16", "v15", "v2"])
    p.add_argument("--devices", type=int, default=1,
                   help="shard the coverage scan (and device Stage A) over "
                        "a mesh of N devices of --device's type, like run "
                        "--devices (N GPUs must be present)")
    p.add_argument("--out1", required=True, help="design table")
    p.add_argument("-o", "--out2", required=True, help="candidate pairs .txt")
    _device_flag(p)
    a = p.parse_args(argv)
    device = linkmod.resolve_device(a.device)
    mesh_ctx = contextlib.nullcontext()
    if a.devices and a.devices > 1:
        from ..parallel import mesh as pmesh
        mesh_ctx = pmesh.use_mesh(pmesh.make_mesh(a.devices, device=device))
    with mesh_ctx:
        return _onestep_body(a, device)


def _onestep_body(a, device):
    import json
    from ..models import mcdpd, pairing
    from ..validate import scan as vscan
    size = tuple(int(x) for x in a.size.split(","))
    ids, chars = mcdpd.parse_msa(a.input)
    # reference bug preserved: onestep's NN_degenerate gets the full
    # "min,max" string and its span check reads int(product[0]) — the
    # FIRST CHARACTER (multiPrime_onestep_all.py seq_attribute), so the
    # min-span abort threshold is e.g. 2 for "250,500"
    dparams = mcdpd.DesignParams(
        primer_length=a.plen, coverage=a.fraction, dege_number=a.dnum,
        degeneracy=a.degeneracy, variation=a.variation,
        entropy_threshold=a.entropy,
        gc=tuple(float(x) for x in a.gc.split(",")),
        min_product=int(a.size[0]), coordinate=a.coordinate,
        hairpin_distance=a.away, algo=a.algo, nproc=a.proc, device=device)
    results = mcdpd.DesignEngine(dparams).design(ids, chars)
    mcdpd.write_outputs(results, a.out1)

    pparams = pairing.PairingParams(
        size=size, fraction=a.fraction, end_dege=a.end,
        hairpin_distance=a.away, diff_tm=a.Tm, max_seq=0,
        adaptor=tuple(a.adaptor.split(",")), nproc=a.proc)
    primers = pairing.parse_primer_table(a.out1)
    gap_ids = json.load(open(a.out1 + ".gap_seq_id_json"))
    non_cover = json.load(open(a.out1 + ".non_coverage_seq_id_json"))
    number = pairing.count_ref_seqs(a.ref, 0)
    pairs, _ = pairing.PairingEngine(pparams).pair(
        primers, gap_ids, non_cover, number)
    pairing.write_outputs(pairs, a.out2)

    stem = a.out2.strip(".txt")    # reference's char-set strip, replicated
    sparams = vscan.ScanParams(
        term_len=a.plen, term=a.end, mm=a.variation,
        product_size=tuple(int(x) for x in a.predictSize.split(",")))
    vscan.run(stem + ".fa", a.ref, stem + "_target", sparams, device=device)
    print("onestep: %d pairs -> %s, coverage -> %s_target"
          % (len(pairs), a.out2, stem))
    return 0


if __name__ == "__main__":
    sys.exit(main())
