"""Build, bind and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled by ``nvcc`` into ``_build/lib<name>.so`` at first use (rebuilt when
the source or a shared ``csrc/*.cuh`` header is newer), then loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.  A failed build
raises with the compiler's stderr.  Nothing here runs at import time, so
the CPU tests import the package without a CUDA toolkit.

Every wrapper checks its tensors with ``check_inputs`` and launches with
``launch``, the one place a launcher is called: it times the launch for
the trace, raises on the launcher's error code and counts the launch by
its prefix (``launches``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", SRC_DIR]

# per kernel source: the compiler's output (the ptxas register and
# shared-memory report), for the on-card smoke check
BUILD_LOG = {}

_libs = {}
_lock = threading.Lock()
# successful launches of each launcher in this process (never of a plain
# version), by prefix: a run reads them to show its path went through
# the kernels
_LAUNCHED = {}
_count_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                       "kernels in %s cannot be built" % SRC_DIR)


def _paths(name):
    return (os.path.join(SRC_DIR, name + ".cu"),
            os.path.join(BUILD_DIR, "lib%s.so" % name))


def _stale(name):
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    headers = [os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
               if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(map(os.path.getmtime, [src, *headers]))


def build(names=None, force=False):
    """Compile the given kernel sources (default: every ``csrc/*.cu``) that
    are missing or stale (all of them with ``force``), one ``nvcc`` each,
    all started together."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        src, so = _paths(name)
        tmp = "%s.tmp.%d" % (so, os.getpid())
        procs[name] = (tmp, so, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, so, proc) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[name] = out + err
        if proc.returncode != 0:
            failed.append("nvcc failed on %s.cu (exit %d):\n%s"
                          % (name, proc.returncode, out + err))
        else:
            # rename into place: dlopen dedups by inode, a reload must see
            # the new file
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


_PTR = ctypes.c_void_p             # pointers and the stream: never 32-bit
_I64, _INT = ctypes.c_int64, ctypes.c_int


def _bind(lib, launchers):
    """Set the argument types of each ``<prefix>_launch`` of a library
    (``launchers``: prefix -> argument types; each returns a CUDA error
    code, its last argument the stream) and of the
    ``<prefix>_error_string`` beside it."""
    for prefix, launch_args in launchers.items():
        fn = getattr(lib, prefix + "_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = list(launch_args)
        err = getattr(lib, prefix + "_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]


# the launchers of each library: masks, planes, [suffix planes,] output,
# N, L, P, plen, [mm, term,] stream for the scan kernels
_LAUNCHERS = {
    "hit_codes": {"hit_codes": (_PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64,
                                _INT, _INT, _INT, _PTR)},
    "hit_window_bitmap": {"hit_window_bitmap": (
        _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _INT, _INT, _INT, _PTR)},
    "match_counts": {"match_counts": (_PTR, _PTR, _PTR, _I64, _I64, _I64,
                                      _INT, _PTR)},
    # masks, lengths, lengths are int64, planes, suffix planes, counts and
    # offsets scratch and its entries, n_hits, hit_idx, mism, N, L, P,
    # plen, mm, term, max_hits, stream
    "find_hits": {"find_hits": (_PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR,
                                _I64, _PTR, _PTR, _PTR, _I64, _I64, _I64,
                                _INT, _INT, _INT, _I64, _PTR)},
    # masks, lens, planes, ln, shift, trig, fired, T, L, E, W, lp, z, stream
    "dimer_fired": {"dimer_fired": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                    _PTR, _I64, _I64, _I64, _I64, _INT, _I64,
                                    _PTR)},
    # c, la, bmat, lbs, M, lb, pointers, ops, steps, then row scratch,
    # region bytes, threads (the CTA kernel) or columns a lane (the warp
    # kernel), then clocks, stream
    "gotoh_dp": {
        "gotoh_dp": (_PTR, _I64, _PTR, _PTR, _I64, _I64, _PTR, _PTR, _I64,
                     _PTR, _I64, _INT, _PTR, _PTR),
        "gotoh_dp_warp": (_PTR, _I64, _PTR, _PTR, _I64, _I64, _PTR, _PTR,
                          _I64, _INT, _PTR, _PTR)},
    # res_codes, lens, M, lmax, s4, go_c, ge_c, occ2, C, pointers, cols,
    # then row scratch, region bytes, threads (the CTA kernel) or positions
    # a lane (the warp kernel), then clocks, stream
    "refine_dp": {
        "refine_dp": (_PTR, _PTR, _I64, _I64, _PTR, _PTR, _PTR, _PTR, _I64,
                      _PTR, _PTR, _PTR, _I64, _INT, _PTR, _PTR),
        "refine_dp_warp": (_PTR, _PTR, _I64, _I64, _PTR, _PTR, _PTR, _PTR,
                           _I64, _PTR, _PTR, _INT, _PTR, _PTR)},
    # design Stage A: masks, before, packed, N, L (the rows); masks,
    # before, packed, positions, win (or null), freq, nn, cover, gaps, N,
    # L, W, plen, variation (the windows); freq, nn, path, W, plen (the
    # Viterbi paths); then the stream
    "design_stage_a": {
        "stage_a_rows": (_PTR, _PTR, _PTR, _I64, _I64, _PTR),
        "stage_a_windows": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                            _PTR, _I64, _I64, _I64, _INT, _I64, _PTR),
        "stage_a_viterbi": (_PTR, _PTR, _PTR, _I64, _INT, _PTR)},
    # the clusterer's banded identities: codes, meta [4, pairs], pairs,
    # band, shift, key bits, then cells a lane (the register kernel) or
    # the scratch row's stride and the scratch (the wide kernel), then
    # out, stream
    "banded_identity": {
        "banded_identity": (_PTR, _PTR, _I64, _I64, _INT, _INT, _INT, _PTR,
                            _PTR),
        "banded_identity_wide": (_PTR, _PTR, _I64, _I64, _INT, _INT, _I64,
                                 _PTR, _PTR, _PTR)},
}


def load(name):
    """The bound ctypes handle of ``lib<name>.so``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with trace.span("cuda.load"):
                trace.count("lib." + name)
                build([name])
                lib = ctypes.CDLL(_paths(name)[1])
                _bind(lib, _LAUNCHERS[name])
            _libs[name] = lib
        return lib


def check_inputs(fn, dev, tensors):
    """Raise unless each (name, tensor, dtype, ndim) is a contiguous tensor
    of that dtype and rank on ``dev``: what a kernel's pointers assume."""
    for name, t, dtype, ndim in tensors:
        if t.device != dev or t.dtype != dtype or t.dim() != ndim \
                or not t.is_contiguous():
            raise ValueError(
                "%s: %s must be a contiguous %dD %s tensor on %s, got %s %s "
                "on %s" % (fn, name, ndim, dtype, dev, t.dtype,
                           tuple(t.shape), t.device))


def launch(lib, prefix, *args):
    """Call a kernel's C launcher ``<prefix>_launch`` of a library from
    ``load`` (``args`` end with the stream): straight, or while the trace
    records (utils/trace.py), between two CUDA events on that stream, read
    by the innermost open span.  Raise on an error code (a refused launch
    never runs, and no synchronize reports it); count the launch once it
    succeeded."""
    fn = getattr(lib, prefix + "_launch")
    rc = trace.launch(prefix, fn, args) if trace.ON else fn(*args)
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: %s (%d)" % (
            prefix, getattr(lib, prefix + "_error_string")(rc).decode(), rc))
    with _count_lock:
        _LAUNCHED[prefix] = _LAUNCHED.get(prefix, 0) + 1


def launches():
    """{launcher prefix: successful launches in this process so far}, with
    every prefix of ``_LAUNCHERS`` (zeros included): a copy, so a caller
    takes it before and after and subtracts."""
    counts = {prefix: 0 for lib in _LAUNCHERS.values() for prefix in lib}
    with _count_lock:
        counts.update(_LAUNCHED)
    return counts
