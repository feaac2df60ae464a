# Copied from multiprime_tpu/native/__init__.py (host code, no JAX).
"""ctypes loader for the native sequence runtime (seqlib.cpp).

Builds lazily with g++ when the shared object is missing; every entry point
has a NumPy fallback so the package stays functional without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "seqlib.cpp")
_SO = os.path.join(_DIR, "libseqlib.so")

_lib = None
_tried = False
_load_lock = threading.Lock()


def _build():
    # compile to a temp path and rename: dlopen dedups by inode, so a
    # reload after replacing a stale .so must see a NEW inode or it gets
    # the old (symbol-missing) handle back
    tmp = _SO + ".build.%d" % os.getpid()
    # -march=native unlocks the AVX2 paths (the .so is always compiled on
    # the machine that runs it); retry portable if the flag is unsupported.
    # -std=c++17 (strict ISO) keeps -ffp-contract=off: no scalar FMA
    # contraction, so float op-order parity with the NumPy paths holds.
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
            "-ffp-contract=off", _SRC, "-o", tmp]
    for cmd in (base[:1] + ["-march=native"] + base[1:], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
            return True
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return False


def load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _load_lock:
        return _load_locked()


def _warn_unavailable(reason):
    """The NumPy fallbacks are correct but ~10-70x slower on the hot paths
    (design refinement, coverage scan, alignment DP).  Losing the native
    runtime silently would look like a perf regression with no cause, so
    say it once; runs also record it in pipeline_metrics.json backends."""
    import warnings
    warnings.warn(
        "multiprime_tpu_torch native runtime (seqlib) unavailable: %s — "
        "falling back to NumPy/Python paths (roughly 10-70x slower on hot "
        "stages).  A working g++ toolchain fixes this (the library builds "
        "lazily on first use)." % reason, RuntimeWarning, stacklevel=3)


def _load_locked():
    global _lib, _tried
    # re-check under the lock: concurrent first calls (e.g. the progressive
    # aligner's merge threads) must not race two g++ builds onto the same .so
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or \
            os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            _warn_unavailable("g++ build of seqlib.cpp failed")
            return None
    try:
        lib = ctypes.CDLL(_SO)
        _bind(lib)
    except (OSError, AttributeError):
        # AttributeError = a prebuilt .so from an older source missing new
        # exports but with a fresh mtime (cp -p / restored cache).  Force
        # one rebuild and load it under a unique temp path — glibc dedups
        # dlopen by path *string*, so re-opening _SO would hand back the
        # stale handle.  Give up (Python fallbacks) if that still fails.
        if not _build():
            _warn_unavailable("rebuild after stale-.so load failure failed")
            return None
        try:
            import shutil
            import tempfile
            fd, alt = tempfile.mkstemp(suffix=".so")
            os.close(fd)
            shutil.copyfile(_SO, alt)
            lib = ctypes.CDLL(alt)
            _bind(lib)
            os.unlink(alt)     # mapping survives the unlink
        except (OSError, AttributeError):
            _warn_unavailable("rebuilt library failed to load/bind")
            return None
    _lib = lib
    return lib


def _bind(lib):
    lib.banded_identity.restype = ctypes.c_double
    lib.banded_identity.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64]
    lib.banded_identity_batch.restype = None
    lib.banded_identity_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.kmer_codes.restype = ctypes.c_int64
    lib.kmer_codes.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_void_p]
    lib.sorted_intersect_count.restype = ctypes.c_int64
    lib.sorted_intersect_count.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.refine_realign.restype = None
    lib.refine_realign.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int64,
        ctypes.c_void_p]
    lib.profile_align_ops.restype = ctypes.c_int64
    lib.profile_align_ops.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p]
    lib.gotoh_ops_batch.restype = None
    lib.gotoh_ops_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.fasta_scan.restype = ctypes.c_int64
    lib.fasta_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.posting_new.restype = ctypes.c_void_p
    lib.posting_new.argtypes = []
    lib.posting_free.restype = None
    lib.posting_free.argtypes = [ctypes.c_void_p]
    lib.posting_add.restype = None
    lib.posting_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_int32]
    lib.posting_query.restype = ctypes.c_int64
    lib.posting_query.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_int64]
    lib.dimer_screen.restype = ctypes.c_int64
    lib.dimer_screen.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.di_nucleotide_flag.restype = ctypes.c_int64
    lib.di_nucleotide_flag.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.viterbi_path.restype = None
    lib.viterbi_path.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.hairpin_flag.restype = ctypes.c_int64
    lib.hairpin_flag.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p]
    lib.tm_init.restype = None
    lib.tm_init.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                       # dh, ds
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,       # bit table
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,      # init tables
        ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double]
    lib.tm_batch.restype = ctypes.c_int64
    lib.tm_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.refine_init.restype = None
    lib.refine_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.group_rows.restype = ctypes.c_int64
    lib.group_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.freq_nn.restype = None
    lib.freq_nn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.refine_v16_loop.restype = ctypes.c_int64
    lib.refine_v16_loop.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,                        # primer
        ctypes.c_void_p,                                        # nn
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,       # keys/counts
        ctypes.c_int64, ctypes.c_int64,                         # cov, total
        ctypes.c_int64, ctypes.c_int64,                         # limits
        ctypes.c_void_p, ctypes.c_void_p]                       # idx, out
    lib.mask_scan.restype = ctypes.c_int64
    lib.mask_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,        # targets
        ctypes.c_void_p,                                        # lens
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,        # masks
        ctypes.c_int64, ctypes.c_int64,                         # mm, term
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]        # out/cap/nt
    lib.refine_v20_loop.restype = ctypes.c_int64
    lib.refine_v20_loop.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,                        # primer
        ctypes.c_void_p,                                        # nn
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,       # keys/counts
        ctypes.c_int64, ctypes.c_int64,                         # cov, total
        ctypes.c_int64, ctypes.c_int64,                         # limits
        ctypes.c_void_p,                                        # nn_index
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # covered/strict
        ctypes.c_int64,                                         # variation
        ctypes.c_void_p]                                        # out_cov
    lib.seed_scan.restype = ctypes.c_int64
    lib.seed_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,        # targets
        ctypes.c_void_p,                                        # lens
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,        # masks
        ctypes.c_int64, ctypes.c_int64,                         # mm, term
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,        # out/cap/nt
        ctypes.c_int64]                                         # exp_cap
    lib.dimer_hit_ends.restype = ctypes.c_int64
    lib.dimer_hit_ends.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                        # primer
        ctypes.c_void_p, ctypes.c_int64,                        # trig, l1
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,       # trig buf
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]       # dg buf
    lib.dimer_hit_ends2.restype = ctypes.c_int64
    lib.dimer_hit_ends2.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                        # primer
        ctypes.c_void_p, ctypes.c_int64,                        # trig, l1
        ctypes.c_void_p, ctypes.c_void_p,                       # step/init
        ctypes.c_double, ctypes.c_double,                       # ta, sym
        ctypes.c_void_p,                                        # salt
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]       # out buf
    lib.pure_pair_bands.restype = ctypes.c_int64
    lib.pure_pair_bands.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                       # F/R mats
        ctypes.c_int64, ctypes.c_int64,                         # C, L
        ctypes.c_void_p, ctypes.c_void_p,                       # pos, tm
        ctypes.c_void_p, ctypes.c_void_p,                       # fok, rok
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double,        # band, dTm
        ctypes.c_void_p, ctypes.c_int64,                        # trig, l1
        ctypes.c_void_p, ctypes.c_void_p,                       # step/init
        ctypes.c_double, ctypes.c_double,                       # ta, sym
        ctypes.c_void_p,                                        # salt
        ctypes.c_int64, ctypes.c_int64,                         # si0, si1
        ctypes.c_void_p, ctypes.c_int64,                        # out, cap
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]       # avg buf
    lib.pure_gate_batch.restype = ctypes.c_int64
    lib.pure_gate_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,        # rows
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,         # d, num rng
        ctypes.c_void_p, ctypes.c_int64,                        # counts,want
        ctypes.c_void_p, ctypes.c_void_p]                       # flags, gc
    lib.pure_window_filters.restype = ctypes.c_int64
    lib.pure_window_filters.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,        # rows
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,         # d, num rng
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # flags/tm/gc
        ctypes.c_void_p,                                        # counts
        ctypes.c_void_p, ctypes.c_int64,                        # ends buf
        ctypes.c_void_p, ctypes.c_int64]                        # cand out
    lib.pure_window_filters2.restype = ctypes.c_int64
    lib.pure_window_filters2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,        # rows
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,         # d, num rng
        ctypes.c_void_p, ctypes.c_int64,                        # trig, l1
        ctypes.c_void_p, ctypes.c_void_p,                       # step/init
        ctypes.c_double, ctypes.c_double,                       # ta, sym
        ctypes.c_void_p,                                        # salt
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]      # f/tm/gc


def available():
    return load() is not None


def default_threads():
    """Thread budget for the threaded native kernels.  The pipeline's
    per-cluster fork pool (pipeline/driver._per_cluster_stages) divides the
    machine between workers via MPTPU_NATIVE_THREADS so W workers x T
    threads never oversubscribes the host."""
    env = os.environ.get("MPTPU_NATIVE_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return min(os.cpu_count() or 1, 16)


def banded_identity(a_codes: np.ndarray, b_codes: np.ndarray, band=64):
    lib = load()
    if lib is None:
        from ..cluster.greedy import banded_identity as py_impl
        return py_impl(a_codes, b_codes, band)
    a = np.ascontiguousarray(a_codes, np.int8)
    b = np.ascontiguousarray(b_codes, np.int8)
    return lib.banded_identity(a.ctypes.data, len(a), b.ctypes.data, len(b),
                               band)


def kmer_codes(codes: np.ndarray, k=8):
    lib = load()
    if lib is None:
        from ..cluster.greedy import kmer_set
        return kmer_set(codes, k)
    c = np.ascontiguousarray(codes, np.int8)
    out = np.empty(max(len(c), 1), np.int64)
    n = lib.kmer_codes(c.ctypes.data, len(c), k, out.ctypes.data)
    return out[:n]


def intersect_count(a: np.ndarray, b: np.ndarray) -> int:
    lib = load()
    if lib is None:
        return int(np.intersect1d(a, b, assume_unique=True).size)
    return int(lib.sorted_intersect_count(
        np.ascontiguousarray(a, np.int64).ctypes.data, len(a),
        np.ascontiguousarray(b, np.int64).ctypes.data, len(b)))


def refine_realign(rows_bytes, codes, counts, gap_open, gap_ext, nthreads=0):
    """Native profile realignment (align/refine.py semantics).  Returns the
    new [M, C] row buffer as bytes, or None when the library is missing."""
    lib = load()
    if lib is None:
        return None
    m, c = codes.shape
    codes = np.ascontiguousarray(codes, np.int8)
    counts = np.ascontiguousarray(counts, np.int32)
    out = ctypes.create_string_buffer(m * c)
    if nthreads <= 0:
        nthreads = default_threads()
    lib.refine_realign(rows_bytes, codes.ctypes.data, m, c,
                       counts.ctypes.data, gap_open, gap_ext, nthreads, out)
    return out.raw


def profile_align_ops(score: np.ndarray, gap_open: float, gap_ext: float):
    """Native profile-profile Gotoh DP (align/progressive.py).  score is the
    precomputed [la, lb] float32 substitution matrix; returns the uint8 op
    array (0=M, 1=D, 2=I) or None when the library is missing.  Releases
    the GIL, so independent merges thread."""
    lib = load()
    if lib is None:
        return None
    la, lb = score.shape
    score = np.ascontiguousarray(score, np.float32)
    ops = np.empty(la + lb, np.uint8)
    n = lib.profile_align_ops(score.ctypes.data, la, lb,
                              ctypes.c_float(gap_open),
                              ctypes.c_float(gap_ext), ops.ctypes.data)
    return ops[:n]


def gotoh_ops_batch(c_codes, member_codes, nthreads=0):
    """Native center-vs-members affine Gotoh, threaded over members
    (align/centerstar.align_ops_batch semantics, op-for-op identical).
    Returns the forward op-code matrix [M, la+lb_max] uint8 (0=M, 1=D,
    2=I, 3=pad at the end), or None when the library is missing."""
    lib = load()
    if lib is None or not member_codes:
        return None
    c = np.ascontiguousarray(c_codes, np.int8)
    m = len(member_codes)
    offs = np.zeros(m + 1, np.int64)
    for i, b in enumerate(member_codes):
        offs[i + 1] = offs[i] + len(b)
    # +8 slack: the AVX2 row pass reads whole 8-byte groups past the last
    # member's end (garbage lanes, never used)
    buf = np.empty(max(int(offs[-1]), 1) + 8, np.int8)
    for i, b in enumerate(member_codes):
        buf[offs[i]:offs[i + 1]] = b
    lb_max = int((offs[1:] - offs[:-1]).max())
    stride = max(len(c) + lb_max, 1)
    out = np.empty((m, stride), np.uint8)
    if nthreads <= 0:
        nthreads = default_threads()
    lib.gotoh_ops_batch(c.ctypes.data, len(c), buf.ctypes.data,
                        offs.ctypes.data, m, out.ctypes.data, stride,
                        nthreads)
    return out


class PostingIndex:
    """Inverted k-mer -> cluster-id index (native-backed when available).

    The greedy clusterer's word filter: add() indexes a new representative's
    sorted-unique k-mer codes; query() returns ascending candidate cluster
    ids sharing at least min_count k-mers with the query."""

    def __init__(self):
        self._lib = load()
        if self._lib is not None:
            self._h = self._lib.posting_new()
        else:
            self._posting = {}
        self._out = np.empty(1024, np.int32)

    def add(self, kmers: np.ndarray, cluster: int):
        if self._lib is not None:
            km = np.ascontiguousarray(kmers, np.int64)
            self._lib.posting_add(self._h, km.ctypes.data, len(km),
                                  int(cluster))
        else:
            for km in kmers.tolist():
                self._posting.setdefault(km, []).append(cluster)

    def query(self, kmers: np.ndarray, min_count: float):
        if self._lib is not None:
            km = np.ascontiguousarray(kmers, np.int64)
            while True:
                n = self._lib.posting_query(
                    self._h, km.ctypes.data, len(km), float(min_count),
                    self._out.ctypes.data, len(self._out))
                if n < len(self._out):
                    return self._out[:n].tolist()
                self._out = np.empty(len(self._out) * 4, np.int32)
        shared = {}
        for km in kmers.tolist():
            for ci in self._posting.get(km, ()):
                shared[ci] = shared.get(ci, 0) + 1
        return sorted(c for c, s in shared.items() if s >= min_count)

    def __del__(self):
        if getattr(self, "_lib", None) is not None \
                and getattr(self, "_h", None):
            try:
                self._lib.posting_free(self._h)
            except Exception:
                pass


def read_fasta_packed(path):
    """-> (ids, list of int8 code arrays) via the native scanner."""
    lib = load()
    data = open(path, "rb").read()
    if lib is None:
        ids, seqs = [], []
        from ..cluster.greedy import _encode
        name, cur = None, []
        for line in data.decode().splitlines():
            if line.startswith(">"):
                if name is not None:
                    seqs.append(_encode("".join(cur)))
                name = line[1:].split(" ")[0]
                ids.append(name)
                cur = []
            else:
                cur.append(line.strip())
        if name is not None:
            seqs.append(_encode("".join(cur)))
        return ids, seqs
    max_rec = max(16, data.count(b">") + 1)
    out = np.empty(len(data), np.int8)
    starts = np.empty(max_rec, np.int64)
    ends = np.empty(max_rec, np.int64)
    hs = np.empty(max_rec, np.int64)
    he = np.empty(max_rec, np.int64)
    n = lib.fasta_scan(data, len(data), out.ctypes.data, starts.ctypes.data,
                       ends.ctypes.data, hs.ctypes.data, he.ctypes.data,
                       max_rec)
    ids = [data[hs[i]:he[i]].split(b" ")[0].decode() for i in range(n)]
    seqs = [out[starts[i]:ends[i]].copy() for i in range(n)]
    return ids, seqs


def viterbi_path(freq, nn):
    """Consensus Viterbi over int64 freq [4, L] / nn [L-1, 4, 4] tensors
    (multiPrime-core.py:579-593 semantics, ties to the lowest base index).
    Returns the int64 path [L], or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    f = np.ascontiguousarray(freq, dtype=np.int64)
    t = np.ascontiguousarray(nn, dtype=np.int64)
    length = f.shape[1]
    out = np.empty(length, np.int64)
    lib.viterbi_path(f.ctypes.data, t.ctypes.data, length, out.ctypes.data)
    return out


def di_nucleotide_flag(primer: str):
    """Native di/tri-nucleotide run filter (multiPrime-core.py:196-207).
    Returns True/False, or None when the caller must use the Python walk
    (library unavailable, non-IUPAC char, length > 63)."""
    lib = load()
    if lib is None:
        return None
    r = lib.di_nucleotide_flag(primer.encode("ascii"), len(primer))
    return None if r < 0 else bool(r)


def hairpin_flag(primer: str, distance: int, first_members=None):
    """Native hairpin scan (multiPrime-core.py:387-398 strong form;
    get_multiPrime.py:360-386 weak form when `first_members` — the first
    member base of each position's code, computed by the caller so the
    member-order contract stays in Python — is given).  None => fallback."""
    lib = load()
    if lib is None:
        return None
    fm = first_members.encode("ascii") if first_members is not None else None
    r = lib.hairpin_flag(primer.encode("ascii"), len(primer), distance, fm)
    return None if r < 0 else bool(r)


_DIMER_BUFS = threading.local()
_GROUP_BUFS = threading.local()
_PWF_BUFS = threading.local()


def dimer_screen(primer: str, num=5, length=14):
    """Candidate (end, d2) pairs for the design engine's self-dimer check
    (the string-search phase of multiPrime-core.py:487-503), in the exact
    Python evaluation order.  Returns None when the native library is
    unavailable or declines (gaps, expansion blowup) — caller falls back."""
    lib = load()
    if lib is None:
        return None
    plen = len(primer)
    max_out = 4096
    # reused per thread: allocating 256 KB + 96 KB per primer dominated the
    # call cost (the C side only ever writes the first n entries)
    bufs = getattr(_DIMER_BUFS, "v", None)
    if bufs is None:
        bufs = (ctypes.create_string_buffer(max_out * 64),
                np.empty(3 * max_out, np.int64))
        _DIMER_BUFS.v = bufs
    ends_buf, out = bufs
    n = lib.dimer_screen(primer.encode("ascii"), plen, num, num + length - 1,
                         ends_buf, len(ends_buf), out.ctypes.data, max_out)
    if n < 0:
        return None
    raw = ends_buf.raw
    return [(raw[out[3 * i]:out[3 * i] + out[3 * i + 1]].decode("ascii"),
             int(out[3 * i + 2])) for i in range(n)]


def pure_gate_batch(rows_mat, distance, gc_min_counts=None, num=4,
                    length=13, want=7):
    """Batched pairing gates for a [W, plen] uint8 matrix of PURE-ACGT
    rows: per row -> (flags bit0 di / bit1 hairpin / bit2 gc_clamp,
    GC count).  gc_min_counts[k] = minimal tail GC count with
    round(g/k, 3) > 0.6 (None skips the gc_clamp bit).  `want` selects
    which gates to compute (1 di | 2 hairpin | 4 gc_clamp) — di costs 40
    pattern scans per row, so callers skip what they don't read.
    Returns (flags, gc) COPIES (safe to retain) or None (fallback)."""
    lib = load()
    if lib is None:
        return None
    w, plen = rows_mat.shape
    if w == 0:
        return np.empty(0, np.int8), np.empty(0, np.int64)
    blob = np.ascontiguousarray(rows_mat, np.uint8)
    flags = np.empty(w, np.int8)
    gc = np.empty(w, np.int64)
    num_max = num + length - 1
    if gc_min_counts is not None:
        mc = np.ascontiguousarray(gc_min_counts, np.int64)
        if len(mc) < num_max + 1:
            raise ValueError("gc_min_counts too short")
        mc_ptr = mc.ctypes.data
    else:
        mc_ptr = None
    r = lib.pure_gate_batch(blob.ctypes.data, w, plen, distance, num,
                            num_max, mc_ptr, want, flags.ctypes.data,
                            gc.ctypes.data)
    if r < 0:
        return None
    return flags, gc


def pure_window_filters2(win_block, distance, loss_trig, dg_tabs,
                         num=5, length=14):
    """pure_window_filters with the self-dimer verdict resolved natively:
    per row -> flags (bit0 di, bit1 hairpin, bit3 dimer-reject), exact
    Calc_Tm_v2, GC count.  loss_trig is the Python-precomputed uint8
    (len, gc, d2) Loss>=3 table (exact float parity stays in Python);
    dg_tabs = models/pairing._dg_tables().  Returns (flags, tm, gc) or
    None (fallback)."""
    lib = load()
    if lib is None:
        return None
    w, plen = win_block.shape
    if w == 0:
        return (np.empty(0, np.int8), np.empty(0, np.float64),
                np.empty(0, np.int64))
    _tm_ready(lib)
    blob = np.ascontiguousarray(win_block, np.uint8)
    t = np.ascontiguousarray(loss_trig, np.uint8)
    step, init_t, term_ta, symm, salt = dg_tabs
    flags = np.empty(w, np.int8)
    tm = np.empty(w, np.float64)
    gc = np.empty(w, np.int64)
    r = lib.pure_window_filters2(
        blob.ctypes.data, w, plen, distance, num, num + length - 1,
        t.ctypes.data, t.shape[0],
        step.ctypes.data, init_t.ctypes.data,
        float(term_ta), float(symm), salt.ctypes.data,
        flags.ctypes.data, tm.ctypes.data, gc.ctypes.data)
    if r < 0:
        return None
    return flags, tm, gc


def pure_window_filters(win_block, distance, num=5, length=14):
    """Batched filters for a [W, plen] uint8 block of PURE-ACGT windows
    (the design engine's uniform-pure fast path): per row -> (flags
    bit0 di / bit1 hairpin, exact Calc_Tm_v2, GC count, dimer_screen
    candidate tuple).  One ctypes call instead of four per window.
    Returns (flags, tm, gc, cand_lists) or None (fallback)."""
    lib = load()
    if lib is None:
        return None
    w, plen = win_block.shape
    if w == 0:
        return (np.empty(0, np.int8), np.empty(0, np.float64),
                np.empty(0, np.int64), [])
    _tm_ready(lib)
    blob = np.ascontiguousarray(win_block, np.uint8)
    max_out = 4096 * 8
    bufs = getattr(_PWF_BUFS, "v", None)
    if bufs is None or bufs[0] < w:
        cap = max(w, 512)
        bufs = (cap, np.empty(cap, np.int8), np.empty(cap, np.float64),
                np.empty(cap, np.int64), np.empty(cap, np.int64),
                ctypes.create_string_buffer(max_out * 64),
                np.empty(3 * max_out, np.int64))
        _PWF_BUFS.v = bufs
    _, flags, tm, gc, counts, ends_buf, out = bufs
    n = lib.pure_window_filters(
        blob.ctypes.data, w, plen, distance, num, num + length - 1,
        flags.ctypes.data, tm.ctypes.data, gc.ctypes.data,
        counts.ctypes.data, ends_buf, len(ends_buf),
        out.ctypes.data, max_out)
    if n < 0:
        return None
    # candidate rows are sparse (most pure windows screen clean): decode
    # only rows with counts; everything else shares one empty tuple
    cands = [()] * w
    if n > 0:
        raw = ends_buf.raw
        k = 0
        for r in np.nonzero(counts[:w])[0].tolist():
            c = int(counts[r])
            cands[r] = tuple(
                (raw[out[3 * i]:out[3 * i] + out[3 * i + 1]]
                 .decode("ascii"), int(out[3 * i + 2]))
                for i in range(k, k + c))
            k += c
    # NOTE: flags/tm/gc alias per-thread buffers overwritten by the next
    # call on this thread — consume before calling again
    return flags, tm, gc, cands


_TM_READY = False
_REFINE_READY = False


def _tm_ready(lib):
    """Push the Python thermo tables into the C side once (passing them in,
    rather than re-declaring them in C, means the two sides cannot drift)."""
    global _TM_READY
    if _TM_READY:
        return True
    from ..thermo import exact, tables as tb
    dh = np.ascontiguousarray(tb.DH_L, np.float64)
    ds = np.ascontiguousarray(tb.DS_L, np.float64)
    bit_chars = "".join(tb.BASE_INDEX)
    bit_vals = np.asarray(list(tb.BASE_INDEX.values()), np.int64)
    init_chars = "".join(tb.DH_INIT)
    dh_init = np.asarray([tb.DH_INIT[c] for c in init_chars], np.float64)
    ds_init = np.asarray([tb.DS_INIT[c] for c in init_chars], np.float64)
    lib.tm_init(dh.ctypes.data, ds.ctypes.data,
                bit_chars.encode(), bit_vals.ctypes.data, len(bit_chars),
                init_chars.encode(), dh_init.ctypes.data,
                ds_init.ctypes.data, len(init_chars),
                ctypes.c_double(tb.DS_SYMMETRY),
                ctypes.c_double(exact._MG_CORRECTION),
                ctypes.c_double(tb.PRIMER_CONC_NG_UL),
                ctypes.c_double(tb.KELVIN))
    _TM_READY = True
    return True


def tm_batch(expansions):
    """Exact Calc_Tm_v2 for a tuple of same-length pure-base expansions.
    Returns a float list (each rounded to 2 like the Python tm()), or None
    when the caller must fall back (library unavailable, odd alphabet)."""
    lib = load()
    if lib is None or not expansions:
        return None
    length = len(expansions[0])
    try:
        blob = "".join(expansions).encode("ascii")
    except UnicodeEncodeError:  # pragma: no cover
        return None
    if len(blob) != length * len(expansions):
        return None               # ragged (cannot happen for iupac.expand)
    _tm_ready(lib)
    out = np.empty(len(expansions), np.float64)
    r = lib.tm_batch(blob, len(expansions), length, out.ctypes.data)
    if r < 0:
        return None
    return out.tolist()


def _refine_ready(lib):
    global _REFINE_READY
    if _REFINE_READY:
        return True
    from ..models import mcdpd
    from ..utils import iupac
    table = np.zeros((256, 4), np.uint8)
    for key, order in mcdpd._ARGSORT4_DESC.items():
        idx = ((key[0] * 4 + key[1]) * 4 + key[2]) * 4 + key[3]
        table[idx] = order
    c2m = np.zeros(256, np.uint8)
    for ch, m in iupac.CHAR_TO_MASK.items():
        c2m[ord(ch)] = m
    m2c = np.zeros(16, np.uint8)
    for m, ch in iupac.MASK_TO_CHAR.items():
        m2c[m] = ord(ch)
    lib.refine_init(table.ctypes.data, c2m.ctypes.data, m2c.ctypes.data)
    _REFINE_READY = True
    return True


def refine_v16(consensus: str, nn, keys, counts, coverage_init, cover_number,
               degeneracy_limit, dege_limit):
    """Native v15/v16 greedy NN refinement loop (core_V15.py:964-986 +
    refine_by_NN_array).  `nn` is the [plen-1, 4, 4] int64 tensor (copied
    here; the C side mutates its copy), `keys`/`counts` the cover dict in
    insertion order.  Returns (refined_primer, coverage) or None when the
    caller must run the Python loop."""
    lib = load()
    if lib is None:
        return None
    plen = len(consensus)
    _refine_ready(lib)
    prm = ctypes.create_string_buffer(consensus.encode("ascii"), plen)
    nn_arr = np.ascontiguousarray(nn, np.int64).copy()
    blob = "".join(keys).encode("ascii")
    if len(blob) != plen * len(keys):
        return None
    cnt = np.ascontiguousarray(counts, np.int64)
    # nn_index from the consensus path chars (BASES order A,C,G,T)
    base_idx = {"A": 0, "C": 1, "G": 2, "T": 3}
    try:
        path = [base_idx[c] for c in consensus]
    except KeyError:              # pragma: no cover - consensus is pure
        return None
    idx = np.empty((plen - 1, 2), np.uint8)
    for i in range(plen - 1):
        idx[i, 0] = path[i]
        idx[i, 1] = path[i + 1]
    out_cov = np.empty(1, np.int64)
    r = lib.refine_v16_loop(
        ctypes.addressof(prm), plen, nn_arr.ctypes.data, blob,
        cnt.ctypes.data, len(keys), int(coverage_init), int(cover_number),
        int(degeneracy_limit), int(dege_limit), idx.ctypes.data,
        out_cov.ctypes.data)
    if r < 0:
        return None
    return prm.raw[:plen].decode("ascii"), int(out_cov[0])


def group_rows(win: np.ndarray):
    """Group identical rows of a contiguous uint8 [N, plen] window block,
    first-occurrence order, ascending member indices — the insertion
    semantics of the Python dict loop in mcdpd._design_window.  Returns
    (R, order[R], members[N], offsets[R+1]) or None (fallback).

    ALIASING: the returned arrays are shared per-thread buffers that the
    NEXT group_rows call on the same thread overwrites — consume them
    before calling again (copy if they must outlive the call)."""
    lib = load()
    if lib is None:
        return None
    n, plen = win.shape
    # per-thread output buffers with cached raw pointers: the .ctypes.data
    # property builds a ctypes view per access, which dominated this
    # binding's cost at ~30 us/call over thousands of windows
    bufs = getattr(_GROUP_BUFS, "v", None)
    if bufs is None or bufs[0] < n:
        order = np.empty(n, np.int32)
        members = np.empty(n, np.int32)
        offsets = np.empty(n + 1, np.int32)
        bufs = (n, order, members, offsets, order.ctypes.data,
                members.ctypes.data, offsets.ctypes.data)
        _GROUP_BUFS.v = bufs
    _, order, members, offsets, p_order, p_members, p_offsets = bufs
    r = lib.group_rows(win.ctypes.data, n, plen, p_order, p_members,
                       p_offsets)
    return int(r), order, members, offsets


def freq_nn(key_chars: np.ndarray, counts: np.ndarray):
    """Exact int64 frequency [4, plen] and NN [plen-1, 4, 4] tensors over
    the distinct cover keys, identical to mcdpd._design_window's einsum
    formulation (non-ACGT bytes contribute nothing).  None -> fallback."""
    lib = load()
    if lib is None:
        return None
    k, plen = key_chars.shape
    kc = np.ascontiguousarray(key_chars, np.uint8)
    cnt = np.ascontiguousarray(counts, np.int64)
    freq = np.empty((4, plen), np.int64)
    nn = np.empty((plen - 1, 4, 4), np.int64)
    lib.freq_nn(kc.ctypes.data, k, plen, cnt.ctypes.data,
                freq.ctypes.data, nn.ctypes.data)
    return freq, nn


def mask_scan(target_codes: np.ndarray, lens: np.ndarray,
              masks: np.ndarray, mm: int, term: int, nthreads=0):
    """Native early-exit mismatch scan over 4-bit base codes.

    target_codes: uint8 [N, L] strict codes (A=1, C=2, G=4, T=8, else 0);
    masks: uint8 [P, plen] per-position IUPAC member masks.  Returns hits
    int32 [K, 4] of (row, pos, primer, mismatches) in ascending
    (row, pos, primer) order — find_hits_numpy's np.nonzero contract — or
    None when the library is missing."""
    lib = load()
    if lib is None:
        return None
    t = np.ascontiguousarray(target_codes, np.uint8)
    m = np.ascontiguousarray(masks, np.uint8)
    ln = np.ascontiguousarray(lens, np.int64)
    n, stride = t.shape
    p, plen = m.shape
    if nthreads <= 0:
        nthreads = default_threads()
    cap = max(1 << 16, 4 * n)
    while True:
        out = np.empty((cap, 4), np.int32)
        total = lib.mask_scan(t.ctypes.data, n, stride, ln.ctypes.data,
                              m.ctypes.data, p, plen, mm, term,
                              out.ctypes.data, cap, nthreads)
        if total <= cap:
            return out[:total]
        cap = int(total)


_DIMER_BUFS = threading.local()


def dimer_hit_ends(primer: str, trig_table: np.ndarray):
    """Native enumeration for pairing's factored cross-dimer hit sets.

    trig_table: uint8 [l1, l1, l1] of the (len, gc, d2) loss-gate verdicts.
    Returns (loss_triggered_rc_ends, d2zero_candidates) as lists of strings,
    or None (fallback) on unknown codes / expansion blowup / overflow.  The
    caller unions the triggered set with the dG-passing candidates."""
    lib = load()
    if lib is None:
        return None
    l1 = trig_table.shape[0]
    t = np.ascontiguousarray(trig_table, np.uint8)
    cap = 1 << 16
    bufs = _DIMER_BUFS.__dict__
    if "t" not in bufs:
        bufs["t"] = ctypes.create_string_buffer(cap)
        bufs["d"] = ctypes.create_string_buffer(cap)
    tbuf, dbuf = bufs["t"], bufs["d"]
    tlen = ctypes.c_int64(0)
    dlen = ctypes.c_int64(0)
    r = lib.dimer_hit_ends(primer.encode("ascii"), len(primer),
                           t.ctypes.data, l1, tbuf, cap,
                           ctypes.byref(tlen), dbuf, cap,
                           ctypes.byref(dlen))
    if r < 0:
        return None
    trig = tbuf.raw[:tlen.value].decode("ascii").split()
    dg = dbuf.raw[:dlen.value].decode("ascii").split()
    return trig, dg


def dimer_hit_ends2(primer: str, trig_table: np.ndarray, dg_tabs):
    """dimer_hit_ends with the d2==0 dG verdict resolved natively — one
    output stream, no Python delta_g tail.  dg_tabs = (step[16], init[4],
    terminal_ta, symmetry, salt[64]) float64 arrays precomputed in Python
    (models/pairing._dg_tables) so every double the kernel adds is the
    exact value the Python path adds.  Returns a frozenset of hit ends, or
    None (fallback)."""
    lib = load()
    if lib is None:
        return None
    l1 = trig_table.shape[0]
    t = np.ascontiguousarray(trig_table, np.uint8)
    step, init_t, term_ta, symm, salt = dg_tabs
    cap = 1 << 16
    bufs = _DIMER_BUFS.__dict__
    if "t2" not in bufs:
        bufs["t2"] = ctypes.create_string_buffer(cap)
    tbuf = bufs["t2"]
    tlen = ctypes.c_int64(0)
    r = lib.dimer_hit_ends2(primer.encode("ascii"), len(primer),
                            t.ctypes.data, l1,
                            step.ctypes.data, init_t.ctypes.data,
                            float(term_ta), float(symm), salt.ctypes.data,
                            tbuf, cap, ctypes.byref(tlen))
    if r < 0:
        return None
    return frozenset(tbuf.raw[:tlen.value].decode("ascii").split())


def pure_pair_bands(fmat, rmat, pos, tm, fok, rok, min_len, max_len,
                    diff_tm, trig_table, dg_tabs, si0, si1):
    """Native banded pair enumeration for pure no-uncovered-ids clusters
    (models/pairing): returns (int32 [n, 2] (i, j) survivor indices in the
    Python loop's exact emission order, list of n avg-Tm strings — Python
    str(round(mean, 2)) bytes), or None (fallback)."""
    lib = load()
    if lib is None:
        return None
    C, L = fmat.shape
    l1 = trig_table.shape[0]
    t = np.ascontiguousarray(trig_table, np.uint8)
    step, init_t, term_ta, symm, salt = dg_tabs
    cap = max(1 << 16, C * 128)
    while True:
        out = np.empty((cap, 2), np.int32)
        avg_cap = cap * 34
        avg_buf = ctypes.create_string_buffer(avg_cap)
        avg_len = ctypes.c_int64(0)
        n = lib.pure_pair_bands(
            fmat.ctypes.data, rmat.ctypes.data, C, L,
            pos.ctypes.data, tm.ctypes.data,
            fok.ctypes.data, rok.ctypes.data,
            int(min_len), int(max_len), float(diff_tm),
            t.ctypes.data, l1,
            step.ctypes.data, init_t.ctypes.data,
            float(term_ta), float(symm), salt.ctypes.data,
            int(si0), int(si1), out.ctypes.data, cap,
            avg_buf, avg_cap, ctypes.byref(avg_len))
        if n >= 0:
            avgs = avg_buf.raw[:avg_len.value].decode("ascii").split("\n")
            return out[:n], avgs[:n]
        # -1 is also the cap-overflow signal: one doubling retry
        # distinguishes "too many pairs" from a real fallback
        if cap >= C * C + 1:
            return None
        cap = min(C * C + 1, cap * 4)


def refine_v20(consensus: str, nn, keys, counts, coverage_init, cover_number,
               degeneracy_limit, dege_limit, covered, f_strict, r_strict,
               variation):
    """Native v20 mis-coverage-driven refinement loop (multiPrime-core.py:
    881-906).  The in-loop mismatch checks feed only order-independent
    count sums; the caller recomputes the final F/R non-cover dicts in
    Python on the returned primer (deterministic, so byte-identical to the
    last in-loop call).  Returns (refined_primer, coverage) or None."""
    lib = load()
    if lib is None:
        return None
    plen = len(consensus)
    _refine_ready(lib)
    prm = ctypes.create_string_buffer(consensus.encode("ascii"), plen)
    nn_arr = np.ascontiguousarray(nn, np.int64).copy()
    blob = "".join(keys).encode("ascii")
    if len(blob) != plen * len(keys):
        return None
    cnt = np.ascontiguousarray(counts, np.int64)
    base_idx = {"A": 0, "C": 1, "G": 2, "T": 3}
    try:
        path = [base_idx[c] for c in consensus]
    except KeyError:              # pragma: no cover - consensus is pure
        return None
    idx = np.empty((plen - 1, 2), np.uint8)
    for i in range(plen - 1):
        idx[i, 0] = path[i]
        idx[i, 1] = path[i + 1]
    cov_tab = np.ascontiguousarray(covered, np.uint8)
    fs = np.ascontiguousarray(f_strict, np.uint8)
    rs = np.ascontiguousarray(r_strict, np.uint8)
    out_cov = np.empty(1, np.int64)
    r = lib.refine_v20_loop(
        ctypes.addressof(prm), plen, nn_arr.ctypes.data, blob,
        cnt.ctypes.data, len(keys), int(coverage_init), int(cover_number),
        int(degeneracy_limit), int(dege_limit), idx.ctypes.data,
        cov_tab.ctypes.data, fs.ctypes.data, rs.ctypes.data,
        int(variation), out_cov.ctypes.data)
    if r < 0:
        return None
    return prm.raw[:plen].decode("ascii"), int(out_cov[0])


def seed_scan(target_codes: np.ndarray, lens: np.ndarray,
              masks: np.ndarray, mm: int, term: int, nthreads=0,
              exp_cap=256):
    """Seed-indexed mismatch scan: pigeonhole over mm+1 pattern chunks,
    exact-chunk hash probes over a rolling 2-bit target code, mask-test
    verification.  Same inputs/outputs/order as mask_scan; wins when the
    pattern count is large (index probes replace the per-pattern walk)."""
    lib = load()
    if lib is None:
        return None
    t = np.ascontiguousarray(target_codes, np.uint8)
    m = np.ascontiguousarray(masks, np.uint8)
    ln = np.ascontiguousarray(lens, np.int64)
    n, stride = t.shape
    p, plen = m.shape
    if nthreads <= 0:
        nthreads = default_threads()
    cap = max(1 << 16, 4 * n)
    while True:
        out = np.empty((cap, 4), np.int32)
        total = lib.seed_scan(t.ctypes.data, n, stride, ln.ctypes.data,
                              m.ctypes.data, p, plen, mm, term,
                              out.ctypes.data, cap, nthreads, exp_cap)
        if total <= cap:
            return out[:total]
        cap = int(total)
