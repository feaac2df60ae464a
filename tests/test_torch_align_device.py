"""The port's device DPs (multiprime_tpu_torch/align/device.py) against the
JAX package's and the host DPs, on the CPU: equal op strings, equal
``as_codes`` matrices, equal MSAs and refined rows.  On the CPU the
wrappers gotoh_block and refine_block run their plain versions; their CUDA
kernels are held to those on the card by tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from multiprime_tpu.align import centerstar as jcs
from multiprime_tpu.align import device as jdev
from multiprime_tpu.align import refine as jrefine
from multiprime_tpu.align.device import align_ops_batch_device as jalign
from multiprime_tpu_torch import native as tnative
from multiprime_tpu_torch.align import centerstar as tcs
from multiprime_tpu_torch.align import device as tdev
from multiprime_tpu_torch.align import refine as trefine

from .test_align_device import _rand_members
from .test_torch_gpu import DP_CASES, dp_case, dp_case_rows


def _random_case():
    """The inputs of tests/test_align_device.py::test_device_ops_match_
    numpy_random: a 180-base center, 40 edited members, a one-base member
    and a member longer than the center."""
    rng = np.random.default_rng(11)
    c = rng.integers(0, 4, size=180).astype(np.int8)
    members = _rand_members(rng, c, 40, 50)
    members.append(rng.integers(0, 4, size=1).astype(np.int8))
    members.append(rng.integers(0, 4, size=400).astype(np.int8))
    return c, members


def _gap_heavy_case():
    """The inputs of tests/test_align_device.py::test_device_ops_gap_heavy:
    long leading and internal deletions, a long insertion."""
    rng = np.random.default_rng(3)
    c = rng.integers(0, 4, size=90).astype(np.int8)
    members = [
        c[30:],
        np.concatenate([c[:40], c[60:]]),
        np.concatenate([c[:50], rng.integers(0, 4, 35).astype(np.int8),
                        c[50:]]),
        np.repeat(c, 2)[:150].astype(np.int8),
    ]
    return c, members


def _other_codes_case():
    """A center with code 4 (never matches), an empty member and the
    native test's shapes."""
    rng = np.random.default_rng(17)
    c = rng.integers(0, 5, size=210).astype(np.int8)
    members = _rand_members(rng, c, 30, 60)
    members += [np.empty(0, np.int8),
                rng.integers(0, 4, size=460).astype(np.int8), c[80:]]
    return c, members


CASES = {"random": (_random_case, 24), "gap_heavy": (_gap_heavy_case, 512),
         "other_codes": (_other_codes_case, 7)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_ops_batch_device_equals_jax_and_numpy(case):
    """Member blocks smaller than M (24 and 7 of 43 and 33 members): op
    strings equal JAX's device DP and the NumPy row loop; as_codes
    matrices equal JAX's, width included."""
    make, block = CASES[case]
    c, members = make()
    want = jcs.align_ops_batch(c, members)
    assert jalign(c, members, member_block=block) == want
    got = tdev.align_ops_batch_device(c, members, member_block=block,
                                      device="cpu")
    assert got == want
    jcodes = jalign(c, members, member_block=block, as_codes=True)
    tcodes = tdev.align_ops_batch_device(c, members, member_block=block,
                                         as_codes=True, device="cpu")
    assert tcodes.dtype == jcodes.dtype and tcodes.shape == jcodes.shape
    assert np.array_equal(tcodes, jcodes)


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_ops_batch_device_equals_native(case):
    """The native C++ Gotoh (the port's auto default) gives the same code
    matrix, up to its own pad width."""
    if not tnative.available():
        pytest.skip("native toolchain unavailable")
    c, members = CASES[case][0]()
    nat = tnative.gotoh_ops_batch(c, members)
    got = tdev.align_ops_batch_device(c, members, as_codes=True,
                                      device="cpu")
    s = min(nat.shape[1], got.shape[1])
    assert np.array_equal(got[:, :s], nat[:, :s])
    assert (got[:, s:] == 3).all() and (nat[:, s:] == 3).all()


def _family(seed, n, length, edits):
    rng = np.random.default_rng(seed)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, size=length))
    seqs = []
    for _ in range(n):
        b = list(base)
        for _ in range(int(rng.integers(*edits))):
            k = int(rng.integers(0, max(len(b), 1)))
            r = rng.integers(0, 3)
            if r == 0:
                b[k % len(b)] = "ACGT"[int(rng.integers(0, 4))]
            elif r == 1 and len(b) > 5:
                del b[k % len(b)]
            else:
                b.insert(k % (len(b) + 1), "ACGT"[int(rng.integers(0, 4))])
        seqs.append("".join(b))
    return [str(i) for i in range(n)], seqs


def test_center_star_msa_device_invariance():
    """The inputs of tests/test_align_device.py::test_center_star_backend_
    invariance: the device backend's MSA equals NumPy's, native's and the
    JAX package's device MSA, and LAST_BACKEND names the DP that served."""
    ids, seqs = _family(5, 9, 150, (0, 25))
    _, want = jcs.center_star_msa(ids, seqs, backend="device")
    for backend in ("device", "numpy", "native"):
        _, rows = tcs.center_star_msa(ids, seqs, backend=backend,
                                      device="cpu")
        assert rows == want, backend
        assert tcs.LAST_BACKEND == backend
    tcs.center_star_msa(ids[:1], seqs[:1], device="cpu")
    assert tcs.LAST_BACKEND == "none"


def test_refine_pass_device_equals_jax():
    """The inputs of tests/test_align_device.py::test_refine_device_
    matches_numpy: the port's device pass equals JAX's device pass, the
    NumPy and the native pass, and moves residues."""
    ids, seqs = _family(13, 14, 160, (5, 30))
    _, rows = jcs.center_star_msa(ids, seqs, backend="numpy")
    want = jrefine.refine_pass(rows, backend="device")
    got = trefine.refine_pass(rows, backend="device", device="cpu")
    assert got == want
    assert got == trefine.refine_pass(rows, backend="numpy")
    assert got == trefine.refine_pass(rows, backend="auto")
    assert got != rows


def test_refine_pass_device_blocks_and_ragged_rows():
    """More members than one block (member_block 256 -> 300 members in two
    blocks), rows of very different residue counts."""
    ids, seqs = _family(29, 300, 90, (0, 40))
    seqs[7] = seqs[7][:20]
    _, rows = tcs.center_star_msa(ids, seqs, backend="native", device="cpu")
    want = jrefine.refine_pass(rows, backend="numpy")
    assert trefine.refine_pass(rows, backend="device", device="cpu") == want


@pytest.mark.parametrize("case", DP_CASES)
def test_tie_heavy_dps_equal_jax(case):
    """The plain versions behind gotoh_block and refine_block, through
    align_ops_batch_device and refine_pass_device, against JAX's device
    programs on the tie-heavy cases of the GPU tests: equal op strings and
    as_codes matrices (and equal to the NumPy row loop), equal refined rows
    (and equal to the NumPy and native passes), member blocks included."""
    c, members, block = dp_case(case)
    want = jcs.align_ops_batch(c, members)
    assert jalign(c, members, member_block=block) == want
    got = tdev.align_ops_batch_device(c, members, member_block=block,
                                      device="cpu")
    assert got == want
    jcodes = jalign(c, members, member_block=block, as_codes=True)
    tcodes = tdev.align_ops_batch_device(c, members, member_block=block,
                                         as_codes=True, device="cpu")
    assert tcodes.shape == jcodes.shape and np.array_equal(tcodes, jcodes)
    rows = dp_case_rows(c, members)
    args = trefine.device_pass_inputs(rows)
    want_rows = jdev.refine_pass_device(*args, go=-4.0, ge=-1.0,
                                        member_block=block)
    got_rows = tdev.refine_pass_device(*args, go=-4.0, ge=-1.0,
                                       member_block=block, device="cpu")
    assert got_rows == want_rows
    want_pass = jrefine.refine_pass(rows, backend="device")
    assert trefine.refine_pass(rows, backend="device", device="cpu") \
        == want_pass == trefine.refine_pass(rows, backend="numpy")
    if case == "empty_member":
        assert (args[2] == 0).sum() == 2      # two all-gap rows


def test_dp_wrappers_launch_or_raise_off_the_cpu(monkeypatch):
    """On a meta tensor (any non-CPU device) gotoh_block and refine_block
    reach _cuda.load, and never the plain version: without a card there is
    no fallback.  gotoh_block chooses its kernel before the load: the warp
    kernel at lb + 1 = 10, the CTA kernel at 1281."""
    from multiprime_tpu_torch.ops import _cuda

    class Sentinel(Exception):
        pass

    loaded, planned = [], []

    def load(name):
        loaded.append(name)
        raise Sentinel(name)

    def plain(*a, **kw):
        raise AssertionError("the plain version ran off the CPU")

    plan = tdev.gotoh_kernel_plan

    def recorded_plan(lb):
        planned.append(plan(lb)[0])
        return plan(lb)

    monkeypatch.setattr(_cuda, "load", load)
    monkeypatch.setattr(tdev, "gotoh_block_reference", plain)
    monkeypatch.setattr(tdev, "refine_block_reference", plain)
    monkeypatch.setattr(tdev, "gotoh_kernel_plan", recorded_plan)
    meta = torch.device("meta")
    # blocks on each side of the warp kernel's limit (lb + 1 = 10, 1281)
    for lb in (9, tdev._GOTOH_WARP_MAX_COLS):
        with pytest.raises(Sentinel):
            tdev.gotoh_block(torch.zeros(7, dtype=torch.int32, device=meta),
                             torch.zeros((3, lb), dtype=torch.int32,
                                         device=meta),
                             torch.zeros(3, dtype=torch.int32, device=meta))
    assert planned == ["gotoh_dp_warp", "gotoh_dp"]
    f = torch.zeros((5, 3), dtype=torch.float32, device=meta)
    with pytest.raises(Sentinel):
        tdev.refine_block(torch.zeros((3, 4), dtype=torch.int64, device=meta),
                          torch.zeros(3, dtype=torch.int64, device=meta),
                          torch.zeros((5, 3, 6), dtype=torch.float32,
                                      device=meta), f, f, f)
    assert loaded == ["gotoh_dp", "gotoh_dp", "refine_dp"]


@pytest.mark.parametrize("lb", [0, 1, 30, 31, 32, 254, 255, 256, 511, 512,
                                767, 1023, 1278, 1279, 1280, 2047, 5000])
def test_gotoh_kernel_plan_by_width(lb):
    """The Gotoh dispatch by the block's width alone: the warp kernel with
    the smallest K of 8, 16, ..., 40 columns a lane such that 32K >= lb + 1
    (and a 32K pitch) up to 1280 columns, the CTA kernel (256 threads,
    pitch lb + 1) past them."""
    if lb + 1 <= 1280:
        k = -(-(lb + 1) // 256) * 8
        assert 32 * k >= lb + 1 and (k == 8 or 32 * (k - 8) < lb + 1)
        assert tdev.gotoh_kernel_plan(lb) == ("gotoh_dp_warp", k, 32 * k)
    else:
        assert tdev.gotoh_kernel_plan(lb) == ("gotoh_dp", 256, lb + 1)


def test_gotoh_kernel_plan_follows_the_limit(monkeypatch):
    """The limit the GPU tests and the smoke check lower to force the CTA
    kernel: at 0 every width takes it, at 256 only blocks of up to 256
    columns keep the warp kernel."""
    monkeypatch.setattr(tdev, "_GOTOH_WARP_MAX_COLS", 0)
    assert tdev.gotoh_kernel_plan(0) == ("gotoh_dp", 256, 1)
    assert tdev.gotoh_kernel_plan(900) == ("gotoh_dp", 256, 901)
    monkeypatch.setattr(tdev, "_GOTOH_WARP_MAX_COLS", 256)
    assert tdev.gotoh_kernel_plan(255) == ("gotoh_dp_warp", 8, 256)
    assert tdev.gotoh_kernel_plan(256) == ("gotoh_dp", 256, 257)


@pytest.mark.parametrize("lmax", [0, 1, 30, 31, 255, 256, 511, 767, 1023,
                                  1278, 1279, 1280, 5000])
def test_refine_kernel_plan_by_width(lmax):
    """The refine dispatch by the block's width alone: the warp kernel with
    the smallest K of 8, 16, ..., 40 positions a lane such that 32K >= lmax
    + 1 (and a 32K pitch) up to 1280 positions, the CTA kernel (256
    threads, pitch lmax + 1) past them and, at every width, for a block
    with a positive gap term; each plan names a launcher of the refine
    library with the size argument in its place."""
    from multiprime_tpu_torch.ops import _cuda
    cta = ("refine_dp", 256, lmax + 1)
    if lmax + 1 <= 1280:
        k = -(-(lmax + 1) // 256) * 8
        assert 32 * k >= lmax + 1 and (k == 8 or 32 * (k - 8) < lmax + 1)
        assert tdev.refine_kernel_plan(lmax) == ("refine_dp_warp", k, 32 * k)
    else:
        assert tdev.refine_kernel_plan(lmax) == cta
    assert tdev.refine_kernel_plan(lmax, positive_gaps=True) == cta
    for plan in (tdev.refine_kernel_plan(lmax), cta):
        argtypes = _cuda._LAUNCHERS["refine_dp"][plan[0]]
        assert argtypes[-3] is _cuda._INT     # threads or positions a lane


def test_refine_kernel_plan_follows_the_limit(monkeypatch):
    """The limit the GPU tests and the smoke check lower to force the CTA
    kernel: at 0 every width takes it, at 256 only blocks of up to 256
    positions keep the warp kernel."""
    monkeypatch.setattr(tdev, "_REFINE_WARP_MAX_POS", 0)
    assert tdev.refine_kernel_plan(0) == ("refine_dp", 256, 1)
    assert tdev.refine_kernel_plan(924) == ("refine_dp", 256, 925)
    monkeypatch.setattr(tdev, "_REFINE_WARP_MAX_POS", 256)
    assert tdev.refine_kernel_plan(255) == ("refine_dp_warp", 8, 256)
    assert tdev.refine_kernel_plan(256) == ("refine_dp", 256, 257)


def _trace_walk(ptr, lens, best_j):
    """refine_trace_reference's walk, one member at a time in NumPy ->
    (placed columns [M, C], per member the (column, position) each step
    read and the (i, j) it started from)."""
    c, m, _ = ptr.shape
    cols = np.full((m, c), -1, np.int64)
    reads = []
    for k in range(m):
        i, j, skip, steps = int(lens[k]), int(best_j[k]), False, []
        for s in range(c):
            if i == 0:
                break
            col = max(j, 1) - 1
            p = int(ptr[col, k, i])
            steps.append((i, j, col, i))
            take = j > i and (skip or p & 1 == 1)
            if not take:
                cols[k, s] = j - 1
                i -= 1
            skip = take and p & 2 == 2
            j -= 1
        reads.append(steps)
    return cols, reads


def _window(f):
    """The trace tile row of csrc/refine_dp.cu's warp kernel that ends at
    slot f: from the 16-byte word holding slot max(f - 63, 0), the words
    that start at or below f (five at most) -> (first slot, bytes)."""
    base = max(f - 63, 0) & ~15
    return base, 16 * sum(base + 16 * w <= f for w in range(5))


def _seeded_trace_inputs(seed, c, lmax, m):
    """Random pointer bytes [C, M, lmax + 1], lengths with 0, 1, 31, 32, 33
    and lmax among them, and end columns with 0, 1 and some below the
    length (j <= i, where the trace places into column -1 and below)."""
    rng = np.random.default_rng(seed)
    ptr = rng.integers(0, 4, size=(c, m, lmax + 1)).astype(np.uint8)
    lens = rng.integers(0, lmax + 1, size=m)
    lens[:6] = np.minimum([0, 1, 31, 32, 33, lmax], lmax)
    best_j = rng.integers(0, c + 1, size=m)
    best_j[:4] = [0, 1, min(c, 1), c]
    best_j[6:9] = np.clip(lens[6:9] - rng.integers(0, 40, 3), 0, c)
    return ptr, lens.astype(np.int64), best_j.astype(np.int64)


def _tie_grid_trace_inputs(case):
    """The column DP's pointer bytes and end columns of a tie-grid case's
    first refine block (the plain version, on the CPU)."""
    c, members, block = dp_case(case)
    rows = dp_case_rows(c, members)
    res_chars, res_codes, lens, f6, occ, _ = trefine.device_pass_inputs(rows)
    blk = tdev.refine_block_inputs(res_codes, lens, f6, occ,
                                   slice(0, block), device="cpu")
    ptr, best_j = tdev.refine_columns_reference(*blk, torch.device("cpu"))
    return ptr.numpy(), blk[1].numpy(), best_j.numpy()


TRACE_CASES = [("tie", case) for case in DP_CASES] + [
    ("seeded", (seed, c, lmax)) for seed, c, lmax in
    ((1, 1, 40), (2, 7, 40), (3, 45, 30), (4, 100, 90), (5, 300, 260))]


@pytest.mark.parametrize("kind,case", TRACE_CASES)
def test_refine_trace_tile_holds_every_read(kind, case):
    """The warp kernel's trace tiles: on the tie grid's refine blocks and on
    seeded pointer tensors (j <= 1 and i < 32 included), every pointer
    byte that refine_block_reference's trace reads lies in the tile the
    kernel walks it from.  Slot f = i + off holds position i (off = K - 1
    - len % K); a tile covers 32 steps from (f_n, j_n), and lane q's row
    holds column max(j - q, 1) - 1 (j = j_0 for the first tile, the tile
    before's j - 32 after it) over the window that ends at the slot the
    tile before started from (f_0 for the first), loaded while that tile
    was walked; the read must be lane q's column, inside its 80-byte row
    and inside the member's 32K-byte row.  The NumPy walk is held to
    refine_trace_reference."""
    if kind == "tie":
        ptr, lens, best_j = _tie_grid_trace_inputs(case)
    else:
        ptr, lens, best_j = _seeded_trace_inputs(*case, m=12)
    cols, reads = _trace_walk(ptr, lens, best_j)
    want = tdev.refine_trace_reference(torch.from_numpy(ptr),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(best_j))
    assert np.array_equal(cols, want.numpy())
    name, k, pitch = tdev.refine_kernel_plan(ptr.shape[2] - 1)
    assert name == "refine_dp_warp"
    seen = {"j<=1": 0, "i<32": 0}
    for member, steps in enumerate(reads):
        off = k - 1 - int(lens[member]) % k
        f_prev = j_lanes = None
        for t0 in range(0, len(steps), 32):
            i, j = steps[t0][:2]
            f_prev = i + off if f_prev is None else f_prev
            j_lanes = j if j_lanes is None else j_lanes - 32
            base, loaded = _window(f_prev)
            assert loaded <= 80 and base + loaded <= pitch
            for q, (_, jq, col, pos) in enumerate(steps[t0:t0 + 32]):
                assert col == max(j_lanes - q, 1) - 1
                assert base <= pos + off < base + loaded
                seen["j<=1"] += jq <= 1
                seen["i<32"] += pos < 32
            f_prev = i + off
    assert seen["i<32"] > 0
    if kind == "seeded":
        assert seen["j<=1"] > 0


def _kmer_sets(seed, n, length, div):
    """k-mer sets (k = 12) of a family of ``n`` sequences of ``length`` at
    ``div`` substitution divergence: over 65,536 distinct k-mers, so
    _pairwise_intersections takes its chunked group-pair path."""
    from multiprime_tpu_torch.cluster.greedy import _encode, kmer_set
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=length)
    seqs = []
    for _ in range(n):
        s = base.copy()
        hit = rng.random(length) < div
        s[hit] = rng.integers(0, 4, size=int(hit.sum()))
        seqs.append("".join("ACGT"[v] for v in s))
    return seqs, [kmer_set(_encode(s), 12) for s in seqs]


@pytest.mark.parametrize("chunk", [7, 1000, 99_991, 4_000_000])
def test_pairwise_intersections_in_chunks(chunk, monkeypatch):
    """Chunks of the pair expansion of 7 pairs up to the default 4M (where
    the last chunk's cut passed the last group, pick_center raised
    IndexError at 100 genomes of 8.3 kb): the matrix equals per-pair
    intersect1d, and pick_center the plain O(n^2) Jaccard pick."""
    seqs, sets = _kmer_sets(3, 30, 5000, 0.1)
    assert np.unique(np.concatenate(sets)).size > 65536
    monkeypatch.setattr(tcs, "_PAIR_CHUNK", chunk)
    mat = tcs._pairwise_intersections(sets)
    want = np.array([[np.intersect1d(a, b).size for b in sets]
                     for a in sets])
    assert np.array_equal(mat, want)
    jac = [sum(want[i, j] / (want[i, i] + want[j, j] - want[i, j])
               for j in range(len(sets)) if j != i)
           for i in range(len(sets))]
    assert tcs.pick_center(seqs) == int(np.argmax(jac))


def test_align_ops_batch_blocks_by_bytes(monkeypatch):
    """A byte budget of three members a block at members over 1,280 bases
    with indels (the CTA kernel's widths): the op lists and as_codes
    matrix equal one block's."""
    ids, seqs = _family(31, 9, 1330, (5, 40))
    codes = [tcs._encode(s) for s in seqs]
    c, members = codes[0], codes[1:]
    lb = max(len(b) for b in members)
    assert lb + 1 > tdev._GOTOH_WARP_MAX_COLS
    whole = tdev.align_ops_batch_device(c, members, device="cpu")
    whole_codes = tdev.align_ops_batch_device(c, members, as_codes=True,
                                              device="cpu")
    per = tdev.gotoh_member_bytes(len(c), lb)
    monkeypatch.setattr(tdev, "_DP_BLOCK_BYTES", 3 * per + 1)
    assert tdev.block_members(per, 512) == 3
    assert tdev.align_ops_batch_device(c, members, device="cpu") == whole
    got = tdev.align_ops_batch_device(c, members, as_codes=True,
                                      device="cpu")
    assert got.shape == whole_codes.shape
    assert np.array_equal(got, whole_codes)
    assert whole == jcs.align_ops_batch(c, members)


def test_refine_msa_device_equals_host_with_indels(monkeypatch):
    """refine_msa on the device backend (the plain versions on the CPU, in
    refine blocks of 4 members under a small byte budget) equals the host
    backend and the JAX package's refine_msa on an indel-rich family, and
    its passes move residues."""
    ids, seqs = _family(37, 14, 200, (10, 35))
    _, rows = tcs.center_star_msa(ids, seqs, backend="native", device="cpu")
    want = trefine.refine_msa(rows, 2)
    assert want == jrefine.refine_msa(rows, 2)
    assert want != rows
    assert trefine.refine_msa(rows, 2, backend="device", device="cpu") == want
    args = trefine.device_pass_inputs(rows)
    per = tdev.refine_member_bytes(args[5], args[1].shape[1])
    monkeypatch.setattr(tdev, "_DP_BLOCK_BYTES", 4 * per)
    assert tdev.block_members(per, 256) == 4
    assert trefine.refine_msa(rows, 2, backend="device", device="cpu") == want
