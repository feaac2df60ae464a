"""Device-side batched Gotoh alignment for the center-star MSA, and the
profile-realignment DP of ``refine``.

PyTorch port of multiprime_tpu/align/device.py, whose two device programs
(``_build``, the Gotoh row DP, and ``_build_refine``, the refine column
DP, each a ``lax.scan`` with its trace, jitted into one XLA program a
block of members) become two hand-written CUDA kernels, one launch a
block.  The pointer tensors stay on the device and the back-traces run
there too, so only the op codes (``[M, la+lb] uint8``) or the placed
columns cross to the host.  Results equal the NumPy and native DPs: same
scores, same tie-breaking.

* ``align_ops_batch_device`` runs ``gotoh_block`` a member block:
  ``csrc/gotoh_dp.cu`` for CUDA tensors, one of its two kernels chosen by
  the block's width alone (``gotoh_kernel_plan``): ``gotoh_dp_warp_kernel``
  (one warp a member, the row in registers, no block barrier) while lb + 1
  <= ``_GOTOH_WARP_MAX_COLS`` (1280), ``gotoh_dp_kernel`` (one CTA a
  member, the row in shared or global memory) past it.  For CPU tensors
  its plain version ``gotoh_block_reference``, a Python loop over center
  rows of ~25 vector ops on ``[M, lb+1]`` int32 lanes, the within-row
  affine-E dependency folded into ``torch.cummax`` like the NumPy prefix
  max, and a trace loop of the same kind.
* ``refine_pass_device`` runs ``refine_block`` a member block:
  ``csrc/refine_dp.cu`` for CUDA tensors, one of its two kernels chosen by
  the block's width (``refine_kernel_plan``):
  ``refine_dp_warp_kernel`` (one warp a member, the column in registers,
  the profile staged 32 columns ahead, the trace walked in tiles) while
  lmax + 1 <= ``_REFINE_WARP_MAX_POS`` (1280), ``refine_dp_kernel`` (one
  CTA a member) past it and for a block with a positive gap term.  For
  CPU tensors its plain version ``refine_block_reference``, a loop over
  MSA columns on ``[M, lmax+1]`` float32 lanes with the profile lookup as
  a ``torch.gather`` (exact).
  The host pre-scales every multiply, so each device step (kernel and
  plain version alike) is one IEEE add, max or compare and the card
  rounds as NumPy does.

The JAX module padded rows, columns and members to buckets so that XLA
compiled few executables; here a block runs at its true sizes.  Only the
width of the ``as_codes`` matrix keeps the JAX buckets (rows and columns
to multiples of 256), so the matrices are equal in shape too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _cuda
from ..utils import link as linkmod
from ..utils import trace
from .centerstar import GAP_EXT, GAP_OPEN, MATCH, MISMATCH

_NEG = -1 << 28
_NEGF = float(np.float32(-1e30))
_PAD_OP = 3
_OP_CHARS = np.array(["M", "D", "I", ""], dtype=object)


# threads of a kernel's CTA (one CTA a member), and the bytes of a
# member's row state (V, F or G, pointer bits, codes) kept in shared memory:
# past it the state moves to a global scratch
_DP_THREADS = 256
_DP_SMEM_BYTES = 160 * 1024
# the device bytes one gotoh_block or refine_block call may allocate (its
# pointer scratch, row state, inputs and outputs): the member blocks of a
# call are sized by it, so that eight workers beside one card fit with room
# at genome length (a 500-member family of 8.3 kb takes about 61 members a
# Gotoh block); at CDS length the members cap a block first
_DP_BLOCK_BYTES = 4 << 30

# the warp kernels' columns (slots) a lane, their instantiations in
# csrc/gotoh_dp.cu and csrc/refine_dp.cu (at 48 and more the Gotoh row no
# longer fits the registers and spills), and the widest block each takes:
# lb + 1 columns, lmax + 1 residue positions; wider blocks take the CTA
# kernel (the tests lower a limit to force that)
_WARP_KS = (8, 16, 24, 32, 40)
_GOTOH_WARP_MAX_COLS = 32 * _WARP_KS[-1]
_REFINE_WARP_MAX_POS = 32 * _WARP_KS[-1]


def _round_up(x, mult):
    return ((int(x) + mult - 1) // mult) * mult


def _row_state(m, width, slot_bytes, dev):
    """(global scratch or None, bytes a member) for the row state of a DP
    kernel: ``slot_bytes`` a cell of ``width`` cells, rounded up to whole
    thread slots; None (shared memory) while it fits ``_DP_SMEM_BYTES``."""
    need = slot_bytes * _round_up(width, _DP_THREADS)
    if need <= _DP_SMEM_BYTES:
        return None, 0
    region = _round_up(need, 16)
    return torch.empty(m * region, dtype=torch.uint8, device=dev), region


def gotoh_member_bytes(la, lb):
    """Device bytes a member adds to a ``gotoh_block`` call of center length
    ``la`` and member width ``lb``: its pointer scratch, its ops, the CTA
    kernel's row state where it leaves shared memory, and its codes."""
    name, _, pitch = gotoh_kernel_plan(lb)
    state = 10 * _round_up(lb + 1, _DP_THREADS)
    state = (0 if name != "gotoh_dp" or state <= _DP_SMEM_BYTES
             else _round_up(state, 16))
    return la * pitch + (la + lb) + state + 4 * (lb + 1)


def refine_member_bytes(c, lmax):
    """Device bytes a member adds to a ``refine_block`` call of ``c``
    columns and member width ``lmax``: its pointer scratch (at the width's
    kernel, whose pitch is never below the CTA kernel's), the CTA kernel's
    row state where it leaves shared memory, its profile terms (s4, go_c,
    ge_c, occ2), codes, length and placed columns."""
    name, _, pitch = refine_kernel_plan(lmax)
    state = 9 * _round_up(lmax + 1, _DP_THREADS)
    state = (0 if name != "refine_dp" or state <= _DP_SMEM_BYTES
             else _round_up(state, 16))
    return c * pitch + state + 4 * c * (6 + 3) + 8 * lmax + 8 + 8 * c


def block_members(member_bytes, cap):
    """Members a DP block takes: as many as ``_DP_BLOCK_BYTES`` holds at
    ``member_bytes`` each, at least one and at most ``cap``."""
    return max(1, min(int(cap), _DP_BLOCK_BYTES // max(member_bytes, 1)))


def _ptr_or_null(t):
    return None if t is None else t.data_ptr()


def _ranges(*tensors):
    """[min, max, min, max, ...] of non-empty integer tensors, one sync."""
    return torch.stack([v for t in tensors for v in torch.aminmax(t)]).tolist()


def _check_clocks(fn, clocks, m, dev):
    if clocks is not None:
        _cuda.check_inputs(fn, dev, (("clocks", clocks, torch.int64, 2),))
        if tuple(clocks.shape) != (m, 3):
            raise ValueError("%s: clocks must be [%d, 3], got %s"
                             % (fn, m, tuple(clocks.shape)))


def gotoh_block_reference(c, bmat, lbs, dev):
    """Row DP + back-trace of one member block on ``dev``.

    c: int codes [la] of the center (host); bmat int32 [M, lb] member codes
    (4 past each end), lbs int32 [M] -> uint8 ops [M, steps] in reverse
    order, ``_PAD_OP`` once a member's trace is done."""
    la = len(c)
    m, lb = bmat.shape
    jar = torch.arange(lb + 1, dtype=torch.int32, device=dev)
    valid = jar[None, :] <= lbs[:, None]
    v_prev = torch.where(valid, GAP_OPEN + GAP_EXT * jar[None, :], _NEG)
    v_prev[:, 0] = 0
    f_prev = torch.full((m, lb + 1), _NEG, dtype=torch.int32, device=dev)
    # substitution scores of each center code: codes 4+ never match
    subs = [torch.where(bmat == code, MATCH, MISMATCH).to(torch.int32)
            for code in range(4)]
    sub_other = torch.full((m, lb), MISMATCH, dtype=torch.int32, device=dev)
    neg_col = torch.full((m, 1), _NEG, dtype=torch.int32, device=dev)
    one_col = torch.ones((m, 1), dtype=torch.uint8, device=dev)
    false_col = torch.zeros((m, 1), dtype=torch.bool, device=dev)
    e_off = GAP_OPEN - GAP_EXT * jar[None, :]
    e_back = GAP_EXT * jar[None, 1:]
    packed = torch.empty((la + 1, m, lb + 1), dtype=torch.uint8, device=dev)
    row0 = ((jar >= 1).to(torch.uint8) * 2) | ((jar >= 2).to(torch.uint8) * 8)
    packed[0] = row0[None, :]
    for i in range(1, la + 1):
        ci = int(c[i - 1])
        sub = subs[ci] if 0 <= ci < 4 else sub_other
        f_ext = f_prev + GAP_EXT
        f_open = v_prev + (GAP_OPEN + GAP_EXT)
        f_cur = torch.maximum(f_ext, f_open)
        fcont = f_ext >= f_open
        diag = v_prev[:, :-1] + sub
        vert = torch.cat([f_cur[:, :1], torch.maximum(diag, f_cur[:, 1:])],
                         dim=1)
        p = torch.cat([one_col, (diag < f_cur[:, 1:]).to(torch.uint8)],
                      dim=1)
        t = vert + e_off
        run_max = torch.cummax(t[:, :-1], dim=1).values
        e_cur = torch.cat([neg_col, run_max + e_back], dim=1)
        econt = torch.cat([false_col, t[:, :-1] < run_max], dim=1)
        v_prev = torch.where(valid, torch.maximum(vert, e_cur), _NEG)
        p = torch.where(e_cur > vert, 2, p)
        packed[i] = (p | (fcont.to(torch.uint8) << 2)
                     | (econt.to(torch.uint8) << 3))
        f_prev = torch.where(valid, f_cur, _NEG)

    flat = packed.reshape(-1)
    base = torch.arange(m, dtype=torch.int64, device=dev) * (lb + 1)
    row_stride = m * (lb + 1)
    i = torch.full((m,), la, dtype=torch.int64, device=dev)
    j = lbs.to(torch.int64)
    st = torch.zeros((m,), dtype=torch.int64, device=dev)
    steps = la + (int(lbs.max()) if m else 0)
    ops = torch.empty((steps, m), dtype=torch.uint8, device=dev)
    for s in range(steps):
        done = (i == 0) & (j == 0)
        pf = flat[i * row_stride + base + j].to(torch.int64)
        mv = torch.where(
            i == 0, 2,
            torch.where(j == 0, 1,
                        torch.where(st == 1, 1,
                                    torch.where(st == 2, 2, pf & 3))))
        fc = (pf >> 2) & 1
        ec = (pf >> 3) & 1
        new_st = torch.where(
            mv == 0, 0,
            torch.where(mv == 1, fc,
                        torch.where((i > 0) & (j > 0), 2 * ec, 0)))
        ops[s] = torch.where(done, _PAD_OP, mv)
        i = torch.where(done, 0, i - (mv != 2).to(torch.int64))
        j = torch.where(done, 0, j - (mv != 1).to(torch.int64))
        st = torch.where(done, 0, new_st)
    return ops.T


def _kernel_plan(n, limit, name):
    """(launcher, its size argument, pointer scratch pitch) of a DP block
    of ``n`` cells a row: while n <= ``limit``, (name + "_warp", K, 32 *
    K), K the smallest of ``_WARP_KS`` with 32 * K >= n; past it (name,
    ``_DP_THREADS``, n)."""
    if n <= limit:
        k = next(k for k in _WARP_KS if 32 * k >= n)
        return name + "_warp", k, 32 * k
    return name, _DP_THREADS, n


def gotoh_kernel_plan(lb):
    """The Gotoh kernel of a block of member width ``lb``, by shape only:
    the warp kernel ("gotoh_dp_warp") while lb + 1 <=
    ``_GOTOH_WARP_MAX_COLS``, past it the CTA kernel ("gotoh_dp");
    ``_kernel_plan`` gives the sizes."""
    return _kernel_plan(lb + 1, _GOTOH_WARP_MAX_COLS, "gotoh_dp")


def gotoh_block(c, bmat, lbs, *, clocks=None):
    """Row DP + back-trace of one member block: int32 center codes ``c``
    [la], member codes ``bmat`` int32 [M, lb] (4 past each end) and their
    lengths ``lbs`` int32 [M] -> uint8 ops [M, la + max(lbs)] in reverse
    order, ``_PAD_OP`` once a member's trace is done.

    CUDA tensors launch a CUDA kernel of ``csrc/gotoh_dp.cu`` (or raise),
    the one ``gotoh_kernel_plan(lb)`` names: one warp (blocks up to
    ``_GOTOH_WARP_MAX_COLS`` columns) or one CTA a member runs every row
    and the trace, one launch a block.  ``clocks`` (int64 [M, 3],
    optional) receives each member's clock64 at its start and before and
    after its trace.  CPU tensors take the plain version."""
    dev = bmat.device
    if dev.type == "cpu":
        return gotoh_block_reference(np.asarray(c), bmat, lbs, dev)
    _cuda.check_inputs("gotoh_block", dev, (("c", c, torch.int32, 1),
                                            ("bmat", bmat, torch.int32, 2),
                                            ("lbs", lbs, torch.int32, 1)))
    m, lb = bmat.shape
    if lbs.shape[0] != m:
        raise ValueError("gotoh_block: lbs must be [%d], got %s"
                         % (m, tuple(lbs.shape)))
    _check_clocks("gotoh_block", clocks, m, dev)
    name, size, pitch = gotoh_kernel_plan(lb)
    lib = _cuda.load("gotoh_dp")
    if dev.type != "cuda":
        raise ValueError("gotoh_block: unsupported device %s" % dev)
    la = c.shape[0]
    lo, hi = _ranges(lbs) if m else (0, 0)
    if lo < 0 or hi > lb:
        raise ValueError("gotoh_block: lbs must lie in 0..%d, got %d..%d"
                         % (lb, lo, hi))
    steps = la + hi
    ops = torch.empty((m, steps), dtype=torch.uint8, device=dev)
    if ops.numel() == 0:
        return ops
    ptr = torch.empty(m * la * pitch, dtype=torch.uint8, device=dev)
    args = (c.data_ptr(), la, bmat.data_ptr(), lbs.data_ptr(), m, lb,
            ptr.data_ptr(), ops.data_ptr(), steps)
    if name == "gotoh_dp":
        # the CTA kernel's row state: shared memory or a global scratch
        state, region = _row_state(m, lb + 1, 10, dev)
        args += (_ptr_or_null(state), region)
    with torch.cuda.device(dev):
        _cuda.launch(lib, name, *args, size, _ptr_or_null(clocks),
                     torch.cuda.current_stream(dev).cuda_stream)
    return ops


def gotoh_block_inputs(members, *, device):
    """Member code arrays of one block -> (bmat int32 [M, lb], lbs int32
    [M]) on ``device``: lb = max(lbs) (at least 1), code 4 past each
    member's end."""
    lbs = np.array([len(b) for b in members], np.int32)
    bmat = np.full((len(members), max(int(lbs.max()) if len(lbs) else 1, 1)),
                   4, np.int32)
    for k, b in enumerate(members):
        bmat[k, :len(b)] = np.asarray(b, np.int32)
    return (torch.from_numpy(bmat).to(device),
            torch.from_numpy(lbs).to(device))


def align_ops_batch_device(c, member_codes, member_block=512,
                           as_codes=False, *, device="cuda"):
    """Device equivalent of ``centerstar.align_ops_batch``.

    ``c`` and ``member_codes`` are int code arrays (A=0..T=3, other=4+).
    Returns one op list (['M'|'D'|'I'] strings) per member, identical to
    the NumPy path; with ``as_codes=True``, instead returns the forward
    uint8 code matrix [M, S] (0=M, 1=D, 2=I, 3=pad at the end) consumed by
    ``centerstar._merge_rows_vec`` without per-op Python lists.
    """
    with trace.span("align.dp"):
        trace.count("members", len(member_codes))
        return _align_ops_batch(c, member_codes, member_block, as_codes,
                                device)


def _align_ops_batch(c, member_codes, member_block, as_codes, device):
    """``align_ops_batch_device``'s body: blocks of at most ``member_block``
    members, fewer where ``_DP_BLOCK_BYTES`` holds fewer at the call's
    widest member; the ops do not depend on the blocks."""
    dev = linkmod.resolve_device(device)
    copies = trace.ON and dev.type != "cpu"
    c = np.asarray(c, np.int64)
    la = len(c)
    out = [None] * len(member_codes)
    parts = []
    la_pad = _round_up(max(la, 1), 256)
    c_dev = torch.from_numpy(c.astype(np.int32)).to(dev)
    if copies:
        trace.count("h2d_bytes", 4 * la)
    lb_max = max([len(b) for b in member_codes] + [1])
    step = block_members(gotoh_member_bytes(la, lb_max), member_block)
    for lo in range(0, len(member_codes), step):
        part = member_codes[lo:lo + step]
        bmat, lbs_dev = gotoh_block_inputs(part, device=dev)
        lb = bmat.shape[1]
        if trace.ON:
            trace.count("blocks")
            trace.count("cells", len(part) * la * lb)
            trace.count("ptr_bytes", len(part) * la * gotoh_kernel_plan(lb)[2])
        ops_rev = gotoh_block(c_dev, bmat, lbs_dev).cpu().numpy()
        if copies:
            trace.count("h2d_bytes", 4 * (bmat.numel() + len(part)))
            trace.count("d2h_bytes", ops_rev.nbytes)
        del bmat, lbs_dev        # freed before the next block's are made
        if as_codes:
            # reverse + left-shift out the pad prefix, all in NumPy; the
            # width is the JAX trace's, la_pad + lb_pad
            s_blk = la_pad + _round_up(lb, 256)
            n_real = (ops_rev != _PAD_OP).sum(axis=1)
            flipped = np.full((len(part), s_blk), _PAD_OP, np.uint8)
            flipped[:, s_blk - ops_rev.shape[1]:] = ops_rev[:, ::-1]
            idx = np.arange(s_blk)[None, :] + (s_blk - n_real)[:, None]
            fwd = np.take_along_axis(
                flipped, np.minimum(idx, s_blk - 1), axis=1)
            fwd[np.arange(s_blk)[None, :] >= n_real[:, None]] = _PAD_OP
            parts.append(fwd)
            continue
        for k in range(len(part)):
            codes = ops_rev[k]
            real = codes[codes != _PAD_OP][::-1]
            out[lo + k] = list(_OP_CHARS[real])
    if as_codes:
        smax = max(p.shape[1] for p in parts)
        fmat = np.full((len(member_codes), smax), _PAD_OP, np.uint8)
        row = 0
        for p in parts:
            fmat[row:row + len(p), :p.shape[1]] = p
            row += len(p)
        return fmat
    return out


def refine_block_reference(res_codes, lens, s4, go_c, ge_c, occ2, dev):
    """Column DP + trace of one member block on ``dev``.

    res_codes int64 [M, lmax] (codes 0..5), lens int64 [M]; s4 [C, M, 6]
    = 4*f6, go_c/ge_c/occ2 [C, M] = GAP_OPEN*occ, GAP_EXT*occ, 2*occ (all
    float32, rounded on the host) -> int64 [M, C] placed columns (-1 = no
    placement), last residue first."""
    ptr, best_j = refine_columns_reference(res_codes, lens, s4, go_c, ge_c,
                                           occ2, dev)
    return refine_trace_reference(ptr, lens, best_j)


def refine_columns_reference(res_codes, lens, s4, go_c, ge_c, occ2, dev):
    """The column DP of ``refine_block_reference`` -> (uint8 pointer bytes
    [C, M, lmax + 1], skip | gcont << 1; int64 best end column [M])."""
    c, m = go_c.shape
    lmax = res_codes.shape[1]
    iar = torch.arange(lmax + 1, device=dev)
    active = iar[None, :] <= lens[:, None]
    v_prev = torch.where(iar[None, :] == 0, 0.0, _NEGF).expand(m, lmax + 1)
    g_prev = torch.full((m, lmax + 1), _NEGF, dtype=torch.float32,
                        device=dev)
    best_v = torch.full((m,), _NEGF, dtype=torch.float32, device=dev)
    best_j = torch.zeros((m,), dtype=torch.int64, device=dev)
    neg_col = torch.full((m, 1), _NEGF, dtype=torch.float32, device=dev)
    ptr = torch.empty((c, m, lmax + 1), dtype=torch.uint8, device=dev)
    for jc in range(c):
        # s_col = 2*(2*f6_gather - occ): one rounding, as in NumPy
        s_col = torch.gather(s4[jc], 1, res_codes) - occ2[jc][:, None]
        open_cand = v_prev + go_c[jc][:, None]
        gcont = g_prev >= open_cand
        g_cur = torch.maximum(g_prev, open_cand) + ge_c[jc][:, None]
        diag = torch.cat([neg_col, v_prev[:, :-1] + s_col], dim=1)
        take_skip = g_cur > diag
        v_cur = torch.where(take_skip, g_cur, diag)
        v_cur[:, 0] = 0.0
        v_prev = torch.where(active, v_cur, _NEGF)
        g_prev = torch.where(active, g_cur, _NEGF)
        ptr[jc] = take_skip.to(torch.uint8) | (gcont.to(torch.uint8) << 1)
        v_end = torch.gather(v_prev, 1, lens[:, None])[:, 0]
        upd = v_end > best_v
        best_v = torch.where(upd, v_end, best_v)
        best_j = torch.where(upd, jc + 1, best_j)
    return ptr, best_j


def refine_trace_reference(ptr, lens, best_j):
    """The trace of ``refine_block_reference`` over its pointer bytes ``ptr``
    [C, M, lmax + 1] from (lens, best_j) -> int64 [M, C] placed columns."""
    c, m, width = ptr.shape
    dev = ptr.device
    flat = ptr.reshape(-1)
    base = torch.arange(m, dtype=torch.int64, device=dev) * width
    col_stride = m * width
    i, j = lens.clone(), best_j
    skip = torch.zeros((m,), dtype=torch.bool, device=dev)
    cols = torch.empty((c, m), dtype=torch.int64, device=dev)
    for s in range(c):
        done = i == 0
        p = flat[(j.clamp(min=1) - 1) * col_stride + base + i]
        take = (j > i) & (skip | ((p & 1) == 1))
        place = ~done & ~take
        cols[s] = torch.where(place, j - 1, -1)
        skip = ~done & take & ((p & 2) == 2)
        i = torch.where(done | take, i, i - 1)
        j = torch.where(done, j, j - 1)
    return cols.T


def refine_kernel_plan(lmax, positive_gaps=False):
    """The refine kernel of a block of member width ``lmax``: the warp
    kernel ("refine_dp_warp") while lmax + 1 <= ``_REFINE_WARP_MAX_POS``,
    past it the CTA kernel ("refine_dp"); ``_kernel_plan`` gives the
    sizes.  A block with a positive gap term (``positive_gaps``; GAP_OPEN
    * occ and GAP_EXT * occ never are) takes the CTA kernel at any width:
    the warp kernel's position 0 holds V = 0 with no select only while its
    G <= 0."""
    return _kernel_plan(lmax + 1, -1 if positive_gaps
                        else _REFINE_WARP_MAX_POS, "refine_dp")


def refine_block(res_codes, lens, s4, go_c, ge_c, occ2, *, clocks=None):
    """Column DP + trace of one member block: residue codes ``res_codes``
    int64 [M, lmax] (0..5), ``lens`` int64 [M]; ``s4`` float32 [C, M, 6],
    ``go_c``/``ge_c``/``occ2`` float32 [C, M] (host-scaled, see
    ``refine_block_reference``) -> int64 [M, C] placed columns (-1 = no
    placement), last residue first.

    CUDA tensors launch a CUDA kernel of ``csrc/refine_dp.cu`` (or raise),
    the one ``refine_kernel_plan`` names for the block's width and the
    sign of its gap terms: one warp (blocks up to ``_REFINE_WARP_MAX_POS``
    positions whose ``go_c``, ``ge_c`` <= 0, as ``refine_block_inputs``
    makes them) or one CTA a member runs every column and the trace, one
    launch a block.  ``clocks`` (int64 [M, 3],
    optional) receives each member's clock64 at its start and before and
    after its trace.  CPU tensors take the plain version."""
    dev = res_codes.device
    if dev.type == "cpu":
        return refine_block_reference(res_codes, lens, s4, go_c, ge_c, occ2,
                                      dev)
    _cuda.check_inputs("refine_block", dev, (
        ("res_codes", res_codes, torch.int64, 2),
        ("lens", lens, torch.int64, 1), ("s4", s4, torch.float32, 3),
        ("go_c", go_c, torch.float32, 2), ("ge_c", ge_c, torch.float32, 2),
        ("occ2", occ2, torch.float32, 2)))
    m, lmax = res_codes.shape
    c = go_c.shape[0]
    for name, t, shape in (("lens", lens, (m,)), ("s4", s4, (c, m, 6)),
                           ("go_c", go_c, (c, m)), ("ge_c", ge_c, (c, m)),
                           ("occ2", occ2, (c, m))):
        if tuple(t.shape) != shape:
            raise ValueError("refine_block: %s must be %s, got %s"
                             % (name, list(shape), tuple(t.shape)))
    _check_clocks("refine_block", clocks, m, dev)
    lib = _cuda.load("refine_dp")
    if dev.type != "cuda":
        raise ValueError("refine_block: unsupported device %s" % dev)
    cols = torch.empty((m, c), dtype=torch.int64, device=dev)
    if cols.numel() == 0:
        return cols
    # the ranges the kernels index by and the gap terms' maxima, one sync
    zero = lens.new_zeros(())
    stats = torch.stack([x.double() for x in (
        *torch.aminmax(lens),
        *(torch.aminmax(res_codes) if lmax else (zero, zero)),
        go_c.max(), ge_c.max())]).tolist()
    if stats[0] < 0 or stats[1] > lmax or stats[2] < 0 or stats[3] > 5:
        raise ValueError("refine_block: lens must lie in 0..%d and codes in "
                         "0..5, got %d..%d and %d..%d" % (lmax, *stats[:4]))
    name, size, pitch = refine_kernel_plan(lmax, max(stats[4:]) > 0)
    ptr = torch.empty(m * c * pitch, dtype=torch.uint8, device=dev)
    args = (res_codes.data_ptr(), lens.data_ptr(), m, lmax, s4.data_ptr(),
            go_c.data_ptr(), ge_c.data_ptr(), occ2.data_ptr(), c,
            ptr.data_ptr(), cols.data_ptr())
    if name == "refine_dp":
        # the CTA kernel's row state: shared memory or a global scratch
        state, region = _row_state(m, lmax + 1, 9, dev)
        args += (_ptr_or_null(state), region)
    with torch.cuda.device(dev):
        _cuda.launch(lib, name, *args, size, _ptr_or_null(clocks),
                     torch.cuda.current_stream(dev).cuda_stream)
    return cols


def refine_block_inputs(res_codes, lens, f6, occ, sel, go=-4.0, ge=-1.0,
                        *, device):
    """The arguments of ``refine_block`` for the members ``sel`` of a pass
    (``refine_pass_device``'s inputs), on ``device``: every multiply
    pre-scaled and rounded to float32 on the host."""
    s4 = (4.0 * f6[sel]).astype(np.float32).transpose(1, 0, 2)
    occ_t = occ[sel].astype(np.float32).T
    go_c = (np.float32(go) * occ_t).astype(np.float32)
    ge_c = (np.float32(ge) * occ_t).astype(np.float32)
    occ2 = (np.float32(2.0) * occ_t).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (res_codes[sel].astype(np.int64),
                      lens[sel].astype(np.int64), s4, go_c, ge_c, occ2)]


def refine_pass_device(res_chars, res_codes, lens, f6, occ, c,
                       go=-4.0, ge=-1.0, member_block=256, *, device="cuda"):
    """Device twin of refine._realign_chunk: returns new row byte-strings.

    f6 [M, C, 6], occ [M, C] float32 (self-excluded profile), res_codes
    [M, lmax] int codes, lens [M].  The host pre-scales every multiply so
    the device DP is add/max-only and rounds identically to the NumPy path.
    """
    dev = linkmod.resolve_device(device)
    copies = trace.ON and dev.type != "cpu"
    m = len(res_chars)
    lmax = res_codes.shape[1]
    rows = []
    # blocks of at most member_block members, fewer where _DP_BLOCK_BYTES
    # holds fewer (the rows do not depend on the blocks)
    step = block_members(refine_member_bytes(c, lmax), member_block)
    for lo in range(0, m, step):
        sel = slice(lo, min(lo + step, m))
        mc = sel.stop - sel.start
        blk = refine_block_inputs(res_codes, lens, f6, occ, sel, go, ge,
                                  device=dev)
        cols = refine_block(*blk).cpu().numpy()
        trace.count("blocks")
        if copies:
            trace.count("h2d_bytes", sum(t.nbytes for t in blk))
            trace.count("d2h_bytes", cols.nbytes)
        del blk                  # freed before the next block's are made
        # Vectorised placement: the trace emits residues last-to-first, so
        # the r-th placed column of member k carries chars[lens[k]-1-r].
        chars_mat = np.zeros((mc, lmax if lmax else 1), np.uint8)
        for k in range(mc):
            b = res_chars[lo + k]
            chars_mat[k, :len(b)] = np.frombuffer(b, np.uint8)
        placed_mask = cols >= 0
        rank = np.cumsum(placed_mask, axis=1, dtype=np.int64) - 1
        rk, sk = np.nonzero(placed_mask)
        res_idx = lens[lo + rk] - 1 - rank[rk, sk]
        out_mat = np.full((mc, c), ord("-"), np.uint8)
        out_mat[rk, cols[rk, sk]] = chars_mat[rk, res_idx]
        row_bytes = out_mat.tobytes()
        rows.extend(row_bytes[k * c:(k + 1) * c] for k in range(mc))
    return rows
