"""Device-mesh sharding for the design and scan kernels, on torch devices.

PyTorch port of multiprime_tpu/parallel/mesh.py.  The workload has two
natural parallel axes:

* ``seq``  — target/MSA sequences (data parallel).  Window statistics and
  coverage counts are plain sums over this axis.
* ``win``  — window positions / primer candidates.  Fully independent ->
  plain data parallelism, no collectives.

The JAX package runs its mesh as single-process SPMD (``shard_map`` with
``psum`` over a 2-D ``Mesh(('seq', 'win'))``).  The port is one process
too: a ``Mesh`` is a 2-D array of ``torch.device``s, each shard's work runs
on its own device, and the psum is an exact integer sum of the per-shard
int64 tensors on the first device of the column (or of the mesh).  Integer
sums are exact in any order, so every result equals the unsharded one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import design_scan, mismatch_scan
from ..utils import link as linkmod

AXES = ("seq", "win")


class Mesh:
    """A 2-D (seq, win) array of torch devices: the counterpart of
    ``jax.sharding.Mesh(devices, ("seq", "win"))``.  Any device array will
    do, the same device several times included (a 2 x 2 mesh of one GPU)."""

    def __init__(self, devices, axis_names=AXES):
        if tuple(axis_names) != AXES:
            raise ValueError("mesh axes must be %r, got %r"
                             % (AXES, tuple(axis_names)))
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("mesh devices must form a non-empty 2-D array")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, d in enumerate(row):
                self.devices[i, j] = d
        self.axis_names = AXES
        self.shape = {"seq": len(rows), "win": len(rows[0])}

    def spec(self):
        """The device strings [[...], ...]: a picklable form that
        ``Mesh(spec)`` rebuilds (a pool worker's copy of the mesh)."""
        return [[str(d) for d in row] for row in self.devices]


def make_mesh(n_devices=None, seq_axis=None, *, device="cuda"):
    """Build a (seq, win) mesh of ``n_devices`` devices of ``device``'s
    type, factorised as the JAX package's make_mesh.  CUDA takes cuda:0 ..
    cuda:n-1 (default: every GPU) and raises when fewer are present; "cpu"
    takes n CPU entries (default 1), the counterpart of XLA's virtual CPU
    devices."""
    dev = linkmod.resolve_device(device)
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        if n_devices is None:
            n_devices = avail
        if n_devices > avail:
            raise RuntimeError(
                "a mesh of %d CUDA devices was asked for, but %d are "
                "present" % (n_devices, avail))
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        if n_devices is None:
            n_devices = 1
        devices = [torch.device("cpu")] * n_devices
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device")
    if seq_axis is None:
        # favour the seq axis: counts merge with one sum; windows need none
        seq_axis = n_devices
        win_axis = 1
        for cand in range(int(np.sqrt(n_devices)), 0, -1):
            if n_devices % cand == 0:
                seq_axis, win_axis = n_devices // cand, cand
                break
    else:
        win_axis = n_devices // seq_axis
    if seq_axis * win_axis != n_devices:
        raise ValueError("seq_axis=%d does not divide %d devices"
                         % (seq_axis, n_devices))
    return Mesh([devices[i * win_axis:(i + 1) * win_axis]
                 for i in range(seq_axis)])


def _split(n, parts, what):
    if n % parts:
        raise ValueError("%s=%d not divisible by %d shards" % (what, n, parts))
    return n // parts


def _stage_a(mesh, placed, pos_by_col, plen, variation, with_win):
    """Stage A over the mesh: the windows of column j on the devices of
    column j, each row's masks (and their rows, ``design_scan.
    stage_a_rows``) on its device; each shard's counts from the windows
    kernel, summed over 'seq' on the column's first device, the Viterbi
    kernel there.  -> per column, its stats dict (and the patched windows
    of every row, with_win)."""
    cols = []
    for j in range(mesh.shape["win"]):
        head = mesh.devices[0, j]
        total, wins = None, []
        for i in range(mesh.shape["seq"]):
            masks, rows = placed[i, j]
            stats = design_scan.window_stats_from_masks(
                masks, pos_by_col[j], plen=plen, variation=variation,
                with_win=with_win, rows=rows)
            if with_win:
                wins.append(stats.pop("win"))
            if total is None:
                total = {k: v.to(head) for k, v in stats.items()}
            else:
                for k, v in stats.items():
                    total[k] += v.to(head)
        total["viterbi"] = design_scan.viterbi_batch(
            total["freq"], total["nn"], device=head)
        cols.append((total, wins))
    return cols


def _place(mesh, masks):
    """masks split over 'seq', each row's shard on each device of its row,
    with its rows on a card: {(i, j): (int32 tensor, rows or None)}."""
    rows = _split(masks.shape[0], mesh.shape["seq"], "N")
    out = np.empty(mesh.devices.shape, dtype=object)
    for i in range(mesh.shape["seq"]):
        part = np.ascontiguousarray(masks[i * rows:(i + 1) * rows],
                                    dtype=np.int32)
        for j in range(mesh.shape["win"]):
            t = torch.from_numpy(part).to(mesh.devices[i, j])
            out[i, j] = (t, None if t.device.type == "cpu"
                         else design_scan.stage_a_rows(t))
    return out


def _columns(mesh, positions):
    """The window starts of each 'win' column (host arrays: the windows
    kernel's wrapper checks and uploads them)."""
    cols = _split(len(positions), mesh.shape["win"], "W")
    positions = np.asarray(positions, dtype=np.int64)
    return [positions[j * cols:(j + 1) * cols]
            for j in range(mesh.shape["win"])]


def design_stats_sharded(mesh, masks, positions, *, plen=18, variation=1):
    """Multi-device Stage A: masks [N, L] sharded over 'seq', windows [W]
    over 'win' (N and W divisible by the axes); freq/NN/count tensors
    summed over 'seq'; Viterbi on the summed tensors a window shard.
    -> the design_stats dict, every tensor on the mesh's first device."""
    masks = np.asarray(masks)
    cols = _stage_a(mesh, _place(mesh, masks), _columns(mesh, positions),
                    plen, variation, with_win=False)
    first = mesh.devices[0, 0]
    return {k: torch.cat([c[0][k].to(first) for c in cols])
            for k in cols[0][0]}


def design_stats_blocks_sharded(mesh, masks, positions, *, plen=18,
                                variation=1, block=512):
    """Multi-device drop-in for ops.design_scan.design_stats_blocks: the
    same (pos_block, stats as NumPy arrays) stream, windows sharded over
    'win' and MSA rows over 'seq'.

    Sequence rows are padded to a multiple of the 'seq' axis with all-gap
    rows.  An all-gap row contributes exactly +1 to every window's
    gap_number and nothing to freq/nn/cover_number (window_stats: a 0-mask
    window has plen gaps > variation), so the pad count is subtracted from
    gap_number and the pad rows of the patched-window tensor dropped: the
    stream equals the single-device one (the JAX package's rule)."""
    masks = np.ascontiguousarray(masks, dtype=np.int32)
    positions = np.asarray(positions, dtype=np.int64)
    n_real = masks.shape[0]
    seq_shards = mesh.shape["seq"]
    win_shards = mesh.shape["win"]
    if block % win_shards:
        block += win_shards - block % win_shards
    n_pad = -n_real % seq_shards
    if n_pad:
        masks = np.concatenate(
            [masks, np.zeros((n_pad, masks.shape[1]), np.int32)])
    placed = _place(mesh, masks)
    first = mesh.devices[0, 0]
    for b0 in range(0, len(positions), block):
        pos = positions[b0:b0 + block]
        w_real = len(pos)
        if w_real < block:
            pos = np.concatenate(
                [pos, np.full(block - w_real, pos[-1], np.int64)])
        cols = _stage_a(mesh, placed, _columns(mesh, pos), plen, variation,
                        with_win=True)
        out = {k: torch.cat([c[0][k].to(first) for c in cols]).cpu().numpy()
               for k in cols[0][0]}
        # [N, W, plen]: rows over 'seq' within a column, columns over 'win'
        out["win"] = torch.cat([
            torch.cat([w.to(first) for w in c[1]], dim=0) for c in cols],
            dim=1).cpu().numpy()
        if n_pad:
            out["gap_number"] = out["gap_number"] - n_pad
            out["win"] = out["win"][:n_real]
        if w_real < block:
            out = {k: (v[:, :w_real] if k == "win" else v[:w_real])
                   for k, v in out.items()}
        yield positions[b0:b0 + block], out


def _shards(mesh, n):
    """The flattened (seq, win) devices and the rows of each of them."""
    devs = list(mesh.devices.flat)
    return devs, _split(n, len(devs), "N")


def coverage_counts_sharded(mesh, targets_1h, lengths, primers_1h, suffix_1h,
                            *, mm=1, term=4):
    """Multi-device coverage scan: targets sharded over ('seq', 'win')
    flattened as one data axis, primers broadcast; each shard's match and
    suffix counts from the match-count kernel (its plain version on CPU
    entries), and the per-primer hit / covered-sequence counts summed over
    every shard.  -> (per-primer hits [P] int64, covered sequences, 0-d
    int64), on the mesh's first device."""
    targets_1h = np.asarray(targets_1h)
    lengths = np.asarray(lengths)
    plen = np.shape(primers_1h)[1]
    devs, rows = _shards(mesh, targets_1h.shape[0])
    hits = covered = None
    planes = {}
    for k, d in enumerate(devs):
        if d not in planes:
            planes[d] = (mismatch_scan.pattern_planes(primers_1h, device=d),
                         mismatch_scan.pattern_planes(suffix_1h, device=d))
        masks = mismatch_scan.onehot_masks(
            targets_1h[k * rows:(k + 1) * rows]).to(d)
        counts = mismatch_scan.match_counts_kernel(masks, planes[d][0],
                                                   plen=plen)
        suffix = mismatch_scan.match_counts_kernel(masks, planes[d][1],
                                                   plen=plen)
        ok = ((plen - counts) <= mm) & (suffix >= term)
        o_idx = torch.arange(counts.shape[1], device=d)
        lens = torch.from_numpy(lengths[k * rows:(k + 1) * rows]).to(d)
        ok &= ((o_idx[None, :] + plen) <= lens[:, None])[:, :, None]
        part_hits = ok.sum(dim=(0, 1), dtype=torch.int64).to(devs[0])
        part_cov = ok.any(dim=2).any(dim=1).sum(dtype=torch.int64).to(
            devs[0])
        hits = part_hits if hits is None else hits + part_hits
        covered = part_cov if covered is None else covered + part_cov
    return hits, covered


# -- sparse sharded scan ------------------------------------------------------
#
# The coverage validation needs the sparse (gene, pos, primer) hits for the
# F x R product join, not just summed counts.  Each shard thresholds its own
# target rows and compacts its hits to a fixed-size packed block on its
# device; the host decodes each block with its shard's global row offset.

_ACTIVE_MESH = None


def active_mesh():
    return _ACTIVE_MESH


class use_mesh:
    """Context manager routing validate.scan and the device Stage A of
    models.mcdpd through the mesh."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


def find_hits_sharded(mesh, targets, lengths, primers_1h, suffix_1h, *,
                      mm=1, term=4, max_hits_per_shard=1 << 18,
                      want_mism=False):
    """Multi-device sparse scan.  targets: [N, L] uint8 IUPAC masks (or an
    [N, L, 4] one-hot) with N divisible by the mesh size; primers broadcast.
    Each shard runs find_hits_packed (the find_hits kernels) on its own
    device.

    -> int64 array [n_shards, packed length] (find_hits_packed layout);
    decode shard i with global row offset i * (N // n_shards).
    """
    targets = np.asarray(targets)
    if targets.ndim == 3:
        targets = mismatch_scan.onehot_masks(targets).numpy()
    lengths = np.asarray(lengths)
    plen = np.shape(primers_1h)[1]
    devs, rows = _shards(mesh, targets.shape[0])
    planes, packs = {}, []
    for k, d in enumerate(devs):
        if d not in planes:
            planes[d] = mismatch_scan.pack_patterns(primers_1h, suffix_1h,
                                                    device=d)
        tm = torch.from_numpy(np.ascontiguousarray(
            targets[k * rows:(k + 1) * rows], dtype=np.uint8)).to(d)
        tl = torch.from_numpy(lengths[k * rows:(k + 1) * rows]).to(d)
        packs.append(mismatch_scan.find_hits_packed(
            tm, tl, *planes[d], plen=plen, mm=mm, term=term,
            max_hits=max_hits_per_shard, want_mism=want_mism))
    return np.stack([p.cpu().numpy() for p in packs])


def full_design_step(mesh, masks, positions, targets_1h, lengths, primers_1h,
                     suffix_1h, *, plen=18, variation=1, mm=1, term=4):
    """One multi-device "design step": Stage-A stats and consensus over the
    MSA shards plus a coverage scan of candidate primers over the target
    shards (the multi-device dry run's payload: sums over 'seq', windows
    data-parallel over 'win', primers broadcast)."""
    stats = design_stats_sharded(mesh, masks, positions, plen=plen,
                                 variation=variation)
    hits, covered = coverage_counts_sharded(
        mesh, targets_1h, lengths, primers_1h, suffix_1h, mm=mm, term=term)
    return stats, hits, covered
