"""Records what the timed path's device stages produce, for the check that
follows the window.

``install()`` wraps two entry points of the port, in the process that
calls it:

* ``ops.design_scan.design_stats_blocks`` (design Stage A): every block of
  an MSA of more than one row, and of a one-row MSA when a hash of its
  masks and the run's seed selects it (``PERFBENCH_STAGE_A_SHARE`` of
  them), is kept: the masks' hash, the positions, freq, nn, the cover and
  gap counts, the Viterbi paths and a hash of each block's patched
  windows;
* ``align.device.align_ops_batch_device`` (the center-star DP): the center,
  the members and the op codes of every call.

Records go to ``PERFBENCH_CAPTURE_DIR`` while it is set, one ``.npz`` a
call; the variables are read at each call, so a pool's workers follow the
job they serve.  The seconds each call spends recording (hashing,
copying, writing) are appended to a ``seconds-<pid>.txt`` there:
``cost()`` sums them, the recording's share of the timed jobs.  A spawned worker runs the benchmark's main file as
``__mp_main__``, which calls ``install()`` there (run.py).
"""

import functools
import hashlib
import itertools
import os
import time

import numpy as np

DIR_VAR = "PERFBENCH_CAPTURE_DIR"
SEED_VAR = "PERFBENCH_CAPTURE_SEED"
SHARE_VAR = "PERFBENCH_STAGE_A_SHARE"
_CALLS = itertools.count()


def masks_digest(masks):
    return hashlib.sha1(np.ascontiguousarray(masks, np.uint8).tobytes()
                        ).hexdigest()


def win_digest(win):
    return hashlib.sha1(np.ascontiguousarray(win, np.int8).tobytes()
                        ).hexdigest()


def _target():
    return os.environ.get(DIR_VAR) or None


def _selected(digest):
    """Whether a one-row MSA's Stage A is kept: a hash of the seed and the
    masks under the share."""
    share = float(os.environ.get(SHARE_VAR, "0"))
    key = hashlib.sha1((os.environ.get(SEED_VAR, "0") + digest).encode()
                       ).hexdigest()
    return int(key[:8], 16) < share * (1 << 32)


def _save(out_dir, stem, arrays):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "%s-%d-%d.npz" % (stem, os.getpid(),
                                                   next(_CALLS)))
    np.savez(path, **arrays)


def _spent(out_dir, seconds):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "seconds-%d.txt" % os.getpid()),
              "a") as f:
        f.write("%r\n" % seconds)


def _stage_a(orig):
    @functools.wraps(orig)
    def design_stats_blocks(masks, positions, *args, **kwargs):
        out_dir = _target()
        keep = None
        spent = 0.0
        if out_dir is not None:
            t = time.perf_counter()
            masks_u8 = np.ascontiguousarray(masks, np.uint8)
            digest = masks_digest(masks_u8)
            if masks_u8.shape[0] > 1 or _selected(digest):
                keep = {"digest": digest, "blocks": []}
            spent += time.perf_counter() - t
        for pos, stats in orig(masks, positions, *args, **kwargs):
            if keep is not None:
                t = time.perf_counter()
                keep["blocks"].append((np.asarray(pos, np.int64), {
                    k: np.array(v) for k, v in stats.items()
                    if k != "win"}, win_digest(stats["win"])))
                spent += time.perf_counter() - t
            yield pos, stats
        if out_dir is None:
            return
        t = time.perf_counter()
        if keep is not None and keep["blocks"]:
            blocks = keep["blocks"]
            arrays = {k: np.concatenate([b[1][k] for b in blocks]).astype(
                np.int64) for k in blocks[0][1]}
            arrays["positions"] = np.concatenate([b[0] for b in blocks])
            arrays["block_sizes"] = np.array([len(b[0]) for b in blocks])
            arrays["win_digests"] = np.array([b[2] for b in blocks])
            arrays["digest"] = np.array(keep["digest"])
            arrays["shape"] = np.array(np.shape(masks))
            _save(out_dir, "stage_a-" + keep["digest"][:16], arrays)
        _spent(out_dir, spent + time.perf_counter() - t)
    design_stats_blocks._perfbench = True
    return design_stats_blocks


def _gotoh(orig):
    @functools.wraps(orig)
    def align_ops_batch_device(c, member_codes, *args, **kwargs):
        out = orig(c, member_codes, *args, **kwargs)
        out_dir = _target()
        if out_dir is not None:
            t = time.perf_counter()
            lens = np.array([len(m) for m in member_codes], np.int64)
            flat = np.concatenate([np.asarray(m, np.int64)
                                   for m in member_codes])
            if isinstance(out, np.ndarray):
                ops = out
            else:       # op lists: the same codes, padded with 3
                code = {"M": 0, "D": 1, "I": 2}
                ops = np.full((len(out), max(map(len, out))), 3, np.uint8)
                for k, row in enumerate(out):
                    ops[k, :len(row)] = [code[o] for o in row]
            center = np.asarray(c, np.int64)
            _save(out_dir, "gotoh-" + masks_digest(center.astype(np.uint8)
                                                   )[:16],
                  {"center": center, "members": flat, "lens": lens,
                   "ops": np.asarray(ops, np.uint8)})
            _spent(out_dir, time.perf_counter() - t)
        return out
    align_ops_batch_device._perfbench = True
    return align_ops_batch_device


def install():
    """Wrap the two entry points in this process (once)."""
    from multiprime_tpu_torch.align import device as adev
    from multiprime_tpu_torch.ops import design_scan
    if not getattr(design_scan.design_stats_blocks, "_perfbench", False):
        design_scan.design_stats_blocks = _stage_a(
            design_scan.design_stats_blocks)
    if not getattr(adev.align_ops_batch_device, "_perfbench", False):
        adev.align_ops_batch_device = _gotoh(adev.align_ops_batch_device)


def load(out_dir):
    """-> (stage_a records, gotoh records): lists of dicts of arrays."""
    stage_a, gotoh = [], []
    if not os.path.isdir(out_dir):
        return stage_a, gotoh
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".npz"):
            continue
        with np.load(os.path.join(out_dir, name)) as z:
            rec = {k: z[k] for k in z.files}
        (stage_a if name.startswith("stage_a-") else gotoh).append(rec)
    return stage_a, gotoh


def cost(out_dir):
    """-> (seconds the workers spent recording, summed; bytes recorded)."""
    seconds = size = 0
    if not os.path.isdir(out_dir):
        return 0.0, 0
    for name in os.listdir(out_dir):
        path = os.path.join(out_dir, name)
        if name.endswith(".npz"):
            size += os.path.getsize(path)
        elif name.startswith("seconds-"):
            with open(path) as f:
                seconds += sum(float(x) for x in f.read().split())
    return seconds, size
