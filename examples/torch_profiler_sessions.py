"""torch.profiler sessions in one process on a CUDA card: how many see no
device events.

Runs a loop of sessions of one ``find_hits`` call (64 x 1,024 targets, 96
patterns), with chip_smoke.py's two kinds of session: ``P`` is
``device_profile`` (CPU and CUDA activities), ``K`` is ``kernel_breakdown``
(CUDA alone); ``S`` starts and ends another CUDA process between two
sessions.  Prints each session with ``+`` where it saw device events and
``-`` where it saw none, then the count of misses.  Each mode runs in a
process of its own.  The modes:

    A  PK x 30     B  KP x 30     C  P x 60     D  K x 60
    E  KPS x 15    F  PKKKKKK x 8

    python examples/torch_profiler_sessions.py [MODE ...]   (from the repo root)
"""

import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
from multiprime_tpu_torch.ops import mismatch_scan as ms  # noqa: E402

MODES = {"A": "PK" * 30, "B": "KP" * 30, "C": "P" * 60, "D": "K" * 60,
         "E": "KPS" * 15, "F": "PKKKKKK" * 8}
OTHER = "import torch; torch.zeros(1, device='cuda').sum().item()"


def run(mode, call):
    marks = []
    for c in MODES[mode]:
        if c == "S":
            subprocess.run([sys.executable, "-c", OTHER], check=True)
            continue
        prof = cs.device_profile if c == "P" else cs.kernel_breakdown
        marks.append(c + ("-" if prof(call) is None else "+"))
    misses = sum(m.endswith("-") for m in marks)
    print("mode %s: %d of %d sessions saw no device events: %s"
          % (mode, misses, len(marks), " ".join(marks)), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    modes = sys.argv[1:] or sorted(MODES)
    if len(modes) > 1:
        for mode in modes:
            subprocess.run([sys.executable, __file__, mode], check=True)
        return
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n, length, p, plen = 64, 1024, 96, 18
    masks = torch.from_numpy(
        (1 << rng.integers(0, 4, (n, length))).astype(np.uint8)).to(dev)
    lens = torch.full((n,), length, dtype=torch.int32, device=dev)
    p1h = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (p, plen))]
    planes, sfx = ms.pack_patterns(p1h, p1h.copy(), device=dev)

    def call():
        return ms.find_hits(masks, lens, planes, sfx, plen=plen, mm=3,
                            term=0, max_hits=1 << 12)
    run(modes[0], call)


if __name__ == "__main__":
    main()
