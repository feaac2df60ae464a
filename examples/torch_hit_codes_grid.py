"""Phase 2's hit_codes edge grid of chip_smoke.py, repeated, on a CUDA card.

Runs ``chip_smoke.edge_grid`` (seed 0: 192 cases of plen 8-63, P 1-745,
mm up to plen + 1, rows shorter than a tile) ``N`` times in one process,
each case's ``hit_codes`` against ``hit_codes_reference`` on the card,
and prints every case that differs (with whether the kernel and the plain
version each equal the plain version on the CPU), then the count of
differing cases.  A check for a fault that shows only now and then.

    python examples/torch_hit_codes_grid.py N     (from the repo root)
"""

import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
from multiprime_tpu_torch.ops import _cuda  # noqa: E402
from multiprime_tpu_torch.ops import mismatch_scan as ms  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    _cuda.build()
    t0 = time.time()
    bad = 0
    for it in range(int(sys.argv[1])):
        rng = np.random.default_rng(0)
        for plen, mm, term, n_pat, lo, hi in cs.edge_grid(rng):
            seqs = cs.random_seqs(rng, int(rng.integers(1, 40)), lo, hi,
                                  letters="ACGTacgtNRY-")
            p1h, s1h = cs.grid_patterns(ms, rng, seqs, n_pat, plen, term)
            masks, _ = ms.encode_target_masks(seqs)
            tm = torch.from_numpy(masks).to(dev)
            planes, sfx = ms.pack_patterns(p1h, s1h, device=dev)
            kw = dict(plen=plen, mm=mm, term=term)
            got = ms.hit_codes(tm, planes, sfx, **kw)
            want = ms.hit_codes_reference(tm, planes, sfx, **kw)
            torch.cuda.synchronize()
            if torch.equal(got, want):
                continue
            bad += 1
            cpu = ms.hit_codes_reference(tm.cpu(), planes.cpu(), sfx.cpu(),
                                         **kw)
            d = (got != want).nonzero()
            print("iteration %d plen=%d mm=%d term=%d N=%d L=%d P=%d: %d "
                  "codes differ; kernel == CPU plain %s, card plain == CPU "
                  "plain %s; first at %s: kernel %d, plain %d, CPU %d"
                  % (it, plen, mm, term, len(seqs), masks.shape[1],
                     planes.shape[0], len(d), torch.equal(got.cpu(), cpu),
                     torch.equal(want.cpu(), cpu), d[:5].tolist(),
                     got[tuple(d[0])].item(), want[tuple(d[0])].item(),
                     cpu[tuple(d[0].cpu())].item()), flush=True)
    print("iterations", sys.argv[1], "differing cases", bad, "seconds",
          time.time() - t0)


if __name__ == "__main__":
    main()
