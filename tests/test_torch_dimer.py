"""The port's dimer matrix (ops/dimer.py) against the JAX package's, on the
CPU.

Same primers through both: the JAX functions correlate with
match_counts_conv on the CPU, the port with CPU tensors, which take the
plain version of the CUDA match-count kernel and run the verdict epilogue
as torch ops.  Matrices are booleans and must be equal exactly, to each
other and to the host search verify_against_host.
"""

import numpy as np
import pytest

from multiprime_tpu.ops import dimer as jd
from multiprime_tpu.utils import iupac
from multiprime_tpu_torch.ops import dimer as td


def _backend_primers():
    """The inputs of tests/test_backends.py test_dimer_matrix_matches_host:
    16 random 18-mers, one planted dimer (1 -> 2), one degenerate base."""
    rng = np.random.default_rng(9)
    lut = np.array(list("ACGT"))
    primers = ["".join(rng.choice(lut, size=18)) for _ in range(16)]
    primers[2] = primers[2][:6] + iupac.rc(primers[1][-12:])
    primers[5] = primers[5][:8] + "R" + primers[5][9:]
    return primers


def _fuzz_primers(seed):
    """Seeded degenerate primers of mixed lengths, three carrying the
    reverse complement of another primer's 3' end near their own."""
    rng = np.random.default_rng(500 + seed)
    lut = np.array(list("ACGT"))
    primers = []
    for _ in range(int(rng.integers(6, 14))):
        s = list(rng.choice(lut, size=int(rng.integers(12, 26))))
        for _ in range(int(rng.integers(0, 3))):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("RYSWKMN")))
        primers.append("".join(s))
    for _ in range(3):
        i, j = rng.integers(0, len(primers), size=2)
        k = int(rng.integers(5, 10))
        end = iupac.expand(primers[i][-k:])[0]
        # near the 3' end of primer j (small d2), where the loss triggers
        at = len(primers[j]) - k - int(rng.integers(0, 3))
        primers[j] = primers[j][:at] + iupac.rc(end) + primers[j][at + k:]
    return primers


CASES = {
    "backends": (_backend_primers, dict(threshold=3.96)),
    "backends_mixed_linear": (
        lambda: (_backend_primers()[:8]
                 + [p[:15] for p in _backend_primers()[8:12]]),
        dict(threshold=3.6, linear=True)),
}
CASES.update({"fuzz%d" % s: ((lambda s=s: _fuzz_primers(s)),
                             dict(threshold=(3.96, 3.6, 2.5)[s % 3],
                                  linear=bool(s % 2)))
              for s in range(4)})


@pytest.mark.parametrize("variant", ["dimer_hit_matrix",
                                     "dimer_hit_matrix_fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dimer_matrix_equals_jax_and_host(case, variant):
    make, kw = CASES[case]
    primers = make()
    want = getattr(jd, variant)(primers, **kw)
    got = getattr(td, variant)(primers, device="cpu", **kw)
    host = jd.verify_against_host(primers, **kw)
    assert got.dtype == bool and got.shape == (len(primers),) * 2
    assert np.array_equal(got, want)
    assert np.array_equal(got, host)
    assert np.array_equal(td.verify_against_host(primers, **kw), host)
    assert got.any()
    if case == "backends":
        assert got[1, 2]


@pytest.mark.parametrize("seed", range(2))
def test_fused_buckets_change_nothing(seed):
    """Small target and end buckets walk the bucket loops; the verdicts
    stay those of one bucket."""
    primers = _fuzz_primers(seed)
    whole = td.dimer_hit_matrix_fused(primers, device="cpu")
    cut = td.dimer_hit_matrix_fused(primers, device="cpu", t_bucket=7,
                                    e_bucket=33)
    batched = td.dimer_hit_matrix(primers, device="cpu", batch_patterns=5)
    assert np.array_equal(whole, cut) and np.array_equal(whole, batched)
    assert whole.any()


@pytest.mark.parametrize("kw", [dict(), dict(min_len=7, max_len=12),
                                dict(include_full=False)])
def test_ends_and_triggers_equal_jax(kw):
    for pr in ("ACGTRYACGTTGCA", "GGGCCCAANT", "ACG"):
        assert td.expanded_ends(pr, **kw) == jd.expanded_ends(pr, **kw)
    for end in ("ACGTG", "GCGCGCGCGC", "TATATATA", "AACGTTGCAAGT"):
        for linear in (False, True):
            assert np.array_equal(td._trigger_row(end, 20, 3.96, linear),
                                  jd._trigger_row(end, 20, 3.96, linear))


def test_fused_layout_matches_jax_padding():
    """The left-padded pattern one-hots and target masks of the fused path
    are the JAX package's one-hots, in mask form."""
    primers = _fuzz_primers(1)
    lay = td.fused_layout(primers)
    ends = [e for i, pr in enumerate(primers)
            for e in dict.fromkeys(jd.expanded_ends(pr))]
    assert len(ends) == lay["p1h"].shape[0]
    lp, z = lay["lp"], lay["z"]
    assert lp % 8 == 0 and z == lp - 5
    for k, e in enumerate(ends):
        want = np.zeros((lp, 4), np.uint8)
        want[lp - len(e):] = jd.ms.encode_primers([iupac.rc(e)])[0]
        assert np.array_equal(lay["p1h"][k], want)
    tgt = [t for pr in primers for t in iupac.expand(pr)]
    base = jd.ms.encode_targets(tgt)[0]
    masks = (base * np.array([1, 2, 4, 8])).sum(-1)
    assert np.array_equal(lay["masks"][:, z:z + base.shape[1]], masks)
    assert not lay["masks"][:, :z].any()


def test_fused_refuses_ends_past_64():
    with pytest.raises(ValueError, match="end_max_len"):
        td.dimer_hit_matrix_fused(["ACGT" * 17], device="cpu")
    short = td.dimer_hit_matrix_fused(["ACGT" * 17], device="cpu",
                                      end_max_len=40)
    assert short.shape == (1, 1)
