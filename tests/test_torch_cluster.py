"""The port's greedy identity clustering (multiprime_tpu_torch/cluster/
greedy.py) against the JAX package's, on genome-length sequences where the
word filter passes unrelated representatives, so a query is aligned
against several: the candidates aligned on a thread pool give the serial
walk's clusters."""

import numpy as np
import pytest

from multiprime_tpu.cluster import greedy as jgreedy
from multiprime_tpu_torch import native as tnative
from multiprime_tpu_torch.cluster import greedy as tgreedy
from multiprime_tpu_torch.ops import _cuda


def _genomes(seed=41, families=2, members=10, singletons=4):
    """Families of 8.2-8.4 kb genomes with 3% substitutions and a few
    deletions, then random singletons of the same lengths."""
    rng = np.random.default_rng(seed)
    lut = np.array(list("ACGT"))
    seqs = []
    for _ in range(families):
        length = int(rng.integers(8200, 8400))
        base = rng.integers(0, 4, size=length)
        for _ in range(members):
            s = base.copy()
            hit = rng.random(length) < 0.03
            s[hit] = rng.integers(0, 4, size=int(hit.sum()))
            s = np.delete(s, rng.integers(0, length, size=int(
                rng.integers(0, 12))))
            seqs.append("".join(lut[s]))
    for _ in range(singletons):
        seqs.append("".join(lut[rng.integers(0, 4, size=int(
            rng.integers(8200, 8400)))]))
    return [str(i) for i in range(len(seqs))], seqs


def _clusters(clusters):
    return [(cl.rep_index, cl.members) for cl in clusters]


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_greedy_cluster_threads_equal_jax(threads, monkeypatch):
    """The port's clusters at 1, 3 and 8 threads equal the JAX package's
    serial ones, identities included, and the queries met more candidate
    representatives than one each."""
    assert tnative.available()
    ids, seqs = _genomes()
    want_order, want = jgreedy.greedy_cluster(ids, seqs)
    calls = []
    orig = tnative.banded_identity

    def counted(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(tnative, "banded_identity", counted)
    order, got = tgreedy.greedy_cluster(ids, seqs, threads=threads)
    assert order == want_order
    assert _clusters(got) == _clusters(want)
    assert len(got) == 2 + 4
    assert len(calls) > len(seqs)


def _cds(seed=7, families=3, members=12, singletons=4):
    """CDS-length families (850-950 bp, 3% substitutions, a few deletions)
    and random singletons, then a founder the word filter passes but no
    representative takes (a fifth of the first family's base, the rest
    random)
    and an exact copy of it, then one more family member: the window that
    the founder ends throws the copy and the member away."""
    rng = np.random.default_rng(seed)
    lut = np.array(list("ACGT"))
    seqs, bases = [], []
    for _ in range(families):
        base = rng.integers(0, 4, size=int(rng.integers(850, 950)))
        bases.append(base)
        for _ in range(members):
            s = base.copy()
            hit = rng.random(len(s)) < 0.03
            s[hit] = rng.integers(0, 4, size=int(hit.sum()))
            s = np.delete(s, rng.integers(0, len(s), size=int(
                rng.integers(0, 6))))
            seqs.append("".join(lut[s]))
    for _ in range(singletons):
        seqs.append("".join(lut[rng.integers(0, 4, size=int(
            rng.integers(850, 950)))]))
    fifth = len(bases[0]) // 5
    founder = np.concatenate([bases[0][:fifth], rng.integers(
        0, 4, size=len(bases[0]) - fifth)])
    seqs += ["".join(lut[founder])] * 2 + [seqs[1]]
    return [str(i) for i in range(len(seqs))], seqs


def _walk_counts(monkeypatch):
    """The identity.* counts the windowed walk takes, summed."""
    from multiprime_tpu_torch.utils import trace
    counts = {}

    def count(key, n=1):
        counts[key] = counts.get(key, 0) + n
    monkeypatch.setattr(trace, "count", count)
    return counts


@pytest.mark.parametrize("corpus,window", [
    ("genomes", 10 ** 6), ("cds", 1), ("cds", 3), ("cds", 10 ** 6)])
def test_windowed_walk_equals_jax(corpus, window, monkeypatch):
    """The windowed walk on the plain version (device="cpu") gives the JAX
    package's clusters, identities included: 8.3 kb genomes with
    singletons, whose founders meet candidates, so windows end early and
    their queries are replayed; CDS families with one query a window (W =
    1), a few, and one window larger than the corpus; a founder whose
    window ends at it, and its exact copy placed by the hash in the next
    window."""
    monkeypatch.setattr(tgreedy, "_WINDOW_PAIRS", window)
    if corpus == "genomes":
        ids, seqs = _genomes(families=2, members=3, singletons=2)
    else:
        ids, seqs = _cds()
    want_order, want = jgreedy.greedy_cluster(ids, seqs)
    counts = _walk_counts(monkeypatch)
    order, got = tgreedy.greedy_cluster_windows(ids, seqs, threads=2,
                                                device="cpu")
    assert order == want_order
    assert _clusters(got) == _clusters(want)
    assert counts["identity.launches"] > 0
    assert counts.get("identity.host_pairs", 0) == 0
    assert counts["identity.windows"] >= counts["identity.launches"]
    if window == 1:
        # one query with candidates a window: nothing is thrown away
        assert counts.get("identity.replayed", 0) == 0
    else:
        assert counts["identity.replayed"] > 0
        assert counts["identity.replayed_pairs"] > 0
    if corpus == "cds":
        # the founder's copy joins it through the exact hash
        founder = next(cl for cl in got if cl.rep_index == len(seqs) - 3)
        assert founder.members == [(len(seqs) - 3, None),
                                   (len(seqs) - 2, 1.0)]


def test_serial_walk_counts_its_host_pairs(monkeypatch):
    """The host side of the job's choice, the serial walk, gives JAX's
    clusters and counts the pairs it aligns natively; no launch."""
    ids, seqs = _cds(seed=11)
    want_order, want = jgreedy.greedy_cluster(ids, seqs)
    counts = _walk_counts(monkeypatch)
    order, got = tgreedy.greedy_cluster(ids, seqs, threads=3)
    assert order == want_order
    assert _clusters(got) == _clusters(want)
    assert counts["identity.host_pairs"] >= len(seqs) - len(got) - 1
    assert "identity.launches" not in counts


def _pairs_meta(seqs, pairs):
    offs = np.cumsum([0] + [len(s) for s in seqs])[:-1]
    return np.array([[offs[q] for q, _ in pairs],
                     [len(seqs[q]) for q, _ in pairs],
                     [offs[r] for _, r in pairs],
                     [len(seqs[r]) for _, r in pairs]], np.int64)


def test_plain_identities_equal_native_and_numpy():
    """The plain batched identities equal native's and the JAX package's
    NumPy banded_identity on random pairs: an empty sequence, lengths that
    differ by more than the band, N codes, the longer one first, related
    pairs at several divergences."""
    import torch

    from multiprime_tpu_torch.cluster import identity
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 5, size=n).astype(np.int8)
            for n in (0, 1, 5, 64, 65, 100, 240, 330)]
    base = rng.integers(0, 4, size=300).astype(np.int8)
    for div in (0.0, 0.05, 0.3):
        s = base.copy()
        hit = rng.random(300) < div
        s[hit] = rng.integers(0, 5, size=int(hit.sum()))
        seqs.append(np.delete(s, rng.integers(0, 300, size=4)))
    seqs.append(base)
    pairs = [(q, r) for q in range(len(seqs)) for r in range(len(seqs))]
    assert all(identity.kernel_takes(len(seqs[q]), len(seqs[r]), 64)
               for q, r in pairs)
    meta = _pairs_meta(seqs, pairs)
    got = identity.identities(identity.banded_matches(
        torch.from_numpy(np.concatenate(seqs)), meta, 64).numpy(), meta)
    want = [tnative.banded_identity(seqs[q], seqs[r], 64) for q, r in pairs]
    assert got == want
    assert want == [jgreedy.banded_identity(seqs[q], seqs[r], 64)
                    for q, r in pairs]
    assert {0.0, 1.0} <= set(got) and len(set(got)) > 20


@pytest.mark.parametrize("la,bits", [(16383, 32), (16384, 64)])
def test_plain_identities_at_the_32bit_key_limit(la, bits):
    """On both sides of the 32-bit key's limit the plan takes the key width
    the lengths give, and the plain version, in that width, equals
    native."""
    import torch

    from multiprime_tpu_torch.cluster import identity
    rng = np.random.default_rng(la)
    a = rng.integers(0, 4, size=la).astype(np.int8)
    b = a.copy()
    hit = rng.random(la) < 0.1
    b[hit] = rng.integers(0, 5, size=int(hit.sum()))
    b = np.concatenate([b[:la // 2], b[la // 2 + 20:],
                        rng.integers(0, 4, size=50).astype(np.int8)])
    meta = _pairs_meta([a, b], [(0, 1)])
    assert identity.identity_plan(meta[1], meta[3], 64)[1] == bits
    got = identity.banded_matches(torch.from_numpy(np.concatenate([a, b])),
                                  meta, 64).numpy()
    assert identity.identities(got, meta) == [
        tnative.banded_identity(a, b, 64)]


def test_plain_identities_on_wide_bands():
    """Pairs whose lengths differ by more than the register kernel's
    widest band (|lb - la| > 895 at band 64: a partial genome beside a
    complete one) equal native, related and not, in both key widths."""
    import torch

    from multiprime_tpu_torch.cluster import identity
    rng = np.random.default_rng(5)
    full = rng.integers(0, 4, size=3000).astype(np.int8)
    part = full[400:1900].copy()
    hit = rng.random(len(part)) < 0.05
    part[hit] = rng.integers(0, 5, size=int(hit.sum()))
    long = rng.integers(0, 4, size=17500).astype(np.int8)
    seqs = [full, part, rng.integers(0, 4, size=1200).astype(np.int8),
            full[:2104].copy(), long, long[600:17000].copy()]
    cd = torch.from_numpy(np.concatenate(seqs))
    got, want = [], []
    for pairs, bits in (([(1, 0), (0, 1), (2, 0), (3, 0), (2, 4)], 32),
                        ([(5, 4)], 64)):
        meta = _pairs_meta(seqs, pairs)
        assert (identity._width(meta[1], meta[3], 64)
                > identity._MAX_WIDTH).all()
        assert identity.identity_plan(meta[1], meta[3], 64)[1] == bits
        got += identity.identities(identity.banded_matches(
            cd, meta, 64).numpy(), meta)
        want += [tnative.banded_identity(seqs[q], seqs[r], 64)
                 for q, r in pairs]
    assert got == want
    assert len(set(want)) >= 4


def test_identity_plan_and_kernel_limits():
    """The plan's cells a lane follow the widest band, None past 32 x 32
    cells (the wide kernel); the kernels take any band and refuse keys past
    native's packing (sequences past about 524 kb)."""
    from multiprime_tpu_torch.cluster import identity
    assert identity.identity_plan([900], [900], 64)[:2] == (8, 32)
    assert identity.identity_plan([8200], [8400], 64)[:2] == (12, 32)
    assert identity.identity_plan([100, 100], [100, 995], 64)[0] == 32
    assert identity.identity_plan([100, 100], [100, 996], 64)[0] is None
    assert identity.kernel_takes(100, 996, 64)
    assert identity.kernel_takes(524213, 524213, 64)
    assert not identity.kernel_takes(524214, 524214, 64)
    assert not identity.kernel_takes(10, 600000, 64)


@pytest.mark.parametrize("forced,n,length,want", [
    ("host", 5000, 8300, "host"), ("device", 3, 900, "device"),
    (None, 100, 900, "host"), (None, 4000, 900, "device"),
    (None, 40, 8300, "host"), (None, 1000, 8300, "device")])
def test_resolve_clustering_follows_the_estimate(forced, n, length, want,
                                                 monkeypatch):
    """MPTPU_FORCE_BACKEND decides where set; else the measured rates, with
    a cold card's start-up charged once a job: a hundred CDS or forty
    genomes stay on the host, thousands of CDS or a thousand genomes (the
    word filter passing unrelated ones) go to the card."""
    from multiprime_tpu_torch.cluster import identity
    from multiprime_tpu_torch.utils import link
    if forced:
        monkeypatch.setenv("MPTPU_FORCE_BACKEND", forced)
    else:
        monkeypatch.delenv("MPTPU_FORCE_BACKEND", raising=False)
    monkeypatch.setattr(link, "device_startup_s", lambda **kw: (
        link.RATES["cuda_init_s"] + link.RATES["kernel_load_s"]))
    assert identity.resolve_clustering([length] * n, 8) == want


def test_cluster_stage_places_the_job_once(tmp_path, monkeypatch):
    """`run`'s cluster stage on a CPU device: unforced, the serial walk
    (host pairs, no window); forced to the device, the windowed walk on
    the plain version (windows, no host pair), the same .clstr; a forced
    device refuses a sequence past the kernels' keys."""
    from multiprime_tpu_torch.pipeline import driver
    ids, seqs = _cds(seed=13, families=2, members=6, singletons=2)
    fa = tmp_path / "in.fa"
    fa.write_text("".join(">%s\n%s\n" % p for p in zip(ids, seqs)))
    pipe = driver.Pipeline(driver.PipelineConfig(
        results_dir=str(tmp_path / "res"), device="cpu"))
    launched = _cuda.launches()
    got = {}
    for side in (None, "device"):
        if side:
            monkeypatch.setenv("MPTPU_FORCE_BACKEND", side)
        else:
            monkeypatch.delenv("MPTPU_FORCE_BACKEND", raising=False)
        counts = _walk_counts(monkeypatch)
        out = tmp_path / ("%s.fa" % side)
        pipe._cluster(str(fa), str(out))
        got[side] = (out.with_suffix(".fa.clstr").read_text(), counts)
    assert got[None][0] == got["device"][0]
    assert got[None][1]["identity.host_pairs"] > 0
    assert "identity.windows" not in got[None][1]
    assert got["device"][1]["identity.windows"] > 0
    assert "identity.host_pairs" not in got["device"][1]
    assert _cuda.launches() == launched
    fa.write_text(">long\n%s\n" % ("ACGT" * 131072 + "A" * 10))
    with pytest.raises(ValueError, match="MPTPU_FORCE_BACKEND=host"):
        pipe._cluster(str(fa), str(tmp_path / "long.fa"))
