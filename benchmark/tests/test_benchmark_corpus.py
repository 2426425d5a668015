"""The frozen generator against the port's bench corpus, and the traffic
mixes against the profiles their files state."""

import json

import numpy as np
import pytest

from benchmark import corpus, spec

# the port bench's genome and reads (lrge_tpu_torch/bench.py)
BENCH_TRAFFIC = {
    "genome": {
        "size": 4_400_000,
        "family": {"source": 100_000, "length": 2_000, "copies": 5, "first": 500_000, "stride": 700_000},
        "tandem": {"source": 200_000, "unit": 400, "copies": 5, "at": 300_000},
    },
    "reads": {"shape": 3.0, "mean": 2_500, "min": 500, "max": 30_000, "error": 0.05},
}
MIXES = ("r9_mtb", "q20_mtb", "hifi_cel")


def traffic(name):
    return json.loads((spec.HERE / "traffic" / f"{name}.json").read_text())


def test_the_bench_profile_at_seed_6_is_the_bench_corpus_byte_for_byte(monkeypatch):
    from lrge_tpu_torch import bench

    for var in ("BENCH_TARGETS", "BENCH_QUERIES", "BENCH_GENOME", "BENCH_ERR"):
        monkeypatch.delenv(var, raising=False)
    want = bench.make_corpus()
    got = corpus.make_corpus(BENCH_TRAFFIC, 10_000, 5_000, 6)
    assert got.genome_size == want.genome_size
    assert got.targets == want.targets
    assert got.queries == want.queries
    assert got.tnames == want.tnames and got.qnames == want.qnames


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3, -5])
def test_a_seed_gives_the_same_reads_and_another_seed_others(seed):
    small = traffic("q20_mtb")
    small["genome"]["size"] = 3_000_000
    a = corpus.make_corpus(small, 20, 10, seed)
    b = corpus.make_corpus(small, 20, 10, seed)
    c = corpus.make_corpus(small, 20, 10, seed + 1)
    assert a.targets == b.targets and a.queries == b.queries
    assert a.queries != c.queries


@pytest.mark.parametrize("name", MIXES)
def test_traffic_files_name_their_sources_assumptions_and_cuts(name):
    t = traffic(name)
    assert t["name"] == name
    for key in ("source", "assumed", "reduced"):
        assert t[key] and all(isinstance(line, str) and line for line in t[key])
    r = t["reads"]
    assert "error" not in r and r["insertion"] > 0 and r["deletion"] > 0 and r["substitution"] > 0
    assert 0.3 < t["genome"]["gc"] < 0.7 and t["genome"]["repeats"]


def test_hifi_cel_is_c_elegans_with_hifi_reads():
    t = traffic("hifi_cel")
    assert t["genome"]["size"] == 100_286_401
    r = t["reads"]
    assert r["mean"] == 13_500 and r["substitution"] + r["insertion"] + r["deletion"] == pytest.approx(0.002)
    share = sum(x["families"] * x["copies"] * x["length"] for x in t["genome"]["repeats"]) / t["genome"]["size"]
    assert share == pytest.approx(0.12, abs=0.005)


def test_a_read_carries_its_error_rates():
    """One long read of a genome of one base: its length gives the
    indels, its other bases the substitutions and insertions."""
    L = 200_000
    reads = {"shape": 3.0, "mean": L, "min": L, "max": L, "substitution": 0.02, "insertion": 0.01, "deletion": 0.03}
    (read,) = corpus.make_reads(corpus.rng_for(17), b"A" * (L + 1), 1, reads)
    major = max(read.count(b"A"), read.count(b"T"))
    assert len(read) / L == pytest.approx(1 - 0.03 + 0.01, abs=0.002)
    # substitutions of the bases kept, three quarters of the insertions
    assert (len(read) - major) / L == pytest.approx(0.02 * 0.97 + 0.01 * 0.75, abs=0.002)


def test_the_genome_has_its_gc_share_and_its_repeat_copies():
    g = {"size": 400_000, "gc": 0.65, "repeats": [{"families": 1, "length": 1_355, "copies": 16, "divergence": 0.0}]}
    genome = corpus.make_genome(corpus.rng_for(17), g)
    assert len(genome) == 400_000
    assert (genome.count(b"G") + genome.count(b"C")) / len(genome) == pytest.approx(0.65, abs=0.005)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    k, seen = 24, {}
    for i in range(len(genome) - k + 1):
        w = genome[i : i + k]
        w = min(w, w.translate(rc)[::-1])
        seen[w] = seen.get(w, 0) + 1
    counts = np.array(list(seen.values()))
    # the family's 1,332 words, each in its 16 copies (fewer where a copy overwrote another)
    assert counts.max() <= 16 and (counts >= 12).sum() >= 1_000 and (counts >= 2).sum() < 1_500
