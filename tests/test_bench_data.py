"""The synthetic data behind bench.py and chip_smoke.py: sorted-by-
construction tables, unions without a full sort, and read sampling."""

import os
import sys

import numpy as np
import pytest

from kmer_denovo_filter_tpu import kmer as K
from kmer_denovo_filter_tpu.ops import encode as enc

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import bench  # noqa: E402


@pytest.mark.parametrize("k", [17, 31, 63, 101])
def test_gap_keys_sorted_unique_valid(k):
    keys = bench.gap_keys(np.random.default_rng(k), 5000, k)
    w = enc.words_per_kmer(k)
    assert keys.shape == (5000, w) and keys.dtype == np.uint32
    order = enc.lexsort_keys(keys)
    assert np.array_equal(order, np.arange(5000))  # sorted already
    assert len(np.unique(keys, axis=0)) == 5000
    rem = (2 * k) % 32
    if rem:  # 2k bits left-aligned: the low bits are clear
        assert not (keys[:, -1] & np.uint32((1 << (32 - rem)) - 1)).any()


@pytest.mark.parametrize("k", [31, 63])
def test_key_view_orders_like_words(k):
    keys = bench.gap_keys(np.random.default_rng(1), 400, k)
    shuffled = keys[np.random.default_rng(2).permutation(400)]
    view = bench.key_view(shuffled)
    assert np.array_equal(shuffled[np.argsort(view, kind="stable")], keys)


def test_union_sorted_inserts_without_duplicates():
    rng = np.random.default_rng(4)
    a = bench.gap_keys(rng, 1000, 31)
    b = np.concatenate([a[::7], bench.gap_keys(rng, 300, 31)])
    b = b[enc.lexsort_keys(b)]
    b = np.unique(b, axis=0)
    got = bench.union_sorted(a, b)
    want = np.unique(np.concatenate([a, b]), axis=0)
    assert np.array_equal(got, want)


def test_table_keys_hold_genome_kmers():
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    gk = bench.genome_keys(genome, 100, 2000, 31)
    keys = bench.table_keys(rng, 4096, gk, 31)
    assert len(keys) <= 4096
    assert np.array_equal(keys, np.unique(keys, axis=0))
    hit = np.isin(bench.key_view(gk), bench.key_view(keys))
    assert 0.4 < hit.mean() < 0.6  # half the genome's k-mers


def test_genome_keys_match_string_oracle():
    rng = np.random.default_rng(6)
    genome = rng.integers(0, 4, 300, dtype=np.uint8)
    got = bench.genome_keys(genome, 10, 200, 21)
    seq = "".join("ACGT"[c] for c in genome[10:210])
    want = sorted(set(K.extract_read_kmers(seq, 21)[0].values()))
    assert enc.keys_to_kmers(got, 21) == want


def test_synth_reads_are_position_local():
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 1 << 16, dtype=np.uint8)
    reads = bench.synth_reads(rng, genome, 512, 152, start0=1000)
    assert reads.shape == (512, 152) and reads.max() <= 3
    span = bench.read_span(512, 152)
    # every read matches the genome within the span at ≤ a few errors
    for r in reads[:32]:
        best = min((genome[s:s + 152] != r).sum()
                   for s in range(1000, 1000 + span))
        assert best <= 6
