"""Sharded engine tests on the 8-device virtual CPU mesh."""

import random
from collections import Counter

import numpy as np
import pytest

import jax

from kmer_denovo_filter_tpu import kmer as K
from kmer_denovo_filter_tpu.ops import encode as enc
from kmer_denovo_filter_tpu.parallel import (
    ShardedKmerIndex,
    make_mesh,
    sharded_count,
)
from tests.test_engine import oracle_counts, pack_reads, random_reads

needs_mesh = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple devices")


@needs_mesh
def test_sharded_membership_matches_oracle():
    k = 31
    mesh = make_mesh()
    table_reads = random_reads(30, k, with_n=False, seed=1)
    table_set = set()
    for s in table_reads:
        cap, _ = K.extract_read_kmers(s, k)
        table_set.update(cap.values())
    keys = enc.kmers_to_keys(sorted(table_set), k)
    idx = ShardedKmerIndex(keys, k, mesh)

    query_reads = random_reads(20, k, with_n=False, seed=2) + table_reads[:3]
    queries = []
    for s in query_reads:
        cap, _ = K.extract_read_kmers(s, k)
        queries.extend(cap.values())
    qk = enc.kmers_to_keys(queries, k)
    got = idx.membership(qk)
    expected = [q in table_set for q in queries]
    assert got.tolist() == expected


@needs_mesh
def test_sharded_tally_matches_filtered_count():
    k = 31
    mesh = make_mesh()
    stream = random_reads(40, k, with_n=False, seed=3)
    filter_reads = stream[:5] + random_reads(10, k, with_n=False, seed=4)
    filter_set = set()
    for s in filter_reads:
        cap, _ = K.extract_read_kmers(s, k)
        filter_set.update(cap.values())
    sorted_kmers = sorted(filter_set)
    keys = enc.kmers_to_keys(sorted_kmers, k)
    idx = ShardedKmerIndex(keys, k, mesh)

    # feed window keys of the stream in two batches
    from kmer_denovo_filter_tpu.ops import device as dev
    import jax.numpy as jnp
    for half in (stream[:20], stream[20:]):
        batch, lens = pack_reads(half)
        wkeys, _ = dev.extract_canonical_windows(
            jnp.asarray(batch), jnp.asarray(lens), k)
        flat = np.asarray(wkeys).reshape(-1, wkeys.shape[-1])
        idx.tally_batch(flat)
    res = idx.tally_result()

    oc = Counter()
    for s in stream:
        cap, _ = K.extract_read_kmers(s, k)
        for c in cap.values():
            if c in filter_set:
                oc[c] += 1
    got = {s: int(c) for s, c in zip(sorted_kmers, res) if c > 0}
    assert got == dict(oc)


@needs_mesh
def test_sharded_count_matches_oracle():
    k = 31
    mesh = make_mesh()
    reads = random_reads(64, k, seed=5)
    oc = oracle_counts(reads, k)
    batch, lens = pack_reads(reads)
    keys, counts = sharded_count(batch, lens, k, mesh)
    got = dict(zip(enc.keys_to_kmers(keys, k), counts.tolist()))
    assert got == dict(oc)


@needs_mesh
def test_owner_distribution_roughly_uniform():
    import jax.numpy as jnp

    from kmer_denovo_filter_tpu.parallel.sharded import hash_owner
    k = 31
    reads = random_reads(200, k, with_n=False, seed=6)
    kmers = sorted({c for s in reads
                    for c in K.extract_read_kmers(s, k)[0].values()})
    keys = jnp.asarray(enc.kmers_to_keys(kmers, k))
    owners = np.asarray(hash_owner(keys, 8))
    counts = np.bincount(owners, minlength=8)
    assert counts.min() > 0.5 * counts.mean()
    assert counts.max() < 1.5 * counts.mean()


@needs_mesh
def test_sharded_filtered_counter():
    """Full multi-chip --if analog: extract + route + owner tally."""
    from kmer_denovo_filter_tpu.parallel.sharded import (
        ShardedFilteredCounter,
    )
    k = 31
    mesh = make_mesh()
    stream = random_reads(40, k, with_n=False, seed=81)
    filter_reads = stream[:6] + random_reads(12, k, with_n=False, seed=82)
    filter_set = set()
    for s in filter_reads:
        cap, _ = K.extract_read_kmers(s, k)
        filter_set.update(cap.values())
    sorted_kmers = sorted(filter_set)
    keys = enc.kmers_to_keys(sorted_kmers, k)
    fc = ShardedFilteredCounter(keys, k, mesh)
    batch, lens = pack_reads(stream)
    fc.feed(batch[:20], lens[:20])
    fc.feed(batch[20:], lens[20:])
    res = fc.result()
    oc = Counter()
    for s in stream:
        cap, _ = K.extract_read_kmers(s, k)
        for c in cap.values():
            if c in filter_set:
                oc[c] += 1
    got = {s: int(c) for s, c in zip(sorted_kmers, res) if c > 0}
    assert got == dict(oc)


def test_discovery_parent_filter_sharded(tmp_path, monkeypatch):
    """KDF_SHARDED=1 routes the discovery parent filter through the
    mesh counter and matches the single-device result."""
    import numpy as np

    from kmer_denovo_filter_tpu import engine as eng
    from kmer_denovo_filter_tpu.discovery.pipeline import (
        _count_parent_device)
    from tests.helpers import create_bam, create_ref_fasta

    ref = str(tmp_path / "r.fa")
    seq = create_ref_fasta(ref, "chr1", 400)
    bam = str(tmp_path / "p.bam")
    create_bam(bam, "chr1",
               [(f"p{i}", 10 * i, seq[10 * i:10 * i + 90])
                for i in range(25)], ref_length=400)
    from kmer_denovo_filter_tpu import kmer as K
    kmers = set()
    cap, _ = K.extract_read_kmers(seq[50:200], 31)
    kmers.update(cap.values())
    keys = enc.kmers_to_keys(sorted(kmers), 31)
    single = _count_parent_device(bam, keys, 31, "single")
    monkeypatch.setenv("KDF_SHARDED", "1")
    sharded = _count_parent_device(bam, keys, 31, "sharded")
    assert np.array_equal(single, sharded)


@needs_mesh
def test_sharded_count_homopolymer_overflow_retry():
    """All-identical keys route to ONE owner shard; the default
    per-shard route capacity overflows and sharded_count must retry at
    doubled capacity instead of silently undercounting (every window
    of a homopolymer batch is the same canonical k-mer)."""
    k = 7
    mesh = make_mesh()
    reads = ["A" * 64] * 64
    codes, lengths = pack_reads(reads)
    keys, counts = sharded_count(codes, lengths, k, mesh,
                                 cap_per_shard=16)
    expected = oracle_counts(reads, k)
    got = {enc.keys_to_kmers(keys[i:i + 1], k)[0]: int(counts[i])
           for i in range(keys.shape[0])}
    assert got == dict(expected)


@needs_mesh
def test_sharded_filtered_counter_device_feed_parity():
    """Device-side sharded feed (no host round-trip of window keys)
    must match the single-device FilteredCounter exactly."""
    from kmer_denovo_filter_tpu import engine as eng
    from kmer_denovo_filter_tpu.parallel import ShardedFilteredCounter

    k = 31
    table_reads = random_reads(40, 64, with_n=False, seed=11)
    kmers = sorted({km for s in table_reads
                    for km in oracle_counts([s], k)})
    keys = enc.kmers_to_keys(kmers, k)
    index = eng.KmerIndex(keys, k)

    reads = random_reads(60, 64, seed=12) + table_reads[:10]
    codes, lengths = pack_reads(reads)

    single = eng.FilteredCounter(index)
    single.feed(codes, lengths)
    expected = single.result()

    sharded = ShardedFilteredCounter(keys, k, make_mesh())
    sharded.feed(codes, lengths)
    got = sharded.result()
    assert np.array_equal(got, expected)
    assert expected.sum() > 0


@needs_mesh
def test_sharded_scan_reads_for_hits_parity():
    from kmer_denovo_filter_tpu import engine as eng
    from kmer_denovo_filter_tpu.parallel import (
        ShardedKmerIndex,
        sharded_scan_reads_for_hits,
    )

    k = 31
    table_reads = random_reads(40, 64, with_n=False, seed=13)
    kmers = sorted({km for s in table_reads
                    for km in oracle_counts([s], k)})
    keys = enc.kmers_to_keys(kmers, k)
    index = eng.KmerIndex(keys, k)

    reads = random_reads(50, 64, seed=14) + table_reads[:8]
    codes, lengths = pack_reads(reads)

    expected = eng.scan_reads_for_hits(index, codes, lengths)
    sharded = ShardedKmerIndex(keys, k, make_mesh())
    got = sharded_scan_reads_for_hits(sharded, codes, lengths)
    assert got.shape == expected.shape
    assert np.array_equal(got, expected)
    assert expected.any()


@needs_mesh
def test_make_scanner_sharded_dispatch(monkeypatch):
    """KDF_SHARDED=1 routes the anchoring scan through the mesh with
    identical results; KDF_SHARDED=0 never shards."""
    from kmer_denovo_filter_tpu import engine as eng

    k = 31
    table_reads = random_reads(30, 64, with_n=False, seed=15)
    kmers = sorted({km for s in table_reads
                    for km in oracle_counts([s], k)})
    index = eng.KmerIndex(enc.kmers_to_keys(kmers, k), k)
    reads = random_reads(20, 64, seed=16) + table_reads[:5]
    codes, lengths = pack_reads(reads)

    monkeypatch.setenv("KDF_SHARDED", "0")
    base = eng.make_scanner(index)(codes, lengths)
    monkeypatch.setenv("KDF_SHARDED", "1")
    sharded = eng.make_scanner(index)(codes, lengths)
    assert np.array_equal(base, sharded)


def test_sharded_filtered_counter_deferred_overflow_replay():
    """A tiny route capacity forces overflow; the deferred resolution
    (settled at the next feed / result) must replay exactly."""
    from kmer_denovo_filter_tpu.parallel.sharded import (
        ShardedFilteredCounter,
    )
    k = 31
    mesh = make_mesh()
    # homopolymer reads: every window is ONE key, so all route traffic
    # converges on a single owner shard and overflows a small cap
    stream = ["A" * 60] * 16
    cap_map, _ = K.extract_read_kmers(stream[0], k)
    keys = enc.kmers_to_keys(sorted(set(cap_map.values())), k)
    fc = ShardedFilteredCounter(keys, k, mesh)
    batch, lens = pack_reads(stream)
    fc.feed(batch[:8], lens[:8], slack=0.01)
    assert fc._pending is not None  # sync deferred, not yet settled
    fc.feed(batch[8:], lens[8:], slack=0.01)
    res = fc.result()
    assert fc._pending is None
    total = int(res.sum())
    assert total == 16 * (60 - k + 1)  # every valid window tallied


# ── routed sharded engine: wide keys, dispatch, route overflow ──────

def _table_keys(n_reads, k, seed, read_len=64):
    reads = random_reads(n_reads, read_len, with_n=False, seed=seed)
    kmers = sorted({km for s in reads for km in oracle_counts([s], k)})
    return enc.kmers_to_keys(kmers, k), reads


@needs_mesh
@pytest.mark.parametrize("k", [33, 63, 101])
def test_sharded_filtered_counter_wide_matches_oracle(k):
    """W ≥ 3 keys through the routed shard_map tally, two feeds."""
    from kmer_denovo_filter_tpu.parallel import ShardedFilteredCounter
    from tests.test_engine import _expected_tally

    keys, table_reads = _table_keys(30, k, seed=k, read_len=96)
    batch = random_reads(20, 96, seed=k + 1) + table_reads[:6]
    codes, lengths = pack_reads(batch)
    fc = ShardedFilteredCounter(keys, k, make_mesh())
    fc.feed(codes, lengths)
    fc.feed(codes, lengths)
    got = fc.result()
    expected = _expected_tally(batch, keys, k) * 2
    assert np.array_equal(got, expected)
    assert expected.sum() > 0


@needs_mesh
@pytest.mark.parametrize("k", [33, 63, 101])
def test_sharded_scan_wide_parity(k):
    """W ≥ 3 routed member scan equals the single-device scan."""
    from kmer_denovo_filter_tpu import engine as eng
    from kmer_denovo_filter_tpu.parallel import (
        sharded_scan_reads_for_hits,
    )

    keys, table_reads = _table_keys(30, k, seed=k + 7, read_len=96)
    index = eng.KmerIndex(keys, k)
    batch = random_reads(20, 96, seed=k + 8) + table_reads[:6]
    codes, lengths = pack_reads(batch)
    expected = eng.scan_reads_for_hits(index, codes, lengths)
    got = sharded_scan_reads_for_hits(ShardedKmerIndex(keys, k,
                                                       make_mesh()),
                                      codes, lengths)
    assert np.array_equal(got, expected)
    assert expected.any()


@needs_mesh
def test_sharded_counter_route_overflow_retry():
    """A homopolymer batch routes every window to one owner shard,
    overflowing the default route capacity; the deferred replay at
    doubled capacity must count exactly."""
    from kmer_denovo_filter_tpu.parallel import ShardedFilteredCounter
    from tests.test_engine import _expected_tally

    k = 31
    batch = ["A" * 64] * (4 * len(jax.devices()))
    keys = enc.kmers_to_keys(sorted(oracle_counts(batch, k)), k)
    codes, lengths = pack_reads(batch)
    fc = ShardedFilteredCounter(keys, k, make_mesh())
    fc.feed(codes, lengths)
    assert bool(np.asarray(fc._pending[3]).any())  # route overflowed
    got = fc.result()
    assert np.array_equal(got, _expected_tally(batch, keys, k))


@needs_mesh
@pytest.mark.parametrize("k", [31, 33])
def test_routed_dispatch_from_engine(monkeypatch, k):
    """KDF_SHARDED=1 routes both engine factories through the routed
    mesh engine with results equal to one device; =0 never shards."""
    from kmer_denovo_filter_tpu import engine as eng
    from kmer_denovo_filter_tpu.parallel import ShardedFilteredCounter

    keys, table_reads = _table_keys(20, k, seed=48 + k)
    index = eng.KmerIndex(keys, k)
    codes, lengths = pack_reads(random_reads(10, 64, seed=49)
                                + table_reads[:4])
    monkeypatch.setenv("KDF_SHARDED", "0")
    single = eng.make_filtered_counter(index)
    assert type(single) is eng.FilteredCounter
    single.feed(codes, lengths)
    base_scan = eng.make_scanner(index)(codes, lengths)
    monkeypatch.setenv("KDF_SHARDED", "1")
    for fc in (eng.make_filtered_counter(index),
               eng.make_parent_filter_counter(keys, k)):
        assert isinstance(fc, ShardedFilteredCounter)
        fc.feed(codes, lengths)
        assert np.array_equal(fc.result(), single.result())
    assert np.array_equal(eng.make_scanner(index)(codes, lengths),
                          base_scan)


@needs_mesh
def test_sharded_stream_counter_matches_oracle(monkeypatch):
    from kmer_denovo_filter_tpu import engine as eng

    k = 31
    reads = random_reads(50, 64, seed=51)
    expected = oracle_counts(reads, k)
    codes, lens = pack_reads(reads)
    sc = eng.ShardedStreamCounter(k, make_mesh())
    sc.feed(codes[:30], lens[:30])
    sc.feed(codes[30:], lens[30:])
    keys, counts = sc.result()
    got = dict(zip(enc.keys_to_kmers(keys, k), counts.tolist()))
    assert got == dict(expected)
    assert sc.total_windows == sum(expected.values())

    # dispatch: KDF_SHARDED=1 selects the mesh counter, =0 never does
    monkeypatch.setenv("KDF_SHARDED", "1")
    assert isinstance(eng.make_stream_counter(k),
                      eng.ShardedStreamCounter)
    monkeypatch.setenv("KDF_SHARDED", "0")
    sc2 = eng.make_stream_counter(k)
    assert not isinstance(sc2, eng.ShardedStreamCounter)


@needs_mesh
def test_discovery_child_count_sharded(tmp_path, monkeypatch):
    """KDF_SHARDED=1 routes discovery Module 0/1 stream counting
    through the mesh and the end-to-end outputs are unchanged."""
    from kmer_denovo_filter_tpu.cli import parse_args
    from kmer_denovo_filter_tpu.pipeline import run_discovery_pipeline
    from tests.helpers import create_bam, create_ref_fasta

    ref = str(tmp_path / "ref.fa")
    seq = create_ref_fasta(ref, "chr1", 300)
    novel = "TTGACCAGGTCAATCGGCAT"
    reads_child = [(f"c{i}", p, seq[p:p + 40] if p != 120 else
                    seq[120:140] + novel + seq[140:160])
                   for i, p in enumerate(range(40, 240, 8))]
    reads_parent = [(f"p{i}", p, seq[p:p + 40])
                    for i, p in enumerate(range(40, 240, 8))]
    child = str(tmp_path / "child.bam")
    mother = str(tmp_path / "mother.bam")
    father = str(tmp_path / "father.bam")
    create_bam(child, "chr1", reads_child, ref_length=300)
    create_bam(mother, "chr1", reads_parent, ref_length=300)
    create_bam(father, "chr1", reads_parent, ref_length=300)

    def run(prefix):
        args = parse_args([
            "--child", child, "--mother", mother, "--father", father,
            "--ref-fasta", ref, "--out-prefix", str(tmp_path / prefix),
            "--kmer-size", "15", "--min-child-count", "2"])
        run_discovery_pipeline(args)
        return open(str(tmp_path / prefix) + ".bed").read()

    monkeypatch.setenv("KDF_SHARDED", "0")
    bed_single = run("single")
    (tmp_path / "ref.fa.k15.kdx.npz").unlink(missing_ok=True)
    monkeypatch.setenv("KDF_SHARDED", "1")
    bed_sharded = run("sharded")
    assert bed_sharded == bed_single


@needs_mesh
def test_membership_index_budget_gate_shards(monkeypatch):
    """Above the per-device budget the factory shards the table across
    the mesh; membership answers stay identical."""
    from kmer_denovo_filter_tpu import engine as eng
    from kmer_denovo_filter_tpu.parallel import ShardedKmerIndex

    k = 31
    reads = random_reads(30, k, with_n=False, seed=91)
    kmers = sorted({km for s in reads
                    for km in oracle_counts([s], k)})
    keys = enc.kmers_to_keys(kmers, k)
    # full table over the budget, its 1/8 share under
    monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", str(keys.nbytes))
    idx = eng.make_membership_index(keys, k)
    assert isinstance(idx, ShardedKmerIndex)
    other = enc.kmers_to_keys(
        sorted({km for s in random_reads(10, k, with_n=False, seed=92)
                for km in oracle_counts([s], k)}), k)
    queries = np.concatenate([keys[::2], other])
    expected = eng.KmerIndex(keys, k).membership(queries)
    assert np.array_equal(idx.membership(queries), expected)


@needs_mesh
def test_sharded_programs_compile_once_per_shape():
    """Batches of one shape reuse one compiled count and scan program
    (a fresh program per batch would recompile every batch)."""
    from kmer_denovo_filter_tpu.parallel import (
        sharded as sh,
        sharded_scan_reads_for_hits,
    )

    k = 31
    keys, table_reads = _table_keys(10, k, seed=61)
    mesh = make_mesh()
    index = ShardedKmerIndex(keys, k, mesh)
    codes, lengths = pack_reads(random_reads(16, 64, seed=62)
                                + table_reads[:4])
    sharded_scan_reads_for_hits(index, codes, lengths)
    n_programs = len(index._probe_cache)
    first = sharded_scan_reads_for_hits(index, codes, lengths)
    assert len(index._probe_cache) == n_programs
    assert first.any()
    sh.make_count_program.cache_clear()
    sharded_count(codes, lengths, k, mesh)
    sharded_count(codes, lengths, k, mesh)
    info = sh.make_count_program.cache_info()
    assert info.hits >= 1 and info.currsize == info.misses


def test_owner_of_keys_uniform_and_row_local():
    """The multi-host merge's owner map: a function of the row alone,
    roughly uniform over processes even for low-entropy keys."""
    from kmer_denovo_filter_tpu.parallel import multihost

    rng = np.random.default_rng(17)
    keys = np.unique(rng.integers(0, 64, (8192, 2), dtype=np.uint32)
                     << np.uint32(26), axis=0)
    owner = multihost._owner_of_keys(keys, 4)
    perm = rng.permutation(len(keys))
    assert np.array_equal(multihost._owner_of_keys(keys[perm], 4),
                          owner[perm])
    counts = np.bincount(owner, minlength=4)
    assert counts.min() > 0.7 * counts.mean()
