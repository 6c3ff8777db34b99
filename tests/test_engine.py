"""Device k-mer engine vs host oracle: bit-exact equivalence tests."""

import random
from collections import Counter

import numpy as np
import pytest

from kmer_denovo_filter_tpu import engine as eng
from kmer_denovo_filter_tpu import kmer as K
from kmer_denovo_filter_tpu.ops import encode as enc


def random_reads(n, k, with_n=True, seed=0):
    rng = random.Random(seed)
    alphabet = "ACGTACGTACGTACGTN" if with_n else "ACGT"
    reads = []
    for _ in range(n):
        length = rng.randint(k, k + 80)
        reads.append("".join(rng.choice(alphabet) for _ in range(length)))
    return reads


def pack_reads(reads):
    codes = [enc.ASCII_TO_CODE[np.frombuffer(s.encode(), dtype=np.uint8)]
             for s in reads]
    lmax = max(len(c) for c in codes)
    batch = np.full((len(codes), lmax), 4, np.uint8)
    for i, c in enumerate(codes):
        batch[i, :len(c)] = c
    lens = np.array([len(c) for c in codes], np.int32)
    return batch, lens


def oracle_counts(reads, k):
    oc = Counter()
    for s in reads:
        cap, _ = K.extract_read_kmers(s, k)
        for c in cap.values():
            oc[c] += 1
    return oc


@pytest.mark.parametrize("k", [5, 15, 31, 33, 63, 101])
def test_stream_counter_matches_oracle(k):
    reads = random_reads(40, k, seed=k)
    oc = oracle_counts(reads, k)
    sc = eng.StreamCounter(k)
    batch, lens = pack_reads(reads)
    # split across two feeds to exercise the chunk merge
    sc.feed(batch[:17], lens[:17])
    sc.feed(batch[17:], lens[17:])
    keys, counts = sc.result()
    got = dict(zip(enc.keys_to_kmers(keys, k), counts.tolist()))
    assert got == dict(oc)


def test_stream_counter_progressive_consolidation():
    """A tiny merge floor forces consolidation on every feed; totals
    must still be exact and feeding past result() keeps counting."""
    k = 31
    reads = random_reads(60, k, seed=7)
    oc = oracle_counts(reads, k)
    sc = eng.StreamCounter(k)
    sc._merge_floor = 1  # consolidate whenever pending ≥ merged rows
    batch, lens = pack_reads(reads)
    for i in range(0, 60, 12):
        sc.feed(batch[i:i + 12], lens[i:i + 12])
    assert sc._merged is not None  # consolidation actually ran
    assert sc._pending_rows <= sc._merged[0].shape[0]
    keys, counts = sc.result()
    got = dict(zip(enc.keys_to_kmers(keys, k), counts.tolist()))
    assert got == dict(oc)
    # feeding after result() still accumulates exactly
    sc.feed(batch[:12], lens[:12])
    keys2, counts2 = sc.result()
    oc2 = oracle_counts(reads + reads[:12], k)
    got2 = dict(zip(enc.keys_to_kmers(keys2, k), counts2.tolist()))
    assert got2 == dict(oc2)


def test_key_roundtrip():
    for k in (5, 31, 33, 63):
        kmers = sorted({K.canonicalize(s)
                        for s in random_reads(50, k, with_n=False, seed=k)
                        for s in [s[:k]]})
        keys = enc.kmers_to_keys(kmers, k)
        assert enc.keys_to_kmers(keys, k) == kmers


def test_key_order_matches_string_order():
    k = 31
    kmers = [K.canonicalize(s[:k])
             for s in random_reads(300, k, with_n=False, seed=3)]
    kmers = sorted(set(kmers))
    keys = enc.kmers_to_keys(kmers, k)
    order = enc.lexsort_keys(keys)
    assert list(order) == sorted(range(len(kmers)),
                                 key=lambda i: kmers[i])


def test_index_counts_and_membership():
    k = 31
    reads = random_reads(60, k, seed=11)
    oc = oracle_counts(reads, k)
    sc = eng.StreamCounter(k)
    batch, lens = pack_reads(reads)
    sc.feed(batch, lens)
    idx = sc.to_index()
    some = sorted(oc)[:200]
    qk = enc.kmers_to_keys(some, k)
    got = idx.counts_of(qk)
    assert [int(g) for g in got] == [oc[s] for s in some]
    member = idx.membership(qk)
    assert member.all()
    # absent canonical k-mer
    absent = K.canonicalize("ACGT" * 8)[:k]
    absent = K.canonicalize("A" * 15 + "CGTGCATGCATGCATG")
    if absent not in oc:
        assert not idx.membership(enc.kmers_to_keys([absent], k)).any()


def test_filtered_counter_matches_oracle():
    k = 31
    rng = random.Random(5)
    stream = random_reads(80, k, with_n=False, seed=21)
    filter_reads = stream[:10] + random_reads(20, k, with_n=False, seed=22)
    filter_set = set()
    for s in filter_reads:
        cap, _ = K.extract_read_kmers(s, k)
        filter_set.update(cap.values())
    fidx = eng.KmerIndex.from_strings(filter_set, k)
    fc = eng.FilteredCounter(fidx)
    batch, lens = pack_reads(stream)
    fc.feed(batch, lens)
    res = fc.result()
    oc = Counter()
    for s in stream:
        cap, _ = K.extract_read_kmers(s, k)
        for c in cap.values():
            if c in filter_set:
                oc[c] += 1
    got = {s: int(c) for s, c in zip(fidx.to_strings(), res) if c > 0}
    assert got == dict(oc)


def test_scan_reads_for_hits_positions():
    k = 15
    reads = random_reads(50, k, seed=31)
    target = set()
    for s in reads[:5]:
        cap, _ = K.extract_read_kmers(s, k)
        target.update(list(cap.values())[:3])
    idx = eng.KmerIndex.from_strings(target, k)
    batch, lens = pack_reads(reads)
    found = eng.scan_reads_for_hits(idx, batch, lens)
    for i, s in enumerate(reads):
        cap, _ = K.extract_read_kmers(s, k)
        expected = {p for p, c in cap.items() if c in target}
        assert set(np.nonzero(found[i])[0].tolist()) == expected


def test_empty_filter_index():
    k = 15
    idx = eng.KmerIndex.from_strings(set(), k)
    reads = random_reads(5, k, seed=41)
    batch, lens = pack_reads(reads)
    found = eng.scan_reads_for_hits(idx, batch, lens)
    assert not found.any()


def test_sequence_counting_chunks():
    # feed_sequence must produce identical counts to whole-sequence
    k = 31
    seq = "".join(random.Random(9).choice("ACGT") for _ in range(5000))
    sc = eng.StreamCounter(k)
    sc.feed_sequence(seq)
    keys, counts = sc.result()
    oc = Counter()
    cap, _ = K.extract_read_kmers(seq, k)
    for c in cap.values():
        oc[c] += 1
    got = dict(zip(enc.keys_to_kmers(keys, k), counts.tolist()))
    assert got == dict(oc)


def test_filtered_counter_large_table_bucketed_path():
    """A larger filter table through the bucketed-probe tally."""
    k = 31
    stream = random_reads(60, k, with_n=False, seed=51)
    filter_reads = stream[:10] + random_reads(160, k, with_n=False,
                                              seed=52)
    filter_set = set()
    for s in filter_reads:
        cap, _ = K.extract_read_kmers(s, k)
        filter_set.update(cap.values())
    fidx = eng.KmerIndex.from_strings(filter_set, k)
    fc = eng.FilteredCounter(fidx)
    batch, lens = pack_reads(stream)
    fc.feed(batch, lens)
    res = fc.result()
    oc = Counter()
    for s in stream:
        cap, _ = K.extract_read_kmers(s, k)
        for c in cap.values():
            if c in filter_set:
                oc[c] += 1
    got = {s: int(c) for s, c in zip(fidx.to_strings(), res) if c > 0}
    assert got == dict(oc)


def test_scan_hits_large_table_bucketed_path():
    k = 31
    reads = random_reads(40, k, seed=61)
    target = set()
    for s in random_reads(140, k, with_n=False, seed=62) + reads[:3]:
        cap, _ = K.extract_read_kmers(s, k)
        target.update(cap.values())
    idx = eng.KmerIndex.from_strings(target, k)
    batch, lens = pack_reads(reads)
    found = eng.scan_reads_for_hits(idx, batch, lens)
    for i, s in enumerate(reads):
        cap, _ = K.extract_read_kmers(s, k)
        expected = {p for p, c in cap.items() if c in target}
        assert set(np.nonzero(found[i])[0].tolist()) == expected, i


@pytest.mark.parametrize("n_keys", [1, 2, 100, 1000, 5000])
def test_filtered_counter_table_sizes(n_keys):
    """Tables of any size pad to a power of two with sentinel rows;
    the padding never counts and every real key tallies exactly."""
    k = 31
    stream = random_reads(50, k, with_n=True, seed=n_keys)
    kmers = sorted({c for s in stream + random_reads(
        60, k, with_n=False, seed=n_keys + 1)
        for c in K.extract_read_kmers(s, k)[0].values()})
    rng = random.Random(n_keys)
    subset = sorted(rng.sample(kmers, min(n_keys, len(kmers))))
    keys = enc.kmers_to_keys(subset, k)
    index = eng.KmerIndex(keys, k)
    assert index.m_pad >= len(subset)
    fc = eng.FilteredCounter(index)
    batch, lens = pack_reads(stream)
    fc.feed(batch, lens)
    assert np.array_equal(fc.result(), _expected_tally(stream, keys, k))


@pytest.mark.parametrize("p_bits", [1, 4, 12])
def test_lookup_bucketed_matches_searchsorted(p_bits):
    """The bucket-pointer probe finds exactly the rows numpy's
    searchsorted finds, for any prefix width."""
    import jax.numpy as jnp

    from kmer_denovo_filter_tpu.ops import device as dev

    rng = np.random.default_rng(p_bits)
    k64 = np.unique(rng.integers(0, 2 ** 62, 3000, dtype=np.uint64)
                    << np.uint64(2))
    keys = np.stack([(k64 >> np.uint64(32)).astype(np.uint32),
                     k64.astype(np.uint32)], axis=1)
    padded = dev.pad_pow2_rows(keys, np.uint32(0xFFFFFFFF))
    off, max_bucket = dev.build_bucket_offsets(padded, p_bits)
    q64 = np.concatenate([k64[::3], rng.integers(
        0, 2 ** 62, 500, dtype=np.uint64) << np.uint64(2)])
    q = np.stack([(q64 >> np.uint64(32)).astype(np.uint32),
                  q64.astype(np.uint32)], axis=1)
    idx, found = dev.lookup_bucketed(
        jnp.asarray(padded), jnp.asarray(off), jnp.asarray(q), 2,
        p_bits, max(1, (max_bucket + 1).bit_length()))
    pos = np.searchsorted(k64, q64)
    want = (pos < len(k64)) & (k64[np.minimum(pos, len(k64) - 1)]
                               == q64)
    assert np.array_equal(np.asarray(found), want)
    assert np.array_equal(np.asarray(idx)[want], pos[want])


class TestOverflowRetries:
    """Capacity-overflow retry paths across engine backends."""

    def _index_and_batch(self, k=31, n_table=60, seed=21):
        reads = random_reads(n_table, 64, with_n=False, seed=seed)
        kmers = sorted({km for s in reads
                        for km in oracle_counts([s], k)})
        keys = enc.kmers_to_keys(kmers, k)
        index = eng.KmerIndex(keys, k)
        batch = random_reads(40, 64, seed=seed + 1) + reads[:10]
        codes, lengths = pack_reads(batch)
        return index, keys, codes, lengths, batch

    def test_dedup_cap_defeat_retries_bucketed(self, monkeypatch):
        """A cap too small for the batch's unique keys must trigger
        the full-capacity retry and still produce exact tallies."""
        index, keys, codes, lengths, batch = self._index_and_batch()
        monkeypatch.setattr(eng, "_dedup_cap", lambda n: 4)
        fc = eng.FilteredCounter(index)
        fc.feed(codes, lengths)
        got = fc.result()
        expected = _expected_tally(batch, keys, index.k)
        assert np.array_equal(got, expected)

    def test_bucketed_deferred_replay_across_feeds(self, monkeypatch):
        """The overflow check is deferred one batch (the flag read is
        a device sync); an overflowing batch settles at the next feed
        or at result() and replays from its saved pre-batch
        accumulator — exactly, across feeds."""
        index, keys, codes, lengths, batch = self._index_and_batch(
            seed=24)
        monkeypatch.setattr(eng, "_dedup_cap", lambda n: 4)
        fc = eng.FilteredCounter(index)
        fc.feed(codes, lengths)
        assert fc._pending is not None
        assert bool(fc._pending[3])  # more distinct keys than 4
        fc.feed(codes, lengths)
        fc.feed(codes[:5], lengths[:5])
        got = fc.result()
        assert fc._pending is None
        expected = (_expected_tally(batch, keys, index.k) * 2
                    + _expected_tally(batch[:5], keys, index.k))
        assert np.array_equal(got, expected)

    def test_bucketed_scan_cap_overflow_retry(self, monkeypatch):
        """A dedup capacity too small for the batch's distinct keys
        must retry the bucketed member scan at full capacity."""
        index, keys, codes, lengths, batch = self._index_and_batch(
            seed=25)
        monkeypatch.setattr(eng, "_dedup_cap", lambda n: 4)
        got = eng.scan_reads_for_hits(index, codes, lengths)
        target = set(enc.keys_to_kmers(keys, index.k))
        for i, s in enumerate(batch):
            per_pos, _ = K.extract_read_kmers(s, index.k)
            want = {p for p, c in per_pos.items() if c in target}
            assert set(np.nonzero(got[i])[0].tolist()) == want

def _expected_tally(reads, keys, k):
    from collections import Counter
    counts = Counter()
    for s in reads:
        counts.update(oracle_counts([s], k))
    kmers = enc.keys_to_kmers(keys, k)
    return np.array([counts.get(km, 0) for km in kmers],
                    dtype=np.int64)


class TestHostKmerIndex:
    def _keys(self, k=31, n_reads=50, seed=61):
        reads = random_reads(n_reads, 64, with_n=False, seed=seed)
        kmers = sorted({km for s in reads
                        for km in oracle_counts([s], k)})
        keys = enc.kmers_to_keys(kmers, k)
        counts = np.arange(1, keys.shape[0] + 1, dtype=np.int64)
        return keys, counts, kmers

    @pytest.mark.parametrize("k", [31, 63])
    def test_membership_and_counts_match_device_index(self, k):
        keys, counts, _ = self._keys(k=k)
        dev_idx = eng.KmerIndex(keys, k, counts)
        host_idx = eng.HostKmerIndex(keys, k, counts)
        other = enc.kmers_to_keys(
            sorted({km for s in random_reads(20, 64, with_n=False,
                                             seed=62)
                    for km in oracle_counts([s], k)}), k)
        queries = np.concatenate([keys[::3], other])
        assert np.array_equal(host_idx.membership(queries),
                              dev_idx.membership(queries))
        assert np.array_equal(host_idx.counts_of(queries),
                              dev_idx.counts_of(queries))

    def test_searchsorted_fallback_matches_hash(self, monkeypatch):
        from kmer_denovo_filter_tpu.htsio import native
        keys, counts, _ = self._keys()
        fast = eng.HostKmerIndex(keys, 31, counts)
        monkeypatch.setattr(native, "available", lambda: False)
        slow = eng.HostKmerIndex(keys, 31, counts)
        assert slow._ht is None
        queries = np.concatenate([keys[1::2], keys[:4]])
        assert np.array_equal(fast.membership(queries),
                              slow.membership(queries))
        assert np.array_equal(fast.counts_of(queries),
                              slow.counts_of(queries))

    def test_factory_gate(self, monkeypatch):
        keys, counts, _ = self._keys()
        monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", "0")
        import jax as _jax
        if len(_jax.devices()) < 2:
            idx = eng.make_membership_index(keys, 31, counts)
            assert isinstance(idx, eng.HostKmerIndex)
        monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", str(8 << 30))
        idx2 = eng.make_membership_index(keys, 31, counts)
        assert isinstance(idx2, eng.KmerIndex)


class TestHostFilteredCounter:
    def test_matches_device_counter(self):
        from kmer_denovo_filter_tpu.htsio import native
        if not native.available():
            pytest.skip("native library unavailable")
        k = 31
        stream = random_reads(60, k, with_n=False, seed=71)
        filter_reads = stream[:10] + random_reads(
            20, k, with_n=False, seed=72)
        kmers = sorted({km for s in filter_reads
                        for km in oracle_counts([s], k)})
        keys = enc.kmers_to_keys(kmers, k)
        codes, lens = pack_reads(stream)
        dev_fc = eng.FilteredCounter(eng.KmerIndex(keys, k))
        dev_fc.feed(codes, lens)
        host_fc = eng.HostFilteredCounter(keys, k)
        host_fc.feed(codes, lens)
        assert np.array_equal(host_fc.result(), dev_fc.result())
        assert dev_fc.result().sum() > 0

    def test_factory_budget_gate(self, monkeypatch):
        from kmer_denovo_filter_tpu.htsio import native
        if not native.available():
            pytest.skip("native library unavailable")
        import jax as _jax
        keys = enc.kmers_to_keys(
            sorted({km for s in random_reads(30, 31, with_n=False,
                                             seed=73)
                    for km in oracle_counts([s], 31)}), 31)
        monkeypatch.setenv("KDF_SHARDED", "0")  # single-device rule
        monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", "0")
        fc = eng.make_parent_filter_counter(keys, 31)
        assert isinstance(fc, eng.HostFilteredCounter)
        monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", str(8 << 30))
        fc2 = eng.make_parent_filter_counter(keys, 31)
        assert isinstance(fc2, eng.FilteredCounter)


class TestWideKeys:
    """W ≥ 3 keys (k > 31) through the bucketed probe, tally and
    member scan, exact vs the host oracle (W = 3 … 13)."""

    def _index(self, k):
        table_reads = random_reads(30, k + 40, with_n=False, seed=k)
        kmers = sorted({km for s in table_reads
                        for km in oracle_counts([s], k)})
        keys = enc.kmers_to_keys(kmers, k)
        batch = random_reads(30, k + 40, seed=k + 1) + table_reads[:6]
        return eng.KmerIndex(keys, k), keys, batch

    @pytest.mark.parametrize("k", [33, 47, 63, 101, 151, 201])
    def test_tally_matches_oracle(self, k):
        index, keys, batch = self._index(k)
        codes, lengths = pack_reads(batch)
        fc = eng.FilteredCounter(index)
        fc.feed(codes, lengths)
        fc.feed(codes[:9], lengths[:9])
        expected = (_expected_tally(batch, keys, k)
                    + _expected_tally(batch[:9], keys, k))
        assert np.array_equal(fc.result(), expected)
        assert expected.sum() > 0

    @pytest.mark.parametrize("k", [33, 47, 63, 101, 151, 201])
    def test_member_matches_oracle(self, k):
        index, keys, batch = self._index(k)
        codes, lengths = pack_reads(batch)
        found = eng.scan_reads_for_hits(index, codes, lengths)
        target = set(enc.keys_to_kmers(keys, k))
        for i, s in enumerate(batch):
            per_pos, _ = K.extract_read_kmers(s, k)
            want = {p for p, c in per_pos.items() if c in target}
            assert set(np.nonzero(found[i])[0].tolist()) == want
        assert found.any()


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


class TestDeviceBudgetAndDispatch:
    def test_budget_from_memory_stats(self, monkeypatch):
        monkeypatch.delenv("KDF_DEVICE_TABLE_BYTES", raising=False)
        monkeypatch.setattr(
            eng.jax, "local_devices",
            lambda: [_FakeDevice({"bytes_limit": 60 << 30})])
        assert eng.device_table_budget() == 30 << 30
        # a table over half the device (and over it per shard of the
        # test mesh) goes to the host index
        keys = np.stack([np.arange(64, dtype=np.uint32),
                         np.zeros(64, np.uint32)], axis=1)
        monkeypatch.setattr(
            eng.jax, "local_devices",
            lambda: [_FakeDevice({"bytes_limit": 40})])
        assert eng.device_table_budget() == 20
        assert isinstance(eng.make_membership_index(keys, 31),
                          eng.HostKmerIndex)

    @pytest.mark.parametrize("stats", [None, {}, {"peak_bytes_in_use": 1}])
    def test_budget_default_without_stats(self, monkeypatch, stats):
        monkeypatch.delenv("KDF_DEVICE_TABLE_BYTES", raising=False)
        monkeypatch.setattr(eng.jax, "local_devices",
                            lambda: [_FakeDevice(stats)])
        assert eng.device_table_budget() == eng._DEFAULT_TABLE_BYTES
        monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", "12345")
        assert eng.device_table_budget() == 12345

    def test_stream_counter_shards_on_accelerators(self, monkeypatch):
        """Multi-device accelerator backends shard Module 1 counting
        by default; the CPU test mesh only when forced."""
        import jax as _jax
        if len(_jax.devices()) < 2:
            pytest.skip("needs multiple devices")
        monkeypatch.delenv("KDF_SHARDED", raising=False)
        assert type(eng.make_stream_counter(31)) is eng.StreamCounter
        monkeypatch.setattr(eng.jax, "default_backend", lambda: "gpu")
        assert isinstance(eng.make_stream_counter(31),
                          eng.ShardedStreamCounter)
        monkeypatch.setenv("KDF_SHARDED", "0")
        assert type(eng.make_stream_counter(31)) is eng.StreamCounter


@pytest.mark.parametrize("k", [3, 7, 11, 17, 21, 25, 29])
def test_tally_and_scan_match_oracle_across_k(k):
    """The filtered tally and the anchoring scan agree with the string
    oracle for one-word (k ≤ 15) and two-word keys, N-bearing reads."""
    stream = random_reads(40, k + 30, with_n=True, seed=100 + k)
    kmers = sorted({c for s in stream[:12]
                    for c in K.extract_read_kmers(s, k)[0].values()})
    keys = enc.kmers_to_keys(kmers[::2], k)
    index = eng.KmerIndex(keys, k)
    codes, lengths = pack_reads(stream)
    fc = eng.FilteredCounter(index)
    fc.feed(codes, lengths)
    assert np.array_equal(fc.result(), _expected_tally(stream, keys, k))
    found = eng.scan_reads_for_hits(index, codes, lengths)
    target = set(enc.keys_to_kmers(keys, k))
    for i, s in enumerate(stream):
        per_pos, _ = K.extract_read_kmers(s, k)
        want = {p for p, c in per_pos.items() if c in target}
        assert set(np.nonzero(found[i])[0].tolist()) == want


def test_build_bucket_offsets_are_prefix_ranks():
    """off[p] is the first row whose top p_bits are ≥ p; max_bucket
    bounds every bucket, so the probe's round count covers it."""
    from kmer_denovo_filter_tpu.ops import device as dev

    rng = np.random.default_rng(3)
    w0 = np.sort(rng.integers(0, 2 ** 32, 5000, dtype=np.uint32))
    keys = np.stack([w0, np.zeros_like(w0)], axis=1)
    off, max_bucket = dev.build_bucket_offsets(keys, 6)
    prefix = w0 >> np.uint32(26)
    for p in range(64):
        assert off[p] == np.searchsorted(prefix, p)
    assert off[64] == len(w0)
    assert max_bucket == np.diff(off).max()


def test_pad_pow2_rows():
    from kmer_denovo_filter_tpu.ops import device as dev

    a = np.arange(10, dtype=np.uint32).reshape(5, 2)
    p = dev.pad_pow2_rows(a, np.uint32(7))
    assert p.shape == (8, 2) and (p[5:] == 7).all()
    assert np.array_equal(p[:5], a)
    b = np.zeros((4, 2), np.uint32)
    assert dev.pad_pow2_rows(b, 1) is b


def test_sort_count_perm_inverts_to_window_order():
    """sort_count_perm's permutation maps sorted rows back to their
    original rows, and run counts sum to the row count."""
    import jax.numpy as jnp

    from kmer_denovo_filter_tpu.ops import device as dev

    rng = np.random.default_rng(9)
    flat = rng.integers(0, 6, (300, 2), dtype=np.uint32)
    skeys, starts, counts, _group, perm = dev.sort_count_perm(
        jnp.asarray(flat), 2)
    skeys, perm = np.asarray(skeys), np.asarray(perm)
    assert np.array_equal(flat[perm], skeys)
    assert int(np.asarray(counts).sum()) == 300
    uniq = np.unique(flat, axis=0)
    assert int(np.asarray(starts).sum()) == len(uniq)
