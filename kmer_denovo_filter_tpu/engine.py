"""High-level device k-mer engine used by both pipelines.

Replaces the Jellyfish subprocess machinery of the reference
(core/jellyfish_wrappers.py, kmer_utils.py:124–245) with three
device-resident primitives built on
:mod:`kmer_denovo_filter_tpu.ops.device`:

* :class:`KmerIndex` — a sorted, device-resident canonical k-mer table
  (the ``.jf`` index analog); supports batched membership probes.
* :class:`StreamCounter` — canonical k-mer counting over streamed read
  batches (``jellyfish count -C`` analog), sort-based per batch with a
  host-side merge of compacted per-batch uniques (the analog of the
  reference's chunk merge, jellyfish_wrappers.py:335–366).
* :class:`FilteredCounter` — filtered counting against a fixed index
  (``jellyfish count -C --if`` analog, jellyfish_wrappers.py:167–176):
  a per-table-row tally accumulated on device via bucket-pointer
  binary-search probes of each batch's distinct keys.

Batch shapes are padded (reads to a fixed batch size, lengths to a
multiple of 32) so XLA compiles a small number of kernels.
"""

import logging
import os

import numpy as np
import jax
import jax.numpy as jnp

from kmer_denovo_filter_tpu.ops import device as dev
from kmer_denovo_filter_tpu.ops import encode as enc

logger = logging.getLogger(__name__)

_SENTINEL32 = np.uint32(0xFFFFFFFF)

def _round_up(x, m):
    return ((x + m - 1) // m) * m


def pad_read_batch(codes, lengths, batch_reads=None, length_multiple=32):
    """Pad a (B, L) code batch to engine-friendly static shapes.

    Rows pad to the next multiple of 1024 (or *batch_reads*), columns
    to a multiple of *length_multiple* — bounding the number of
    distinct compiled shapes.
    """
    b, length = codes.shape
    tb = batch_reads if batch_reads else max(_round_up(b, 1024), 1024)
    tl = max(_round_up(length, length_multiple), length_multiple)
    out = np.full((tb, tl), 4, dtype=np.uint8)
    out[:b, :length] = codes
    lens = np.zeros(tb, dtype=np.int32)
    lens[:b] = lengths
    return out, lens


def _dedup_cap(n_windows):
    """Static unique-key capacity: N/4 rounded up to a power of two.

    Coverage-local batches from sorted BAMs dedup ~7-30× — genuine
    k-mers collapse by the coverage depth, while sequencing-error
    k-mers (~0.3% of bases × k windows each ≈ 10% of windows) are
    mostly singletons — so N/4 has slack; the fused steps report
    overflow and the engine retries at full capacity when a batch
    defeats deduplication.
    """
    cap = max(4096, n_windows // 4)
    return 1 << (cap - 1).bit_length()


class KmerIndex:
    """Sorted device-resident canonical k-mer table with optional counts."""

    def __init__(self, keys_np, k, counts_np=None):
        """*keys_np*: (M, W) uint32 sorted unique canonical keys."""
        self.k = k
        self.w = enc.words_per_kmer(k)
        self.n = keys_np.shape[0]
        padded = dev.pad_pow2_rows(
            np.ascontiguousarray(keys_np, dtype=np.uint32), _SENTINEL32)
        self.m_pad = padded.shape[0]
        self.table = jnp.asarray(padded)
        self.keys_np = keys_np
        self.counts_np = counts_np
        # bucket-pointer probe metadata: prefix offsets over the padded
        # table cut the binary search to ~log2(max_bucket) rounds
        self.p_bits = min(22, max(1, self.m_pad.bit_length() + 1))
        off, max_bucket = dev.build_bucket_offsets(padded, self.p_bits)
        self.off = jnp.asarray(off)
        self.rounds = max(1, (max_bucket + 1).bit_length())

    def save(self, path):
        """Snapshot the table to ``.npz`` (keys [, counts], k) — the
        checkpointable-table artifact of SURVEY §5's resume story."""
        if self.counts_np is not None:
            np.savez(path, keys=self.keys_np, counts=self.counts_np,
                     k=self.k)
        else:
            np.savez(path, keys=self.keys_np, k=self.k)

    @classmethod
    def load(cls, path):
        data = np.load(path)
        counts = data["counts"] if "counts" in data else None
        return cls(data["keys"], int(data["k"]), counts)

    @classmethod
    def from_strings(cls, kmers, k):
        """Build from canonical k-mer strings (order-independent)."""
        keys = enc.kmers_to_keys(list(kmers), k)
        uniq, _ = enc.unique_with_counts(keys)
        return cls(uniq, k)

    @classmethod
    def from_keys_counts(cls, keys_np, counts_np, k):
        return cls(keys_np, k, counts_np)

    def to_strings(self):
        return enc.keys_to_kmers(self.keys_np, self.k)

    def membership(self, query_keys_np):
        """bool array: which query rows are present in the table."""
        if query_keys_np.shape[0] == 0:
            return np.zeros(0, dtype=bool)
        q = jnp.asarray(np.ascontiguousarray(query_keys_np, np.uint32))
        _idx, found = dev.lookup_bucketed(
            self.table, self.off, q, self.w, self.p_bits, self.rounds)
        found = np.array(found)
        # sentinel queries would match sentinel padding — mask them
        sent = (query_keys_np == _SENTINEL32).all(axis=1)
        found[sent] = False
        return found

    def counts_of(self, query_keys_np):
        """int64 counts per query row (0 when absent / no counts)."""
        if self.counts_np is None:
            raise ValueError("index has no counts")
        idx, found = dev.lookup_sorted(
            self.table,
            jnp.asarray(np.ascontiguousarray(query_keys_np, np.uint32)),
            self.w)
        idx = np.clip(np.asarray(idx), 0, self.n - 1)
        found = np.asarray(found)
        sent = (query_keys_np == _SENTINEL32).all(axis=1)
        out = np.where(found & ~sent, self.counts_np[idx], 0)
        return out


class HostKmerIndex:
    """Host-resident membership index for tables too large for a device.

    A whole-genome *reference* set (~2.4B canonical 31-mers ≈ 19 GB of
    keys) cannot be device-resident on one chip; this is the analog of
    the reference's mmap'd jellyfish index on the host (reference
    kmer_utils.py:124–136).  Probes run on the multithreaded C++ hash
    (W ≤ 2) or numpy big-endian byte-order searchsorted otherwise.
    Exposes the :class:`KmerIndex` subset the ref-subtraction path
    uses (``k``, ``n``, ``membership``, ``counts_of``).
    """

    def __init__(self, keys_np, k, counts_np=None):
        self.k = k
        self.w = enc.words_per_kmer(k)
        self.keys_np = np.ascontiguousarray(keys_np, np.uint32)
        self.counts_np = counts_np
        self.n = keys_np.shape[0]
        self._ht = None
        if self.w == 2:
            from kmer_denovo_filter_tpu.htsio import native
            if native.available():
                k64 = ((self.keys_np[:, 0].astype(np.uint64)
                        << np.uint64(32))
                       | self.keys_np[:, 1].astype(np.uint64))
                self._ht = native.HostHashTable(k64)
        if self._ht is None:
            width = f"S{4 * self.w}"
            self._tbl = np.ascontiguousarray(
                self.keys_np.astype(">u4")).view(width).ravel()

    def _locate(self, query_keys_np):
        q = np.ascontiguousarray(query_keys_np, np.uint32)
        if self._ht is not None:
            q64 = ((q[:, 0].astype(np.uint64) << np.uint64(32))
                   | q[:, 1].astype(np.uint64))
            return self._ht.member(q64, want_index=True)
        width = f"S{4 * self.w}"
        qb = np.ascontiguousarray(q.astype(">u4")).view(width).ravel()
        pos = np.minimum(np.searchsorted(self._tbl, qb), self.n - 1)
        return self._tbl[pos] == qb, pos

    def membership(self, query_keys_np):
        if query_keys_np.shape[0] == 0:
            return np.zeros(0, dtype=bool)
        found, _pos = self._locate(query_keys_np)
        sent = (query_keys_np == _SENTINEL32).all(axis=1)
        found = np.array(found)
        found[sent] = False
        return found

    def counts_of(self, query_keys_np):
        if self.counts_np is None:
            raise ValueError("index has no counts")
        found, pos = self._locate(query_keys_np)
        sent = (query_keys_np == _SENTINEL32).all(axis=1)
        return np.where(found & ~sent, self.counts_np[pos], 0)


# Budget for backends that report no memory statistics (the CPU).
_DEFAULT_TABLE_BYTES = 8 << 30


def device_table_budget():
    """Largest padded table, in bytes, that one device should hold.

    Half of the device's allocatable memory
    (``memory_stats()["bytes_limit"]``): a filtered tally adds an
    int32 per padded row (half the table's bytes at W == 2), and the
    last quarter holds read batches and the step's sort and extract
    intermediates.  ``KDF_DEVICE_TABLE_BYTES`` overrides; backends
    without memory statistics get ``_DEFAULT_TABLE_BYTES``.
    """
    env = os.environ.get("KDF_DEVICE_TABLE_BYTES")
    if env is not None:
        return int(env)
    stats = jax.local_devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return _DEFAULT_TABLE_BYTES
    return int(stats["bytes_limit"]) // 2


def _padded_table_bytes(keys_np):
    n = keys_np.shape[0]
    return (1 << max(0, (n - 1).bit_length())) * keys_np.shape[1] * 4 \
        if n else 0


def make_membership_index(keys_np, k, counts_np=None):
    """Membership index with a per-device memory budget gate.

    Tables whose padded device form exceeds the budget go to the
    sharded index on a multi-device mesh (each device holds 1/S of the
    table, probes route over the interconnect) or to the host-resident
    :class:`HostKmerIndex` on one device — the single-device analog of
    the reference's mmap'd jellyfish index.
    """
    padded_bytes = _padded_table_bytes(keys_np)
    budget = device_table_budget()
    if padded_bytes > budget:
        n_dev = len(jax.devices())
        if n_dev >= 2 and padded_bytes // n_dev <= budget:
            from kmer_denovo_filter_tpu.parallel import (
                ShardedKmerIndex,
                make_mesh,
            )
            logger.info(
                "  reference table %d keys (%.1f GB padded) exceeds "
                "the per-chip budget — sharded across %d devices",
                keys_np.shape[0], padded_bytes / 2 ** 30, n_dev)
            return ShardedKmerIndex(keys_np, k, make_mesh())
        logger.info(
            "  reference table %d keys (%.1f GB padded) exceeds the "
            "device budget — host-resident index",
            keys_np.shape[0], padded_bytes / 2 ** 30)
        return HostKmerIndex(keys_np, k, counts_np)
    return KmerIndex(keys_np, k, counts_np)


class StreamCounter:
    """Canonical k-mer counting over streamed (codes, lengths) batches.

    Per-batch uniques consolidate progressively (the analog of the
    reference's jellyfish chunk merge, jellyfish_wrappers.py:335–366):
    whenever the pending per-batch chunks hold more rows than the
    consolidated array, everything merges into one sorted
    (keys, counts) pair — amortised O(n log n) total work with a
    bounded working set, instead of hoarding every batch's uniques
    until :meth:`result` (which at WGS scale is tens of billions of
    rows).  ``KDF_MERGE_ROWS`` floors the merge trigger.
    """

    def __init__(self, k):
        self.k = k
        self.w = enc.words_per_kmer(k)
        self._chunks = []  # pending per-batch (unique_keys, counts)
        self._pending_rows = 0
        self._merged = None  # consolidated (sorted keys, counts)
        self._merge_floor = int(os.environ.get(
            "KDF_MERGE_ROWS", 16 * 1024 * 1024))
        self.total_windows = 0

    def _consolidate(self):
        if not self._chunks:
            return
        parts = self._chunks
        if self._merged is not None:
            parts = [self._merged] + parts
        all_keys = np.concatenate([c[0] for c in parts], axis=0)
        all_counts = np.concatenate([c[1] for c in parts], axis=0)
        self._merged = enc.unique_with_counts(all_keys,
                                              weights=all_counts)
        self._chunks = []
        self._pending_rows = 0

    def feed(self, codes, lengths):
        codes_p, lens_p = pad_read_batch(codes, lengths)
        keys, valid = dev.extract_canonical_windows(
            jnp.asarray(codes_p), jnp.asarray(lens_p), self.k)
        b, s, w = keys.shape
        flat = keys.reshape(b * s, w)
        skeys, starts, counts = dev.sort_count(flat, w)
        skeys = np.asarray(skeys)
        starts = np.asarray(starts)
        counts = np.asarray(counts)
        mask = starts & ~(skeys == _SENTINEL32).all(axis=1)
        uk = skeys[mask]
        self._chunks.append((uk, counts[mask].astype(np.int64)))
        self._pending_rows += uk.shape[0]
        self.total_windows += int(np.asarray(valid).sum())
        merged_rows = (self._merged[0].shape[0]
                       if self._merged is not None else 0)
        if self._pending_rows >= max(self._merge_floor, merged_rows):
            self._consolidate()

    def feed_sequence(self, seq):
        """Count k-mers of one long sequence (reference contigs).

        Chunked with k-1 overlap so no window is lost; chunk lengths
        pad to the next power of two so at most ~10 kernel shapes serve
        any contig set.
        """
        codes = enc.ASCII_TO_CODE[
            np.frombuffer(seq.upper().encode("ascii"), dtype=np.uint8)]
        chunk = 1 << 20
        k = self.k
        n = len(codes)
        if n < k:
            return
        step = chunk - (k - 1)
        for off in range(0, max(n - k + 1, 1), step):
            part = codes[off:off + chunk]
            length = len(part)
            target = 1 << max((length - 1).bit_length(), 11)
            if length < target:
                part = np.concatenate(
                    [part, np.full(target - length, 4, dtype=np.uint8)])
            self.feed(part[None, :],
                      np.array([length], dtype=np.int32))

    def result(self):
        """Final (sorted unique keys, counts) across all batches."""
        self._consolidate()
        if self._merged is None:
            return (np.zeros((0, self.w), dtype=np.uint32),
                    np.zeros(0, dtype=np.int64))
        return self._merged

    def to_index(self):
        keys, counts = self.result()
        return KmerIndex.from_keys_counts(keys, counts, self.k)


class ShardedStreamCounter(StreamCounter):
    """Multi-chip canonical counting (``jellyfish count -C`` on a mesh).

    Each batch runs the distributed count program — data-parallel
    extraction, all-to-all routing of window keys to their hash-prefix
    owner, owner-side sort-count — and the per-batch (keys, counts)
    merge reuses :class:`StreamCounter`'s progressive consolidation.
    """

    def __init__(self, k, mesh):
        super().__init__(k)
        self.mesh = mesh

    def feed(self, codes, lengths):
        from kmer_denovo_filter_tpu.parallel import sharded_count

        keys, counts = sharded_count(codes, lengths, self.k, self.mesh)
        self._chunks.append((keys, counts))
        self._pending_rows += keys.shape[0]
        self.total_windows += int(counts.sum())
        merged_rows = (self._merged[0].shape[0]
                       if self._merged is not None else 0)
        if self._pending_rows >= max(self._merge_floor, merged_rows):
            self._consolidate()


def make_stream_counter(k):
    """:class:`StreamCounter`, or its mesh-sharded analog.

    Sharding is automatic on multi-device accelerator backends;
    ``KDF_SHARDED=1`` forces it on any multi-device backend (the CPU
    test mesh) and ``KDF_SHARDED=0`` disables it.
    """
    mode = os.environ.get("KDF_SHARDED")
    multi = len(jax.devices()) > 1
    if multi and mode != "0" and (
            mode == "1" or jax.default_backend() != "cpu"):
        from kmer_denovo_filter_tpu.parallel import make_mesh
        logger.info("  sharded stream counter: %d-device mesh",
                    len(jax.devices()))
        return ShardedStreamCounter(k, make_mesh())
    return StreamCounter(k)


class FilteredCounter:
    """Count stream k-mers restricted to a fixed index (``--if`` analog).

    One fused device step per batch
    (ops/device.py:filtered_tally_step_bucketed): extract windows →
    sort-count dedup (coverage-local batches dedup ~7–30×) → bucket-
    pointer probe of the distinct keys → tally scatter.  On the H100
    this single tier beats the all-pairs and hash-partitioned sweeps
    at every table size measured, 2^12 to 2^29 keys (PERF.md).
    """

    def __init__(self, index):
        self.index = index
        self.acc = jnp.zeros(index.m_pad, dtype=jnp.int32)
        self._pending = None

    def _step(self, acc, codes_j, lens_j, cap):
        idx = self.index
        return dev.filtered_tally_step_bucketed(
            idx.table, idx.off, acc, codes_j, lens_j, idx.k, idx.w,
            idx.m_pad, cap, idx.p_bits, idx.rounds)

    def _resolve_pending(self):
        """Settle the overflow flag of the previously dispatched batch.

        The flag read is a device sync, so it is deferred one batch:
        the host decodes batch *i+1* while the device still crunches
        batch *i*.  A batch with more distinct keys than the dedup
        capacity replays exactly from its saved pre-batch accumulator
        at full capacity (every window its own slot).
        """
        if self._pending is None:
            return
        codes_j, lens_j, acc_before, overflow = self._pending
        self._pending = None
        if bool(overflow):
            n_windows = codes_j.shape[0] * (codes_j.shape[1]
                                            - self.index.k + 1)
            self.acc, _ = self._step(acc_before, codes_j, lens_j,
                                     1 << (n_windows - 1).bit_length())

    def feed(self, codes, lengths):
        codes_p, lens_p = pad_read_batch(codes, lengths)
        b, length = codes_p.shape
        n_windows = b * (length - self.index.k + 1)
        codes_j = jnp.asarray(codes_p)
        lens_j = jnp.asarray(lens_p)
        self._resolve_pending()
        acc_before = self.acc
        self.acc, overflow = self._step(acc_before, codes_j, lens_j,
                                        _dedup_cap(n_windows))
        self._pending = (codes_j, lens_j, acc_before, overflow)

    def result(self):
        """int64 counts aligned with the index's sorted keys."""
        self._resolve_pending()
        return np.asarray(self.acc)[:self.index.n].astype(np.int64)


def scan_reads_for_hits(index, codes, lengths):
    """Window hit mask of a read batch against *index*.

    The anchoring-scan primitive (replaces the per-read Aho-Corasick /
    jellyfish-query loop of reference core/bam_scanner.py:340–507):
    extract → sort-count dedup → bucket-pointer probe of the distinct
    keys → verdicts back through the sort permutation.

    Returns a (B, S) bool numpy array: window *s* of read *b* is a
    canonical k-mer present in the index.
    """
    codes_p, lens_p = pad_read_batch(codes, lengths)
    b, length = codes_p.shape
    n_windows = b * (length - index.k + 1)
    codes_j = jnp.asarray(codes_p)
    lens_j = jnp.asarray(lens_p)
    found, overflow = dev.scan_hits_step_bucketed(
        index.table, index.off, codes_j, lens_j, index.k, index.w,
        _dedup_cap(n_windows), index.p_bits, index.rounds)
    if bool(overflow):
        found, overflow = dev.scan_hits_step_bucketed(
            index.table, index.off, codes_j, lens_j, index.k, index.w,
            1 << (n_windows - 1).bit_length(), index.p_bits,
            index.rounds)
    found = np.asarray(found)
    return found[:codes.shape[0], :codes.shape[1] - index.k + 1]


class HostFilteredCounter:
    """``--if`` filtered counter over a host-resident table (W ≤ 2).

    The single-device path for filter tables beyond the device
    memory budget (whole-genome child candidate sets): the device extracts
    and canonicalises windows — the vectorisable part — and the
    multithreaded C++ hash answers the random-access tally at host
    memory speed (the role the mmap'd jellyfish index plays in the
    reference, kmer_utils.py:124–136).
    """

    def __init__(self, keys_np, k):
        from kmer_denovo_filter_tpu.htsio import native

        self.k = k
        self.w = enc.words_per_kmer(k)
        if self.w != 2:
            raise ValueError("host filtered counter requires W <= 2")
        if not native.available():
            raise RuntimeError("native library unavailable")
        self.keys_np = np.ascontiguousarray(keys_np, np.uint32)
        self.n = keys_np.shape[0]
        k64 = ((self.keys_np[:, 0].astype(np.uint64) << np.uint64(32))
               | self.keys_np[:, 1].astype(np.uint64))
        self._ht = native.HostHashTable(k64)
        self._tally = np.zeros(self.n, dtype=np.int64)

    def feed(self, codes, lengths):
        codes_p, lens_p = pad_read_batch(codes, lengths)
        keys, _valid = dev.extract_canonical_windows(
            jnp.asarray(codes_p), jnp.asarray(lens_p), self.k)
        flat = np.asarray(keys).reshape(-1, 2)
        q64 = ((flat[:, 0].astype(np.uint64) << np.uint64(32))
               | flat[:, 1].astype(np.uint64))
        # sentinel (all-ones) queries never match in the C++ table
        self._ht.tally(q64, self._tally)

    def result(self):
        return self._tally.copy()


# Tables above this key count auto-shard on multi-device meshes (the
# per-shard table then amortises the all-to-all; tiny tables are
# faster replicated on one device).
_SHARD_AUTO_N = 1 << 20


def _shard_dispatch(index):
    """True when the sharded engine should serve this index."""
    mode = os.environ.get("KDF_SHARDED")
    if mode == "0":
        return False
    if len(jax.devices()) < 2:
        return False
    return mode == "1" or index.n > _SHARD_AUTO_N


def make_filtered_counter(index):
    """Single-device :class:`FilteredCounter`, or the multi-device
    :class:`~kmer_denovo_filter_tpu.parallel.ShardedFilteredCounter`.

    Sharding is automatic on multi-device meshes for tables above
    ``_SHARD_AUTO_N`` keys; ``KDF_SHARDED=1`` forces it for any size
    and ``KDF_SHARDED=0`` disables it.
    """
    if _shard_dispatch(index):
        from kmer_denovo_filter_tpu.parallel import (
            ShardedFilteredCounter,
            make_mesh,
        )
        logger.info("  sharded engine: %d-device mesh",
                    len(jax.devices()))
        return ShardedFilteredCounter(index.keys_np, index.k,
                                      make_mesh())
    return FilteredCounter(index)


def make_parent_filter_counter(keys_np, k):
    """Filtered counter built straight from host keys, memory-gated.

    The pipeline-facing factory for whole-genome parent filtering
    (discovery Module 2), where the filter table itself can exceed a
    device's memory: multi-device meshes take the routed sharded
    counter (the table never materialises on one device), over-budget
    single-device tables take :class:`HostFilteredCounter`, and
    everything else builds the device :class:`KmerIndex` +
    :class:`FilteredCounter` as usual.
    """
    w = enc.words_per_kmer(k)
    n = keys_np.shape[0]
    mode = os.environ.get("KDF_SHARDED")
    if (len(jax.devices()) >= 2 and mode != "0"
            and (mode == "1" or n > _SHARD_AUTO_N)):
        from kmer_denovo_filter_tpu.parallel import (
            ShardedFilteredCounter,
            make_mesh,
        )
        logger.info("  sharded engine: %d-device mesh",
                    len(jax.devices()))
        return ShardedFilteredCounter(keys_np, k, make_mesh())
    padded_bytes = _padded_table_bytes(keys_np)
    if padded_bytes > device_table_budget() and w == 2:
        from kmer_denovo_filter_tpu.htsio import native
        if native.available():
            logger.info(
                "  filter table %d keys (%.1f GB padded) exceeds the "
                "device budget — host C++ filtered counter",
                n, padded_bytes / 2 ** 30)
            return HostFilteredCounter(keys_np, k)
    return FilteredCounter(KmerIndex(keys_np, k))


def make_scanner(index):
    """Anchoring-scan callable for *index*: the single-device
    :func:`scan_reads_for_hits` or its sharded analog under the same
    dispatch rule as :func:`make_filtered_counter` (discovery
    Module 3 on >1 device)."""
    if _shard_dispatch(index):
        from kmer_denovo_filter_tpu.parallel import (
            ShardedKmerIndex,
            make_mesh,
            sharded_scan_reads_for_hits,
        )
        logger.info("  sharded anchoring scan: %d-device mesh",
                    len(jax.devices()))
        sharded = ShardedKmerIndex(index.keys_np, index.k, make_mesh())

        def scan(codes, lengths):
            return sharded_scan_reads_for_hits(sharded, codes, lengths)

        return scan

    def scan(codes, lengths):
        return scan_reads_for_hits(index, codes, lengths)

    return scan


def count_reads(read_batches, k):
    """Count canonical k-mers across an iterator of (codes, lengths)."""
    sc = StreamCounter(k)
    for codes, lengths in read_batches:
        sc.feed(codes, lengths)
    return sc
