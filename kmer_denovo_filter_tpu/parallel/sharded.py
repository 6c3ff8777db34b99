"""Hash-prefix sharded k-mer engine over a ``jax.sharding.Mesh``.

The distributed design the reference lacks (its concurrency is
process pools + OS page cache, reference discovery/pipeline.py:734–792,
SURVEY.md §2.3): the canonical k-mer table is partitioned across
devices by a *hash prefix* of the key, so

* every distinct k-mer lives on exactly one device → counting needs no
  cross-device merge of duplicate keys (the reference's jellyfish
  chunk-merge step disappears by construction);
* membership probes route each query key to its owner via a single
  ``all_to_all``, answer with a local binary search, and return with
  the inverse ``all_to_all``;
* filtered-count tallies (the ``--if`` analog) accumulate on the owner
  shard with no result-return traffic at all.

Everything is expressed with ``shard_map`` + ``jax.lax`` collectives, so
XLA schedules the exchanges onto the device interconnect (NCCL over
NVLink on a GPU host).  Query routing uses
fixed-capacity buckets (static shapes) with overflow detection and
host-side retry at doubled capacity — the compile-friendly equivalent
of a dynamic shuffle.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from kmer_denovo_filter_tpu.ops import device as dev
from kmer_denovo_filter_tpu.ops import encode as enc

AXIS = "shard"
_SENTINEL32 = np.uint32(0xFFFFFFFF)

_MIX = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
        0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09,
        0x8DA6B343, 0xD8163841, 0xCB1AB31F, 0x7FEB352D, 0x846CA68B)


def make_mesh(n_devices=None):
    """1-D device mesh over the first *n_devices* local devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


# ── single- and multi-process placement ─────────────────────────────
# On a mesh that spans processes every host holds the table in full,
# feeds its OWN read batch (the per-host BAM-slice input model of
# parallel/multihost.py; shapes must match across hosts), and reads
# flags and results back through ``process_allgather``.

def _multiprocess():
    return jax.process_count() > 1


def _put_global(arr_np, sharding):
    """Place a host array that every process holds in full."""
    if not _multiprocess():
        return jax.device_put(jnp.asarray(arr_np), sharding)
    return jax.make_array_from_callback(
        arr_np.shape, sharding, lambda idx: arr_np[idx])


def _to_host(x):
    """Fetch a (possibly non-addressable) global array to every host."""
    if not _multiprocess():
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def distribute_read_batch(codes, lengths, mesh):
    """Build globally-sharded read arrays from this host's batch.

    ``codes``/``lengths`` are process-local; every process must pass
    the same shapes.  Rows pad to a multiple of the *local* device
    count so the global array splits evenly.
    """
    n_local = jax.local_device_count()
    b, length = codes.shape
    per = -(-b // n_local)
    pad_b = per * n_local
    codes_p = np.full((pad_b, length), 4, dtype=np.uint8)
    codes_p[:b] = codes
    lens_p = np.zeros(pad_b, dtype=np.int32)
    lens_p[:b] = lengths
    codes_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(AXIS, None)), codes_p)
    lens_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(AXIS)), lens_p)
    return codes_g, lens_g


def _stage_reads(codes, lengths, mesh):
    """This process's read batch → mesh-sharded ``(codes, lens)`` and
    the read rows each shard holds."""
    n_shards = int(mesh.devices.size)
    if _multiprocess():
        codes_d, lens_d = distribute_read_batch(codes, lengths, mesh)
        return codes_d, lens_d, codes_d.shape[0] // n_shards
    b, length = codes.shape
    per = -(-b // n_shards)
    pad_b = per * n_shards
    codes_p = np.full((pad_b, length), 4, dtype=np.uint8)
    codes_p[:b] = codes
    lens_p = np.zeros(pad_b, dtype=np.int32)
    lens_p[:b] = lengths
    codes_d = jax.device_put(
        jnp.asarray(codes_p), NamedSharding(mesh, P(AXIS, None)))
    lens_d = jax.device_put(
        jnp.asarray(lens_p), NamedSharding(mesh, P(AXIS)))
    return codes_d, lens_d, per


def _local_rows(x, b):
    """This process's first *b* rows of a row-sharded global array."""
    if not _multiprocess():
        return np.asarray(x)[:b]
    shards = sorted(x.addressable_shards,
                    key=lambda sh: sh.index[0].start)
    return np.concatenate([np.asarray(sh.data) for sh in shards])[:b]


def hash_owner(keys, n_shards):
    """Owner shard id per key row — uniform even for biased DNA keys."""
    w = keys.shape[-1]
    h = jnp.uint32(0x811C9DC5)
    for j in range(w):
        h = (h ^ keys[..., j]) * jnp.uint32(_MIX[j % len(_MIX)])
        h = h ^ (h >> jnp.uint32(15))
    return (h % jnp.uint32(n_shards)).astype(jnp.int32)


def _bucketize(keys, n_shards, cap, w):
    """Scatter key rows into (n_shards, cap, W) route buckets (traced).

    Returns ``(buckets, slot_of_key, overflow)``; sentinel rows route
    nowhere, overflowed rows get slot -1.
    """
    n = keys.shape[0]
    owner = hash_owner(keys, n_shards)
    sent = jnp.ones(n, dtype=bool)
    for j in range(w):
        sent = sent & (keys[:, j] == jnp.uint32(0xFFFFFFFF))
    owner = jnp.where(sent, n_shards, owner)
    one_hot = jax.nn.one_hot(owner, n_shards + 1, dtype=jnp.int32)
    running = jnp.cumsum(one_hot, axis=0) - one_hot
    slot = jnp.take_along_axis(running, owner[:, None], axis=1)[:, 0]
    overflow = jnp.any((slot >= cap) & (owner < n_shards))
    valid = (slot < cap) & (owner < n_shards)
    flat_idx = jnp.where(valid, owner * cap + slot, n_shards * cap)
    buckets = jnp.full((n_shards * cap + 1, w), jnp.uint32(0xFFFFFFFF))
    buckets = buckets.at[flat_idx].set(keys)
    return (buckets[:-1].reshape(n_shards, cap, w),
            jnp.where(valid, flat_idx, -1), overflow)


def _hit_rows(q, idx, found, m_cap, w):
    """Owner-shard tally rows of routed queries: hits only.  Misses and
    the route buckets' sentinel padding (which "finds" the shard's
    sentinel rows) point past the shard for a ``mode="drop"`` scatter;
    sent to one row instead, they serialise the scatter on the GPU."""
    sent = jnp.ones(q.shape[0], dtype=bool)
    for j in range(w):
        sent = sent & (q[:, j] == jnp.uint32(0xFFFFFFFF))
    return jnp.where(found & ~sent, idx, m_cap)


@functools.lru_cache(maxsize=32)
def make_count_program(mesh, n_shards, k, w, cap):
    """shard_map program: distributed canonical count of a read batch.

    Shared by the single-host :func:`sharded_count` and the
    multi-host :func:`~kmer_denovo_filter_tpu.parallel.multihost.
    sharded_count_multihost` — one definition, both deployments.
    Cached per (mesh, shape) so every batch reuses one compilation.
    """

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS)),
        out_specs=(P(AXIS, None, None), P(AXIS, None),
                   P(AXIS, None), P(AXIS)),
        check_vma=False)
    def count(codes_shard, lens_shard):
        keys, _valid = dev.extract_canonical_windows(
            codes_shard, lens_shard, k)
        flat = keys.reshape(-1, w)
        buckets, _slot, ovf = _bucketize(flat, n_shards, cap, w)
        routed = jax.lax.all_to_all(
            buckets, AXIS, split_axis=0, concat_axis=0)
        q = routed.reshape(n_shards * cap, w)
        skeys, starts, counts = dev.sort_count(q, w)
        sent = jnp.ones(q.shape[0], dtype=bool)
        for j in range(w):
            sent = sent & (skeys[:, j] == jnp.uint32(0xFFFFFFFF))
        starts = starts & ~sent
        return (skeys[None], starts[None], counts[None], ovf[None])

    return count


class ShardedKmerIndex:
    """A canonical k-mer table sharded across a device mesh."""

    def __init__(self, keys_np, k, mesh):
        self.k = k
        self.w = enc.words_per_kmer(k)
        self.mesh = mesh
        self.n_shards = int(mesh.devices.size)
        self.n = keys_np.shape[0]

        owner = np.asarray(hash_owner(
            jnp.asarray(np.ascontiguousarray(keys_np, np.uint32)),
            self.n_shards))
        shards = []
        self.global_index_of = []
        max_m = 1
        for d in range(self.n_shards):
            rows = np.nonzero(owner == d)[0]
            local = keys_np[rows]
            if local.shape[0]:
                order = enc.lexsort_keys(local)
            else:
                order = np.zeros(0, dtype=np.int64)
            shards.append(local[order])
            self.global_index_of.append(rows[order])
            max_m = max(max_m, local.shape[0])
        self.m_cap = 1 << (max_m - 1).bit_length()
        stacked = np.full((self.n_shards, self.m_cap, self.w),
                          _SENTINEL32, dtype=np.uint32)
        for d, s in enumerate(shards):
            stacked[d, :s.shape[0]] = s
        self._table_sharding = NamedSharding(mesh, P(AXIS, None, None))
        self._acc_sharding = NamedSharding(mesh, P(AXIS, None))
        self.table = _put_global(stacked, self._table_sharding)
        self._tally = _put_global(
            np.zeros((self.n_shards, self.m_cap), dtype=np.int32),
            self._acc_sharding)
        self._probe_cache = {}
        self._tally_cache = {}

    # ── collective kernels (built per routing capacity) ────────────
    def _probe_fn(self, cap):
        if cap in self._probe_cache:
            return self._probe_cache[cap]
        w = self.w
        n_shards = self.n_shards

        @jax.jit
        @functools.partial(
            shard_map, mesh=self.mesh,
            in_specs=(P(AXIS, None, None), P(AXIS, None, None)),
            out_specs=(P(AXIS, None), P(AXIS)),
            check_vma=False)
        def probe(table_shard, queries_shard):
            table = table_shard[0]
            q_local = queries_shard[0]            # (nq_local, W)
            buckets, slot_of_key, overflow = _bucketize(
                q_local, n_shards, cap, w)
            routed = jax.lax.all_to_all(
                buckets, AXIS, split_axis=0, concat_axis=0)
            q = routed.reshape(n_shards * cap, w)
            _, found = dev.lookup_sorted(table, q, w)
            back = jax.lax.all_to_all(
                found.reshape(n_shards, cap), AXIS,
                split_axis=0, concat_axis=0)
            flat = back.reshape(n_shards * cap)
            idx_c = jnp.clip(slot_of_key, 0, n_shards * cap - 1)
            out = jnp.where(slot_of_key >= 0, flat[idx_c], False)
            return out[None], overflow[None]

        self._probe_cache[cap] = probe
        return probe

    def _tally_fn(self, cap):
        if cap in self._tally_cache:
            return self._tally_cache[cap]
        w = self.w
        n_shards = self.n_shards
        m_cap = self.m_cap

        @jax.jit
        @functools.partial(
            shard_map, mesh=self.mesh,
            in_specs=(P(AXIS, None, None), P(AXIS, None),
                      P(AXIS, None, None)),
            out_specs=(P(AXIS, None), P(AXIS)),
            check_vma=False)
        def tally(table_shard, acc_shard, queries_shard):
            table = table_shard[0]
            q_local = queries_shard[0]
            buckets, _slot, overflow = _bucketize(
                q_local, n_shards, cap, w)
            routed = jax.lax.all_to_all(
                buckets, AXIS, split_axis=0, concat_axis=0)
            q = routed.reshape(n_shards * cap, w)
            idx, found = dev.lookup_sorted(table, q, w)
            acc = acc_shard.at[0, _hit_rows(q, idx, found, m_cap, w)].add(
                1, mode="drop")
            return acc, overflow[None]

        self._tally_cache[cap] = tally
        return tally

    # ── host-facing API ────────────────────────────────────────────
    def _shard_queries(self, query_keys_np):
        """Pad + reshape host queries to (n_shards, nq_local, W)."""
        n = query_keys_np.shape[0]
        per = -(-max(n, 1) // self.n_shards)
        per = max(per, 8)
        padded = np.full((self.n_shards * per, self.w), _SENTINEL32,
                         dtype=np.uint32)
        padded[:n] = query_keys_np
        return _put_global(padded.reshape(self.n_shards, per, self.w),
                           self._table_sharding), per

    def membership(self, query_keys_np, slack=4.0):
        """Routed membership probe returning per-query bool."""
        n = query_keys_np.shape[0]
        if n == 0:
            return np.zeros(0, dtype=bool)
        queries, per = self._shard_queries(
            np.ascontiguousarray(query_keys_np, np.uint32))
        cap = max(16, int(np.ceil(per / self.n_shards * slack)))
        found, overflow = self._probe_fn(cap)(self.table, queries)
        if bool(_to_host(overflow).any()):
            return self.membership(query_keys_np, slack * 2)
        out = _to_host(found).reshape(-1)[:n]
        sent = (query_keys_np == _SENTINEL32).all(axis=1)
        out = np.array(out)
        out[sent] = False
        return out

    def tally_batch(self, flat_keys_np, slack=4.0):
        """Accumulate filtered counts for a batch of window keys."""
        if flat_keys_np.shape[0] == 0:
            return
        queries, per = self._shard_queries(
            np.ascontiguousarray(flat_keys_np, np.uint32))
        cap = max(16, int(np.ceil(per / self.n_shards * slack)))
        acc, overflow = self._tally_fn(cap)(
            self.table, self._tally, queries)
        if bool(_to_host(overflow).any()):
            self.tally_batch(flat_keys_np, slack * 2)
            return
        self._tally = acc

    def tally_result(self):
        """Per-global-key tally gathered back to the host key order
        (identical on every host of a multi-process mesh)."""
        acc = _to_host(self._tally)
        out = np.zeros(self.n, dtype=np.int64)
        for d in range(self.n_shards):
            rows = self.global_index_of[d]
            out[rows] = acc[d, :rows.shape[0]]
        return out


class ShardedFilteredCounter:
    """Multi-chip ``--if`` filtered counter over a sharded table.

    The drop-in multi-device analog of ``engine.FilteredCounter``:
    the whole step — window extraction (data-parallel over reads),
    all-to-all routing of window keys to their hash owner, and the
    owner-side tally — is ONE ``shard_map`` program per batch; no key
    ever visits the host.
    """

    def __init__(self, keys_np, k, mesh):
        self.index = ShardedKmerIndex(keys_np, k, mesh)
        self.k = k
        self.w = self.index.w
        self._step_cache = {}
        self._pending = None

    def _step_fn(self, cap):
        if cap in self._step_cache:
            return self._step_cache[cap]
        idx = self.index
        k, w, n_shards, m_cap = self.k, self.w, idx.n_shards, idx.m_cap
        from kmer_denovo_filter_tpu.ops import device as dev_ops

        @jax.jit
        @functools.partial(
            shard_map, mesh=idx.mesh,
            in_specs=(P(AXIS, None, None), P(AXIS, None),
                      P(AXIS, None), P(AXIS)),
            out_specs=(P(AXIS, None), P(AXIS)),
            check_vma=False)
        def step(table_shard, acc_shard, codes_shard, lens_shard):
            keys, _valid = dev_ops.extract_canonical_windows(
                codes_shard, lens_shard, k)
            flat = keys.reshape(-1, w)
            buckets, _slot, ovf = _bucketize(flat, n_shards, cap, w)
            routed = jax.lax.all_to_all(
                buckets, AXIS, split_axis=0, concat_axis=0)
            q = routed.reshape(n_shards * cap, w)
            i, found = dev_ops.lookup_sorted(table_shard[0], q, w)
            acc = acc_shard.at[0, _hit_rows(q, i, found, m_cap, w)].add(
                1, mode="drop")
            return acc, ovf[None]

        self._step_cache[cap] = step
        return step

    def _resolve_pending(self):
        """Settle the previous batch's route-overflow flag.

        Deferred one batch (the flag read is a device sync) so host
        decode overlaps the sharded step — same contract as
        ``engine.FilteredCounter``; the rare overflow replays exactly
        from the saved pre-batch tally at doubled route capacity.
        """
        if self._pending is None:
            return
        codes_d, lens_d, tally_before, overflow, cap = self._pending
        self._pending = None
        if not bool(_to_host(overflow).any()):
            return
        idx = self.index
        while True:
            cap *= 2
            acc, overflow = self._step_fn(cap)(
                idx.table, tally_before, codes_d, lens_d)
            if not bool(_to_host(overflow).any()):
                break
        idx._tally = acc

    def feed(self, codes, lengths, slack=4.0):
        """Tally one batch: on a multi-process mesh, this host's own
        reads (shapes must match across hosts)."""
        idx = self.index
        codes_d, lens_d, per = _stage_reads(codes, lengths, idx.mesh)
        s = codes.shape[1] - self.k + 1
        cap = max(16, int(per * s / idx.n_shards * slack))
        self._resolve_pending()
        tally_before = idx._tally
        acc, overflow = self._step_fn(cap)(
            idx.table, tally_before, codes_d, lens_d)
        idx._tally = acc
        self._pending = (codes_d, lens_d, tally_before, overflow, cap)

    def result(self):
        self._resolve_pending()
        return self.index.tally_result()


def sharded_scan_reads_for_hits(counter_or_index, codes, lengths,
                                slack=4.0):
    """Multi-chip window hit mask (``engine.scan_reads_for_hits``
    analog): reads data-parallel, keys routed to owner shards, and
    verdicts routed back — one shard_map program per batch.

    Returns (B, S) bool numpy, identical to the single-device scan;
    on a multi-process mesh *codes* is this host's own batch (shapes
    must match across hosts) and the mask covers exactly its reads.
    """
    index = getattr(counter_or_index, "index", counter_or_index)
    from kmer_denovo_filter_tpu.ops import device as dev_ops

    k, w, n_shards, mesh = index.k, index.w, index.n_shards, index.mesh
    b, length = codes.shape
    s = length - k + 1
    codes_d, lens_d, per = _stage_reads(codes, lengths, mesh)
    cap = max(16, int(per * s / n_shards * slack))

    def make(cap):
        # one compiled program per (capacity, read length) per index
        key = ("scan", cap, s)
        if key in index._probe_cache:
            return index._probe_cache[key]

        @jax.jit
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(AXIS, None, None), P(AXIS, None), P(AXIS)),
            out_specs=(P(AXIS, None), P(AXIS)),
            check_vma=False)
        def scan(table_shard, codes_shard, lens_shard):
            keys, valid = dev_ops.extract_canonical_windows(
                codes_shard, lens_shard, k)
            flat = keys.reshape(-1, w)
            buckets, slot_of_key, ovf = _bucketize(
                flat, n_shards, cap, w)
            routed = jax.lax.all_to_all(
                buckets, AXIS, split_axis=0, concat_axis=0)
            q = routed.reshape(n_shards * cap, w)
            _i, found = dev_ops.lookup_sorted(table_shard[0], q, w)
            back = jax.lax.all_to_all(
                found.reshape(n_shards, cap), AXIS,
                split_axis=0, concat_axis=0)
            fl = back.reshape(n_shards * cap)
            ic = jnp.clip(slot_of_key, 0, n_shards * cap - 1)
            hit = jnp.where(slot_of_key >= 0, fl[ic], False)
            return (hit.reshape(codes_shard.shape[0], s) & valid,
                    ovf[None])

        index._probe_cache[key] = scan
        return scan

    found, overflow = make(cap)(index.table, codes_d, lens_d)
    while bool(_to_host(overflow).any()):
        cap *= 2
        found, overflow = make(cap)(index.table, codes_d, lens_d)
    return _local_rows(found, b)


def sharded_count(codes, lengths, k, mesh, cap_per_shard=None):
    """Distributed canonical k-mer count of a read batch.

    Reads are data-parallel over the mesh; every window key routes to
    its hash-prefix owner, where a local sort-count yields the *global*
    count for each owned key.  Returns host ``(keys, counts)`` sorted.
    """
    n_shards = int(mesh.devices.size)
    w = enc.words_per_kmer(k)
    b, length = codes.shape
    s = length - k + 1
    per_shard = -(-b // n_shards)
    pad_b = per_shard * n_shards
    codes_p = np.full((pad_b, length), 4, dtype=np.uint8)
    codes_p[:b] = codes
    lens_p = np.zeros(pad_b, dtype=np.int32)
    lens_p[:b] = lengths
    if cap_per_shard is None:
        cap_per_shard = max(16, int(per_shard * s / n_shards * 4))

    sharding = NamedSharding(mesh, P(AXIS, None))
    codes_dev = jax.device_put(jnp.asarray(codes_p), sharding)
    lens_dev = jax.device_put(jnp.asarray(lens_p),
                              NamedSharding(mesh, P(AXIS)))
    # low-complexity batches can route all their (identical) keys to one
    # owner shard — detect route-bucket overflow and retry with doubled
    # capacity rather than silently undercount
    while True:
        skeys, starts, counts, overflow = make_count_program(
            mesh, n_shards, k, w, cap_per_shard)(codes_dev, lens_dev)
        if not bool(np.asarray(overflow).any()):
            break
        cap_per_shard *= 2
    skeys = np.asarray(skeys)
    starts = np.asarray(starts)
    counts = np.asarray(counts)
    out_keys = []
    out_counts = []
    for d in range(n_shards):
        mask = starts[d]
        out_keys.append(skeys[d][mask])
        out_counts.append(counts[d][mask].astype(np.int64))
    keys = np.concatenate(out_keys, axis=0)
    cnts = np.concatenate(out_counts, axis=0)
    order = enc.lexsort_keys(keys)
    return keys[order], cnts[order]
