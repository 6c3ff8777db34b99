"""Multi-host scaffolding: ``jax.distributed`` + per-host input feeds.

Scales the sharded k-mer engine past one host (BASELINE.md's 2-host
target; SURVEY.md §2.3's cross-host dimension): every process contributes its
local devices to one global mesh, reads stream in per-host shards
(each host decodes its own BAM slice — the multi-host analog of the
reference's per-contig process pool, reference
discovery/pipeline.py:734–792), and the hash-owner all-to-all of the
sharded engine rides the device interconnect within a host and the
network across hosts, scheduled by XLA from the same ``shard_map``
programs used single-host.  On a GPU host run one process per card
(``KDF_LOCAL_DEVICE_IDS``).

Deployment contract:

* every process calls :func:`initialize` first (coordinator address
  via arguments or ``KDF_COORDINATOR`` / ``KDF_NUM_PROCESSES`` /
  ``KDF_PROCESS_ID`` / ``KDF_LOCAL_DEVICE_IDS`` env vars);
* batches are *process-local*: each host feeds the reads it decoded;
  batch shapes must match across processes for a given step (pad the
  tail batch);
* results gather to every host via ``process_allgather``.

Tested with a 2-process CPU harness (Gloo collectives) in
tests/test_multihost.py.
"""

import logging

import numpy as np
import jax
from jax.sharding import Mesh

from kmer_denovo_filter_tpu.ops import encode as enc
from kmer_denovo_filter_tpu.parallel.sharded import (  # noqa: F401
    AXIS,
    distribute_read_batch,
    make_count_program,
)

logger = logging.getLogger(__name__)


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Join the distributed runtime (idempotent).

    Arguments fall back to the ``KDF_*`` deployment environment
    (:func:`~kmer_denovo_filter_tpu.runtime.distributed_config`); with
    no coordinator this is a no-op so single-host runs need no
    configuration.
    """
    from kmer_denovo_filter_tpu import runtime

    cfg = runtime.distributed_config() or {}
    coordinator_address = coordinator_address or cfg.get(
        "coordinator_address")
    if coordinator_address is None:
        return False
    if jax.distributed.is_initialized():
        return True  # already joined (e.g. by the entry script)
    if num_processes is None:
        num_processes = cfg["num_processes"]
    if process_id is None:
        process_id = cfg["process_id"]
    if local_device_ids is None:
        local_device_ids = cfg.get("local_device_ids")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id,
        local_device_ids=local_device_ids)
    logger.info("distributed runtime: process %d/%d, %d local / %d "
                "global devices", process_id, num_processes,
                jax.local_device_count(), jax.device_count())
    return True


def active():
    """True when this run spans multiple processes.

    Requires :func:`initialize` (or ``jax.distributed.initialize``) to
    have been called; single-process runs always return False.
    """
    if not jax.distributed.is_initialized():
        return False
    return jax.process_count() > 1


def process_index():
    return jax.process_index() if active() else 0


def process_count():
    return jax.process_count() if active() else 1


def is_primary():
    """True on the process that owns output writing (process 0)."""
    return process_index() == 0


def stripe():
    """(process_id, n_processes) input-shard assignment, or None.

    The per-host BAM-shard analog of the reference's per-contig worker
    pool (reference discovery/pipeline.py:734–792): host *i* consumes
    chunk/batch stripe ``i mod n`` of each input stream.
    """
    return (process_index(), process_count()) if active() else None


def allgather_bytes(payload):
    """Gather one bytes payload from every process, in process order."""
    from jax.experimental import multihost_utils

    arr = np.frombuffer(payload, dtype=np.uint8)
    n = np.array([arr.shape[0]], dtype=np.int64)
    sizes = np.asarray(multihost_utils.process_allgather(n)).reshape(-1)
    cap = max(1, int(sizes.max()))
    padded = np.zeros(cap, dtype=np.uint8)
    padded[:arr.shape[0]] = arr
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    gathered = gathered.reshape(process_count(), cap)
    return [gathered[i, :int(sizes[i])].tobytes()
            for i in range(process_count())]


def allgather_object(obj):
    """Gather one picklable object from every process (process order)."""
    import pickle

    return [pickle.loads(b)
            for b in allgather_bytes(pickle.dumps(obj, protocol=4))]


def merge_counts(keys, counts):
    """Merge per-host (keys, counts) partial k-mer counts globally.

    Every process contributes the sorted output of its local stream
    counter; the merged result (concatenate → lexsort → segment-sum)
    is identical on every host and equal to a single-process count of
    the union of the input stripes.
    """
    parts = allgather_object((np.asarray(keys), np.asarray(counts)))
    all_keys = np.concatenate([p[0] for p in parts], axis=0)
    all_counts = np.concatenate([p[1] for p in parts], axis=0)
    if all_keys.shape[0] == 0:
        return all_keys, all_counts
    order = enc.lexsort_keys(all_keys)
    sk = all_keys[order]
    sc = all_counts[order]
    new = np.empty(sk.shape[0], dtype=bool)
    new[0] = True
    new[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    seg = np.cumsum(new) - 1
    merged = np.zeros(int(seg[-1]) + 1, dtype=np.int64)
    np.add.at(merged, seg, sc.astype(np.int64))
    return sk[new], merged


# Transient-memory accounting of the last owner-sharded merge: every
# field is bytes (or a ratio) observed on THIS process.  The 1/N
# memory contract is tested against these (tests/test_multihost.py).
LAST_MERGE_STATS = {}


def _fmix32(x):
    """murmur3's 32-bit finaliser (numpy, uint32 in and out)."""
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def route_hash(words):
    """Uniform uint32 hash of each (N, W) uint32 key row."""
    h = np.zeros(words.shape[0], dtype=np.uint32)
    for j in range(words.shape[1]):
        h = _fmix32(h ^ words[:, j])
    return h


def _owner_of_keys(keys, n):
    """Stable uniform owner process for each (N, W) uint32 key row.

    Fixed-point scale of the fmix32 chain over the key words, so
    ownership is identical on every host and independent of input
    order.
    """
    h = route_hash(np.ascontiguousarray(keys, np.uint32))
    return ((h.astype(np.uint64) * np.uint64(n))
            >> np.uint64(32)).astype(np.int64)


def _merge_sorted_parts(parts_keys, parts_counts):
    """Concatenate per-host partials and segment-sum equal keys."""
    all_keys = np.concatenate(parts_keys, axis=0)
    all_counts = np.concatenate(parts_counts, axis=0)
    if all_keys.shape[0] == 0:
        return all_keys, all_counts.astype(np.int64)
    order = enc.lexsort_keys(all_keys)
    sk = all_keys[order]
    sc = all_counts[order]
    new = np.empty(sk.shape[0], dtype=bool)
    new[0] = True
    new[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    seg = np.cumsum(new) - 1
    merged = np.zeros(int(seg[-1]) + 1, dtype=np.int64)
    np.add.at(merged, seg, sc.astype(np.int64))
    return sk[new], merged


def merge_counts_sharded(keys, counts):
    """Owner-sharded merge of per-host partial counts.

    Unlike :func:`merge_counts`, NO process ever materializes the
    global table: each host routes its partial rows to their hash
    owner in N allgather rounds (non-owners drop a round's payload
    immediately), so per-host transient memory is O(total / N) and
    the returned ``(keys, counts)`` hold ONLY this process's shard —
    disjoint across processes, union = the global merge.  Threshold
    filters then apply shard-locally and only survivors gather
    (:func:`allgather_keys_sorted`).

    Replaces the page-cache-shared global mmap of the reference's
    worker pool (reference core/jellyfish_wrappers.py:376–381) with
    a partitioned-ownership design at WGS table scales (BASELINE.md
    Module-1 envelope 80–120 GB).
    """
    import pickle

    keys = np.asarray(keys)
    counts = np.asarray(counts)
    n = process_count()
    me = process_index()
    if n == 1:
        k, c = _merge_sorted_parts([keys], [counts])
        LAST_MERGE_STATS.update(
            n_processes=1, local_in_bytes=keys.nbytes + counts.nbytes,
            peak_round_bytes=0, shard_out_bytes=k.nbytes + c.nbytes)
        return k, c
    owner = _owner_of_keys(keys, n)
    order = np.argsort(owner, kind="stable")
    so = owner[order]
    bounds = np.searchsorted(so, np.arange(n + 1))
    sk = keys[order]
    sc = counts[order]
    mine_k = None
    peak_round = 0
    for d in range(n):
        sl = slice(bounds[d], bounds[d + 1])
        payload = pickle.dumps((sk[sl], sc[sl]), protocol=4)
        parts = allgather_bytes(payload)
        round_bytes = sum(len(b) for b in parts)
        peak_round = max(peak_round, round_bytes)
        if d == me:
            loaded = [pickle.loads(b) for b in parts]
            mine_k, mine_c = _merge_sorted_parts(
                [p[0] for p in loaded], [p[1] for p in loaded])
        # non-owners drop this round's parts before the next gather
        del parts
    LAST_MERGE_STATS.update(
        n_processes=n, local_in_bytes=keys.nbytes + counts.nbytes,
        peak_round_bytes=peak_round,
        shard_out_bytes=mine_k.nbytes + mine_c.nbytes)
    return mine_k, mine_c


def allgather_keys_sorted(keys):
    """Gather disjoint per-process key shards into the global sorted
    key array (identical on every host; lexicographic order matches
    the single-process pipeline's sorted tables)."""
    parts = allgather_object(np.asarray(keys))
    parts = [p for p in parts if p.shape[0]]
    if not parts:
        return np.asarray(keys).reshape(0, np.asarray(keys).shape[-1]
                                        if np.asarray(keys).ndim > 1
                                        else 1)
    merged = np.concatenate(parts, axis=0)
    return merged[enc.lexsort_keys(merged)]


def sum_aligned(values):
    """Element-wise sum of one aligned array across all processes."""
    from jax.experimental import multihost_utils

    stacked = np.asarray(multihost_utils.process_allgather(
        np.asarray(values)))
    return stacked.reshape((process_count(),) + np.asarray(values).shape
                           ).sum(axis=0)


def global_mesh():
    """1-D mesh over every device of every process."""
    return Mesh(np.array(jax.devices()), (AXIS,))


def sharded_count_multihost(codes, lengths, k, mesh=None,
                            cap_per_shard=None, per_process=False):
    """Distributed canonical k-mer count with per-host input feeds.

    Same collective program as the single-host
    :func:`~kmer_denovo_filter_tpu.parallel.sharded_count` (via
    :func:`make_count_program`); inputs are process-local batches.

    With ``per_process=False`` the merged ``(keys, counts)`` result
    gathers tiled to every host (fine at GIAB scale; O(global table)
    per host).  With ``per_process=True`` NO cross-host table gather
    happens at all: each process reads only its local devices' hash
    shards (``addressable_shards``), returning its disjoint slice of
    the global table — per-host memory is O(total / n_processes), the
    owner-resident contract of :func:`merge_counts_sharded`.
    """
    from jax.experimental import multihost_utils

    if mesh is None:
        mesh = global_mesh()
    n_shards = int(mesh.devices.size)
    w = enc.words_per_kmer(k)
    s = codes.shape[1] - k + 1
    codes_g, lens_g = distribute_read_batch(codes, lengths, mesh)
    per_shard = codes_g.shape[0] // n_shards
    if cap_per_shard is None:
        cap_per_shard = max(16, int(per_shard * s / n_shards * 4))

    while True:
        skeys, starts, counts, overflow = make_count_program(
            mesh, n_shards, k, w, cap_per_shard)(codes_g, lens_g)
        overflow = multihost_utils.process_allgather(
            overflow, tiled=True)
        if not bool(np.asarray(overflow).any()):
            break
        cap_per_shard *= 2

    if per_process:
        # local-shard extraction only — no table ever crosses hosts
        out_keys = []
        out_counts = []
        for sh_k, sh_s, sh_c in zip(skeys.addressable_shards,
                                    starts.addressable_shards,
                                    counts.addressable_shards):
            kk = np.asarray(sh_k.data).reshape(-1, w)
            ss = np.asarray(sh_s.data).reshape(-1)
            cc = np.asarray(sh_c.data).reshape(-1)
            out_keys.append(kk[ss])
            out_counts.append(cc[ss].astype(np.int64))
        keys = np.concatenate(out_keys, axis=0)
        cnts = np.concatenate(out_counts, axis=0)
        order = enc.lexsort_keys(keys)
        return keys[order], cnts[order]

    skeys = np.asarray(
        multihost_utils.process_allgather(skeys, tiled=True))
    starts = np.asarray(
        multihost_utils.process_allgather(starts, tiled=True))
    counts = np.asarray(
        multihost_utils.process_allgather(counts, tiled=True))
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
