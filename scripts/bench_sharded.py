#!/usr/bin/env python3
"""Sharded-scaling analysis on a virtual device mesh.

Validates the *structure* of the multi-device design (the BASELINE
scaling-efficiency metric's prerequisites) on an N-device virtual CPU
mesh, with no accelerator:

* per-shard key balance of the hash-prefix table partitioning
  (imbalance -> stragglers -> lost scaling efficiency),
* per-shard query routing balance of a coverage-skewed batch,
* the all-to-all routed byte volume per batch (the interconnect term),
* agreement of sharded membership/tally with the single-device engine.

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python scripts/bench_sharded.py [n_devices]

The scaling model this validates (PERF.md): per-chip work is
N_windows/S sort+sweep plus one all-to-all of ~8 bytes/window; with
balanced shards the efficiency loss is the all-to-all time fraction,
which rides the device interconnect (NVLink on a GPU host).
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from kmer_denovo_filter_tpu import engine as eng
    from kmer_denovo_filter_tpu.ops import device as dev
    from kmer_denovo_filter_tpu.ops import encode as enc
    from kmer_denovo_filter_tpu.parallel import sharded as sh

    n_dev = int(sys.argv[1]) if len(sys.argv) > 1 else len(
        jax.devices())
    mesh = sh.make_mesh(n_dev)
    k = 31
    w = enc.words_per_kmer(k)
    rng = np.random.default_rng(0)

    # hash-prefix table balance
    m = 1 << 18
    keys = rng.integers(0, 2 ** 32, (m, w), dtype=np.uint32)
    keys[:, 0] &= 0x7FFFFFFF
    owner = sh.hash_owner(keys, n_dev)
    per_shard = np.bincount(owner, minlength=n_dev)
    table_imbalance = per_shard.max() / max(1.0, per_shard.mean())

    # coverage-skewed query batch (40x duplication, like a sorted BAM)
    genome = rng.integers(0, 4, 200_000, dtype=np.uint8)
    b, length = 4096, 160
    starts = rng.integers(0, genome.size - length, b)
    codes = np.stack([genome[s:s + length] for s in starts])
    lens = np.full(b, 150, np.int32)
    import jax.numpy as jnp
    qk, valid = dev.extract_canonical_windows(
        jnp.asarray(codes), jnp.asarray(lens), k)
    flat = np.asarray(qk.reshape(-1, w))
    flat = flat[np.asarray(valid).reshape(-1)]
    q_owner = sh.hash_owner(flat, n_dev)
    q_per_shard = np.bincount(q_owner, minlength=n_dev)
    query_imbalance = q_per_shard.max() / max(1.0, q_per_shard.mean())
    a2a_bytes = int(flat.shape[0]) * w * 4  # routed key volume/batch

    # correctness: sharded membership == single-device engine
    sidx = sh.ShardedKmerIndex(keys, k, mesh)
    sub = flat[:: max(1, flat.shape[0] // 5000)]
    got = sidx.membership(sub)
    want = eng.KmerIndex(keys, k).membership(sub)
    assert np.array_equal(got, want), "sharded membership mismatch"

    print(json.dumps({
        "n_devices": n_dev,
        "table_keys": int(m),
        "table_imbalance_max_over_mean": round(
            float(table_imbalance), 4),
        "query_windows": int(flat.shape[0]),
        "query_imbalance_max_over_mean": round(
            float(query_imbalance), 4),
        "all_to_all_bytes_per_batch": a2a_bytes,
        "membership_parity": True,
    }))


if __name__ == "__main__":
    main()
