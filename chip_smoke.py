#!/usr/bin/env python3
"""Smoke run of the trio k-mer engine on an NVIDIA GPU.

Drives the main path once through the entry points a user calls and
checks every output exactly (the k-mer path is integer-only: counts,
masks and output bytes must be equal, not close):

1. device: JAX must report a GPU; prints the card's name and power
   limit, the device kind, the JAX version and whether the native host
   library (``kdf_native``) loaded;
2. VCF mode through ``cli.vcf_main`` on the committed GIAB mini trio:
   12 likely de novo / 10 inherited, data lines equal to
   ``tests/goldens/annotated.vcf.gz``;
3. discovery through ``cli.discovery_main``: the ``.bed``,
   ``.kmer_coverage.bedgraph``, ``.read_coverage.bed``,
   ``.metrics.json`` and ``.summary.txt`` byte-equal to
   ``tests/goldens/giab_discovery.*``;
4. the engine at deployment size through its public constructors:
   k = 31 tables of 4,096 (a VCF-mode candidate table), 2^24 (a WGS
   discovery parent filter) and 2^29 keys (whole-genome reference
   scale, 4 GiB on the device), and k = 63 at 2^24 keys, each against
   ≥ 1 M synthetic 152 bp reads through the bucketed probe; tallies,
   hit masks and the stream count equal a numpy oracle.

``--four`` runs only the four-card phase instead: the sharded engine
(``ShardedStreamCounter``, ``ShardedFilteredCounter``,
``ShardedKmerIndex`` + ``sharded_scan_reads_for_hits``) on a 4-device
mesh against the one-card engine on the same 2^24-key table and reads.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; a failed
phase exits non-zero before it.  Usage: ``python chip_smoke.py
[--four] [--seed N]``.
"""

import argparse
import filecmp
import gzip
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GIAB = os.path.join(REPO, "tests", "data", "giab")
GOLD = os.path.join(REPO, "tests", "goldens")

N_READS = 1 << 20
BATCH_READS = 32768
READ_LEN = 152
SMALL_M = 4096
MID_M = 1 << 24
BIG_M = 1 << 29

# (chrom, pos) → VCF annotation fields allowed to differ from the
# golden: the upstream parent-BAM drift documented in PARITY.md
# (tests/test_example_output.py DRIFTED_PKC_FIELDS)
DRIFTED_PKC_FIELDS = {
    ("chr11", "55007083"): {"MAX_PKC", "AVG_PKC", "MIN_PKC",
                            "MAX_PKC_ALT", "AVG_PKC_ALT", "MIN_PKC_ALT"},
    ("chr11", "55007104"): {"MAX_PKC", "AVG_PKC", "MIN_PKC",
                            "MAX_PKC_ALT", "AVG_PKC_ALT", "MIN_PKC_ALT"},
    ("chr15", "35009535"): {"AVG_PKC"},
}
ANNOTATION_KEYS = ["DKU", "DKT", "DKA", "DKU_DKT", "DKA_DKT", "MAX_PKC",
                   "AVG_PKC", "MIN_PKC", "MAX_PKC_ALT", "AVG_PKC_ALT",
                   "MIN_PKC_ALT"]
DISCOVERY_SUFFIXES = (".bed", ".kmer_coverage.bedgraph",
                      ".read_coverage.bed", ".metrics.json",
                      ".summary.txt")


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ── phase 2: VCF mode ───────────────────────────────────────────────

def _vcf_data_lines(path):
    with gzip.open(path, "rt") as fh:
        return [l.rstrip("\n") for l in fh if not l.startswith("#")]


def compare_vcf(got_path, gold_path):
    """Data lines equal, except the whitelisted drift fields."""
    got, exp = _vcf_data_lines(got_path), _vcf_data_lines(gold_path)
    check(len(got) == len(exp),
          f"VCF: {len(got)} data lines, golden has {len(exp)}")
    for g, e in zip(got, exp):
        if g == e:
            continue
        fg, fe = g.split("\t"), e.split("\t")
        allowed = DRIFTED_PKC_FIELDS.get((fe[0], fe[1]), set())
        check(fg[:9] == fe[:9], f"VCF: record {fe[0]}:{fe[1]} differs")
        for key, a, b in zip(ANNOTATION_KEYS, fg[9].split(":")[-11:],
                             fe[9].split(":")[-11:]):
            check(a == b or key in allowed,
                  f"VCF: {fe[0]}:{fe[1]} {key} {a} != golden {b}")


def summary_calls(path):
    """(likely de novo, inherited) counts of a VCF-mode summary."""
    likely = inherited = None
    with open(path) as fh:
        for line in fh:
            if "Likely de novo" in line:
                likely = int(line.split()[-1])
            elif "Inherited / unclear" in line:
                inherited = int(line.split()[-1])
    return likely, inherited


def phase_vcf(outdir, giab=GIAB, gold=GOLD):
    from kmer_denovo_filter_tpu import cli

    out_vcf = os.path.join(outdir, "annotated.vcf.gz")
    summary = os.path.join(outdir, "summary.txt")
    t = time.perf_counter()
    cli.vcf_main([
        "--child", os.path.join(giab, "HG002_child.bam"),
        "--mother", os.path.join(giab, "HG004_mother.bam"),
        "--father", os.path.join(giab, "HG003_father.bam"),
        "--vcf", os.path.join(giab, "candidates.vcf.gz"),
        "--output", out_vcf,
        "--metrics", os.path.join(outdir, "metrics.json"),
        "--summary", summary,
        "--proband-id", "HG002",
    ])
    wall = time.perf_counter() - t
    calls = summary_calls(summary)
    check(calls == (12, 10), f"VCF summary: {calls}, expected (12, 10)")
    compare_vcf(out_vcf, os.path.join(gold, "annotated.vcf.gz"))
    log(f"vcf: ok — 12 likely de novo, 10 inherited; data lines match "
        f"the golden; wall {wall:.1f} s")
    return summary


# ── phase 3: discovery ──────────────────────────────────────────────

def phase_discovery(outdir, candidate_summary, giab=GIAB, gold=GOLD):
    from kmer_denovo_filter_tpu import cli

    prefix = os.path.join(outdir, "giab_discovery")
    t = time.perf_counter()
    cli.discovery_main([
        "--child", os.path.join(giab, "HG002_child.bam"),
        "--mother", os.path.join(giab, "HG004_mother.bam"),
        "--father", os.path.join(giab, "HG003_father.bam"),
        "--ref-fasta", os.path.join(giab, "mini_ref.fa"),
        "--ref-jf", os.path.join(giab, "mini_ref.fa.k31.jf"),
        "--out-prefix", prefix,
        "--min-child-count", "3",
        "--kmer-size", "31",
        "--candidate-summary", candidate_summary,
    ])
    wall = time.perf_counter() - t
    for suffix in DISCOVERY_SUFFIXES:
        check(filecmp.cmp(prefix + suffix,
                          os.path.join(gold, "giab_discovery" + suffix),
                          shallow=False),
              f"discovery: giab_discovery{suffix} differs from golden")
    log(f"discovery: ok — {len(DISCOVERY_SUFFIXES)} outputs byte-equal "
        f"to the goldens; wall {wall:.1f} s")


# ── phase 4: engine at deployment size ──────────────────────────────

class Oracle:
    """Per-batch numpy truth for one k: the batch's distinct window
    keys (sortable view), their counts, and each window's index into
    them.  Memberships against any sorted table follow from one
    ``np.searchsorted`` of the distinct keys."""

    def __init__(self, batches, k):
        from concurrent.futures import ThreadPoolExecutor

        self.k = k
        # numpy releases the GIL in its array loops and sorts
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            self.parts = list(pool.map(self._batch, batches))

    def _batch(self, codes):
        import bench

        keys, valid = bench.canonical_windows_np(codes, self.k)
        uniq, inv, cnt = np.unique(bench.key_view(keys),
                                   return_inverse=True, return_counts=True)
        # invalid windows (an N inside) hold the all-ones sentinel
        sentinel = bench.key_view(np.full((1, keys.shape[1]), 0xFFFFFFFF,
                                          np.uint32))
        cnt[uniq == sentinel] = 0
        return (uniq, inv.astype(np.int32), cnt,
                valid.reshape(codes.shape[0], -1))

    def member(self, table_view, uniq):
        pos = np.searchsorted(table_view, uniq)
        pos_c = np.minimum(pos, len(table_view) - 1)
        return table_view[pos_c] == uniq, pos_c

    def tally(self, table_keys):
        """int64 count of every table key over all windows."""
        import bench

        tv = bench.key_view(table_keys)
        out = np.zeros(len(tv), dtype=np.int64)
        for uniq, _inv, cnt, _valid in self.parts:
            hit, pos = self.member(tv, uniq)
            out[pos[hit]] += cnt[hit]  # distinct keys: distinct rows
        return out

    def masks(self, table_keys):
        import bench

        tv = bench.key_view(table_keys)
        for uniq, inv, _cnt, valid in self.parts:
            hit, _pos = self.member(tv, uniq)
            yield hit[inv].reshape(valid.shape) & valid

    def stream_count(self):
        """(sorted distinct key views, counts) over every window."""
        allk = np.concatenate([p[0] for p in self.parts])
        allc = np.concatenate([p[2] for p in self.parts])
        uniq, inv = np.unique(allk, return_inverse=True)
        counts = np.bincount(inv, weights=allc).astype(np.int64)
        return uniq[counts > 0], counts[counts > 0]


def _rate(n_reads, seconds):
    return f"{n_reads / seconds:,.0f} reads/s"


def run_table(name, keys, k, batches, oracle, card, stats):
    """Tally + member scan of every batch against one table through
    ``make_parent_filter_counter`` and ``make_scanner``; exact vs the
    oracle.  Prints reads/s (first batch, with compilation, apart)."""
    import bench
    from kmer_denovo_filter_tpu import engine as eng

    lengths = np.full(batches[0].shape[0], READ_LEN, np.int32)
    t = time.perf_counter()
    fc = eng.make_parent_filter_counter(keys, k)
    build = time.perf_counter() - t
    check(type(fc) is eng.FilteredCounter,
          f"{name}: constructor chose {type(fc).__name__}")
    index = fc.index
    first, rate, counts = bench.timed_feed(fc, batches, lengths)
    want = oracle.tally(keys)
    check(np.array_equal(counts, want),
          f"{name}: tally differs from the oracle at "
          f"{int((counts != want).sum())} keys")
    sfirst, srate, masks = bench.timed_scan(eng.make_scanner(index),
                                            batches, lengths)
    for i, (got, exp) in enumerate(zip(masks, oracle.masks(keys))):
        check(np.array_equal(got, exp),
              f"{name}: hit mask of batch {i} differs from the oracle")
    n = sum(b.shape[0] for b in batches)
    hits = int(want.sum())
    check(hits > 0, f"{name}: no hits — the check would be vacuous")
    stats[name] = {"keys": len(keys), "k": k,
                   "tally_reads_per_s": rate, "scan_reads_per_s": srate}
    log(f"engine {name}: ok — {len(keys):,} keys, k={k}, "
        f"{n:,} reads, {hits:,} window hits; tally {rate:,.0f} "
        f"reads/s, scan {srate:,.0f} reads/s (first batch with "
        f"compile {first:.1f} s / {sfirst:.1f} s, table build "
        f"{build:.1f} s) [{card}]")


def make_reads(seed, n_reads=N_READS, batch=BATCH_READS):
    """(genome, batches, start0, span) of position-local reads."""
    import bench

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, bench.GENOME_BASES, dtype=np.uint8)
    span = bench.read_span(n_reads, READ_LEN)
    start0 = int(rng.integers(0, len(genome) - span - READ_LEN))
    reads = bench.synth_reads(rng, genome, n_reads, READ_LEN, start0)
    return (genome, [reads[i:i + batch] for i in range(0, n_reads, batch)],
            start0, span)


def phase_engine(seed, card, n_reads=N_READS, batch=BATCH_READS,
                 sizes=(SMALL_M, MID_M, BIG_M), wide_m=MID_M):
    """Every tier against the numpy oracle; returns per-tier stats."""
    import bench
    from kmer_denovo_filter_tpu import engine as eng

    rng = np.random.default_rng(seed + 1)
    genome, batches, start0, span = make_reads(seed, n_reads, batch)
    stats = {}
    t = time.perf_counter()
    oracle = Oracle(batches, 31)
    gk = bench.genome_keys(genome, start0, span, 31)
    log(f"engine: oracle for k=31 over {n_reads:,} reads in "
        f"{time.perf_counter() - t:.1f} s")

    # stream count (Module 1's jellyfish count -C analog)
    lengths = np.full(batch, READ_LEN, np.int32)
    sc = eng.make_stream_counter(31)
    check(type(sc) is eng.StreamCounter,
          f"stream counter: constructor chose {type(sc).__name__}")
    t = time.perf_counter()
    for codes in batches:
        sc.feed(codes, lengths)
    keys, counts = sc.result()
    wall = time.perf_counter() - t
    want_k, want_c = oracle.stream_count()
    check(np.array_equal(bench.key_view(keys), want_k)
          and np.array_equal(counts, want_c),
          "stream count differs from the oracle")
    stats["stream_count"] = {"reads_per_s": n_reads / wall}
    log(f"engine stream count: ok — {len(keys):,} distinct 31-mers, "
        f"{_rate(n_reads, wall)} (with compile) [{card}]")

    for m in sizes:
        keys = bench.table_keys(rng, m, gk, 31)
        run_table(f"k31_{m}", keys, 31, batches, oracle, card, stats)
        del keys
    del oracle, gk

    t = time.perf_counter()
    oracle = Oracle(batches, 63)
    keys = bench.table_keys(
        rng, wide_m, bench.genome_keys(genome, start0, span, 63), 63)
    log(f"engine: oracle + table for k=63 in "
        f"{time.perf_counter() - t:.1f} s")
    run_table(f"k63_{wide_m}", keys, 63, batches, oracle, card, stats)
    return stats


# ── --four: the sharded engine on a 4-device mesh ───────────────────

def phase_four(seed, card, n_devices=4, n_reads=N_READS,
               batch=BATCH_READS, m=MID_M):
    """Sharded stream count, filtered tally and member scan on an
    *n_devices* mesh, each equal to the one-device engine."""
    import jax

    import bench
    from kmer_denovo_filter_tpu import engine as eng
    from kmer_denovo_filter_tpu.parallel import (
        ShardedFilteredCounter,
        ShardedKmerIndex,
        make_mesh,
        sharded_scan_reads_for_hits,
    )

    check(len(jax.devices()) >= n_devices,
          f"--four needs {n_devices} devices, JAX sees "
          f"{len(jax.devices())}")
    rng = np.random.default_rng(seed + 1)
    genome, batches, start0, span = make_reads(seed, n_reads, batch)
    keys = bench.table_keys(rng, m, bench.genome_keys(
        genome, start0, span, 31), 31)
    lengths = np.full(batch, READ_LEN, np.int32)
    mesh = make_mesh(n_devices)

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    def stream(counter):
        for codes in batches:
            counter.feed(codes, lengths)
        return counter.result()

    (k1, c1), t1 = timed(lambda: stream(eng.StreamCounter(31)))
    (k4, c4), t4 = timed(lambda: stream(
        eng.ShardedStreamCounter(31, mesh)))
    check(np.array_equal(k1, k4) and np.array_equal(c1, c4),
          "sharded stream count differs from one device")
    log(f"four stream count: ok — {len(k1):,} distinct 31-mers; one "
        f"device {_rate(n_reads, t1)}, {n_devices} devices "
        f"{_rate(n_reads, t4)} (with compile) [{card}]")

    index = eng.KmerIndex(keys, 31)
    _f, r1, tally1 = bench.timed_feed(eng.FilteredCounter(index),
                                      batches, lengths)
    _f, r4, tally4 = bench.timed_feed(
        ShardedFilteredCounter(keys, 31, mesh), batches, lengths)
    check(np.array_equal(tally1, tally4),
          "sharded tally differs from one device")
    check(tally1.sum() > 0, "four: no hits — the check would be vacuous")
    log(f"four tally: ok — {m:,} keys, {int(tally1.sum()):,} hits; one "
        f"device {r1:,.0f} reads/s, {n_devices} devices {r4:,.0f} "
        f"reads/s [{card}]")

    sharded = ShardedKmerIndex(keys, 31, mesh)
    _f, s1, m1 = bench.timed_scan(
        lambda c, l: eng.scan_reads_for_hits(index, c, l), batches,
        lengths)
    _f, s4, m4 = bench.timed_scan(
        lambda c, l: sharded_scan_reads_for_hits(sharded, c, l),
        batches, lengths)
    check(all(np.array_equal(a, b) for a, b in zip(m1, m4)),
          "sharded hit masks differ from one device")
    log(f"four scan: ok — one device {s1:,.0f} reads/s, {n_devices} "
        f"devices {s4:,.0f} reads/s [{card}]")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card sharded phase")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax

    from kmer_denovo_filter_tpu import runtime
    from kmer_denovo_filter_tpu.htsio import native

    cache = runtime.enable_compile_cache()
    device = runtime.require_gpu()
    card = runtime.gpu_name_power()
    sys.path.insert(0, REPO)  # bench.py's synthetic data + oracle
    log(f"card: {card}")
    native_state = ("loaded" if native.available()
                    else "NOT loaded (Python fallback)")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"jax {jax.__version__}: {device['count']} x {device['kind']} "
        f"({device['platform']}); kdf_native {native_state}; bytes_limit "
        f"{stats.get('bytes_limit')}; compile cache {cache}")
    if args.four:
        phase_four(args.seed, card)
    else:
        with tempfile.TemporaryDirectory() as outdir:
            summary = phase_vcf(outdir)
            phase_discovery(outdir, summary)
        phase_engine(args.seed, card)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
