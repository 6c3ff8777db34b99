#!/usr/bin/env python3
"""Benchmark of the filtered k-mer counting engine on one GPU.

Every cell drives the engine through its public constructors
(``engine.make_parent_filter_counter`` / ``make_scanner``), tally and
anchoring member scan:

* ``vcf`` — the VCF-mode parent scan: canonical 31-mer extraction +
  filtered tally against a 4,096-key child candidate table;
* ``wgs`` — the same against a 2^24-key table (discovery Module 2);
* ``wide`` — k = 63 and 101 against a 2^24-key table;
* ``sizes`` — the rate across table sizes, 2^12 … 2^28 keys;
* ``decode`` / ``e2e`` — host BGZF/BAM decode alone, and decode →
  transfer → device tally on a synthetic BAM.

Reads are sampled position-locally from a synthetic genome at ~40×
coverage with 0.3% error — the locality profile of a coordinate-sorted
WGS BAM — from ``--seed``.  The reference's ``samtools fasta |
jellyfish count -C --if`` pipe runs ~1.0 M reads/s for 150 bp reads on
a 16-core host (reference core/jellyfish_wrappers.py:115–283).

Prints the device (JAX platform, device kind, count; nvidia-smi name
and power limit) and one JSON line.  Exits without a number when JAX
finds no GPU.  Usage: ``python bench.py [--cells vcf,wgs,...]``.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

K = 31
READ_LEN = 152
BATCH_READS = 32768
TABLE_M = 4096              # VCF-mode child candidate table scale
WGS_TABLE_M = 1 << 24       # discovery parent-filter scale
N_BATCHES = 16
N_BATCHES_E2E = 4
COVERAGE = 40
GENOME_BASES = 4 << 20
BASELINE_READS_PER_S = 1.0e6
ALL_CELLS = ("vcf", "wgs", "wide", "sizes", "decode", "e2e")


# ── synthetic data (shared with chip_smoke.py) ──────────────────────

def read_span(n_reads, read_len):
    """Genome bases that *n_reads* reads cover at ``COVERAGE``."""
    return max(n_reads * read_len // COVERAGE, read_len * 4)


def synth_reads(rng, genome, n_reads, read_len, start0=None):
    """Position-local reads with 0.3% error, like a sorted WGS BAM:
    sorted starts over ``read_span`` bases from *start0*."""
    span = read_span(n_reads, read_len)
    if start0 is None:
        start0 = rng.integers(0, len(genome) - span - read_len)
    starts = np.sort(rng.integers(start0, start0 + span, n_reads))
    idx = starts[:, None] + np.arange(read_len)[None, :]
    reads = genome[idx]
    err = rng.random((n_reads, read_len)) < 0.003
    reads = np.where(err, (reads + rng.integers(
        1, 4, (n_reads, read_len))) % 4, reads).astype(np.uint8)
    return reads


def canonical_windows_np(codes, k):
    """Numpy oracle: canonical keys of every k-window of (B, L) code
    rows, in window order ((B·S, W) uint32 + validity), via the host
    encoder (ops/encode.py) — independent of the device extraction."""
    from numpy.lib.stride_tricks import sliding_window_view

    from kmer_denovo_filter_tpu.ops import encode as enc

    win = sliding_window_view(codes, k, axis=1).reshape(-1, k)
    return enc.canonical_keys(np.ascontiguousarray(win))


def key_view(keys):
    """(N, W) uint32 keys → one sortable scalar per row: uint64 for
    W == 2, big-endian bytes otherwise (both order like the words)."""
    keys = np.ascontiguousarray(keys, np.uint32)
    if keys.shape[1] == 2:
        return (keys[:, 0].astype(np.uint64) << np.uint64(32)) \
            | keys[:, 1].astype(np.uint64)
    return np.ascontiguousarray(keys.astype(">u4")).view(
        f"S{4 * keys.shape[1]}").ravel()


def gap_keys(rng, n, k):
    """*n* distinct valid-format keys, sorted by construction.

    The leading 64 key bits are cumulative random gaps — strictly
    increasing, so the host never sorts the table; any further words
    are random.  Keys are 2k bits left-aligned (low bits clear), so no
    row is the all-ones sentinel.
    """
    from kmer_denovo_filter_tpu.ops import encode as enc

    w = enc.words_per_kmer(k)
    lead_bits = min(2 * k, 64)
    mean_gap = (1 << lead_bits) // n
    gaps = rng.integers(1, max(2, int(mean_gap * 1.8)), size=n,
                        dtype=np.uint64)
    lead = np.cumsum(gaps, dtype=np.uint64)
    lead <<= np.uint64(64 - lead_bits)
    out = np.empty((n, w), dtype=np.uint32)
    out[:, 0] = (lead >> np.uint64(32)).astype(np.uint32)
    out[:, 1] = (lead & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    del gaps, lead
    if w > 2:
        out[:, 2:] = rng.integers(0, 1 << 32, size=(n, w - 2),
                                  dtype=np.uint32)
        rem = (2 * k) % 32
        if rem:
            out[:, -1] &= np.uint32(((1 << rem) - 1) << (32 - rem))
    return out


def union_sorted(a, b):
    """Union of two sorted unique (N, W) key arrays without a sort of
    the whole: *b*'s new rows are inserted at their searchsorted
    positions."""
    va, vb = key_view(a), key_view(b)
    pos = np.searchsorted(va, vb)
    dup = np.zeros(len(vb), dtype=bool)
    inb = pos < len(va)
    dup[inb] = va[pos[inb]] == vb[inb]
    return np.insert(a, pos[~dup], b[~dup], axis=0)


def genome_keys(genome, start0, span, k):
    """Sorted distinct canonical k-mer keys of ``genome[start0:+span]``."""
    from kmer_denovo_filter_tpu.ops import encode as enc

    keys, valid = canonical_windows_np(
        genome[None, start0:start0 + span], k)
    uniq, _ = enc.unique_with_counts(keys[valid])
    return uniq


def table_keys(rng, n_total, genome_uniq, k, genome_share=0.5):
    """A sorted table of ≤ *n_total* keys: a random *genome_share* of
    the genome's k-mers (so reads hit; at most half the table) among
    gap keys."""
    n_pick = min(int(len(genome_uniq) * genome_share), n_total // 2)
    pick = genome_uniq[np.sort(rng.choice(len(genome_uniq), n_pick,
                                          replace=False))]
    return union_sorted(gap_keys(rng, n_total - n_pick, k), pick)


# ── timing ──────────────────────────────────────────────────────────

def timed_feed(counter, batches, lengths):
    """Feed every batch; returns (compile-inclusive first-batch
    seconds, steady reads/s over the rest, counts).  ``result()``
    fetches the tally, so the clock stops after the device is done."""
    import jax

    t0 = time.perf_counter()
    counter.feed(batches[0], lengths)
    # every device array the counter holds (tally, deferred flags)
    jax.block_until_ready(vars(counter))
    t1 = time.perf_counter()
    for codes in batches[1:]:
        counter.feed(codes, lengths)
    counts = counter.result()
    t2 = time.perf_counter()
    rest = sum(b.shape[0] for b in batches[1:])
    return t1 - t0, rest / (t2 - t1), counts


def timed_scan(scan, batches, lengths):
    """Scan every batch (each returns a host mask); returns (first
    seconds, steady reads/s, masks)."""
    t0 = time.perf_counter()
    masks = [scan(batches[0], lengths)]
    t1 = time.perf_counter()
    masks += [scan(codes, lengths) for codes in batches[1:]]
    t2 = time.perf_counter()
    rest = sum(b.shape[0] for b in batches[1:])
    return t1 - t0, rest / (t2 - t1), masks


# ── cells ───────────────────────────────────────────────────────────

def _batches(rng, genome, n_batches, read_len=READ_LEN):
    span = read_span(BATCH_READS * n_batches, read_len)
    start0 = int(rng.integers(0, len(genome) - span - read_len))
    reads = synth_reads(rng, genome, BATCH_READS * n_batches, read_len,
                        start0)
    return ([reads[i * BATCH_READS:(i + 1) * BATCH_READS]
             for i in range(n_batches)], start0, span)


def cell_table(rng, genome, n_keys, k, prefix, read_len=READ_LEN,
               n_batches=N_BATCHES):
    """Filtered tally + member scan against an *n_keys* table, through
    ``make_parent_filter_counter`` and ``make_scanner``."""
    from kmer_denovo_filter_tpu import engine as eng

    batches, start0, span = _batches(rng, genome, n_batches, read_len)
    lengths = np.full(BATCH_READS, read_len, np.int32)
    keys = table_keys(rng, n_keys, genome_keys(genome, start0, span, k),
                      k)
    fc = eng.make_parent_filter_counter(keys, k)
    first, rate, counts = timed_feed(fc, batches, lengths)
    sfirst, srate, _m = timed_scan(eng.make_scanner(fc.index), batches,
                                   lengths)
    return {f"{prefix}_tally_reads_per_s": rate,
            f"{prefix}_scan_reads_per_s": srate,
            f"{prefix}_first_batch_s": [first, sfirst],
            f"{prefix}_hits": int(counts.sum())}


def cell_sizes(rng, genome):
    """Tally and scan reads/s across table sizes (the probe's rate
    against 2^12 … 2^28 keys), six batches each."""
    out = {}
    for log_m in (12, 16, 20, 24, 28):
        out.update(cell_table(rng, genome, 1 << log_m, K,
                              f"sizes_m2^{log_m}", n_batches=6))
    return out


def _write_synth_bam(rng, genome, n_reads, path):
    """Synthetic coordinate-sorted BAM of position-local reads."""
    from kmer_denovo_filter_tpu.htsio.bam import BamWriter, encode_read

    reads = synth_reads(rng, genome, n_reads, READ_LEN)
    header = ("@HD\tVN:1.6\tSO:coordinate\n"
              f"@SQ\tSN:chr1\tLN:{len(genome)}\n")
    w = BamWriter(path, header, [("chr1", len(genome))])
    bases = np.array(list("ACGT"), dtype="U1")
    quals = [40] * READ_LEN
    cigar = [(0, READ_LEN)]
    for i in range(n_reads):
        seq = "".join(bases[reads[i]])
        raw = encode_read(f"r{i}", 0, 0, 1000 + i, 60, cigar, seq,
                          quals)
        w.write_raw(0, 1000 + i, raw)
    w.close()
    return reads


def cell_decode(rng, genome, tmpdir):
    """Decode-only rate of the streaming WGS input path (no device).

    Times ``stream_packed`` — pooled BGZF inflate + C++ whole-record
    chunk walk + 2-bit code extraction — the producer that must
    outrun the device step (reference analog: ``samtools fasta -@
    threads``, jellyfish_wrappers.py:158–165), at 1, 2, 4 threads and
    all cores.
    """
    from kmer_denovo_filter_tpu.htsio.bam import stream_packed

    n_reads = BATCH_READS * 8
    path = os.path.join(tmpdir, "decode.bam")
    _write_synth_bam(rng, genome, n_reads, path)
    ncpu = os.cpu_count() or 1
    out = {"decode_host_cpus": ncpu}
    old = os.environ.get("KDF_BGZF_THREADS")
    try:
        for threads in sorted({1, 2, 4} | {ncpu}):
            os.environ["KDF_BGZF_THREADS"] = str(threads)
            # warm pass fills the page cache; timed pass measures
            for _ in range(2):
                start = time.perf_counter()
                total = 0
                for codes, _lens in stream_packed(
                        path, 0xD00, BATCH_READS):
                    total += codes.shape[0]
                elapsed = time.perf_counter() - start
            assert total == n_reads, (total, n_reads)
            out[f"decode_reads_per_s_{threads}t"] = total / elapsed
    finally:
        if old is None:
            os.environ.pop("KDF_BGZF_THREADS", None)
        else:
            os.environ["KDF_BGZF_THREADS"] = old
    return out


def cell_e2e(rng, genome, tmpdir):
    """Host BAM decode → transfer → device tally (4,096-key table),
    decode overlapped with the device step by the engine's deferred
    overflow check."""
    from kmer_denovo_filter_tpu import engine as eng
    from kmer_denovo_filter_tpu.htsio.bam import stream_packed

    n_reads = BATCH_READS * N_BATCHES_E2E
    path = os.path.join(tmpdir, "bench.bam")
    reads = _write_synth_bam(rng, genome, n_reads, path)
    keys = union_sorted(gap_keys(rng, TABLE_M // 2, K),
                        key_rows_of(reads[:16]))

    def run():
        fc = eng.FilteredCounter(eng.KmerIndex(keys, K))
        total = 0
        for codes, lens in stream_packed(path, 0xD00, BATCH_READS):
            fc.feed(codes, lens)
            total += codes.shape[0]
        return total, fc.result()

    run()  # compile + page cache
    start = time.perf_counter()
    total, _counts = run()
    return {"e2e_reads_per_s": total / (time.perf_counter() - start)}


def key_rows_of(reads, k=K):
    """Sorted distinct canonical keys of some reads (table seeds)."""
    from kmer_denovo_filter_tpu.ops import encode as enc

    keys, valid = canonical_windows_np(reads, k)
    return enc.unique_with_counts(keys[valid])[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cells", default=",".join(ALL_CELLS),
                        help="comma list of " + ", ".join(ALL_CELLS))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    from kmer_denovo_filter_tpu import runtime

    runtime.enable_compile_cache()
    device = runtime.require_gpu()
    card = runtime.gpu_name_power()
    print(f"device: {device} | nvidia-smi: {card}", flush=True)

    rng = np.random.default_rng(args.seed)
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    cells = args.cells.split(",")
    details = {}
    for cell in cells:
        t = time.perf_counter()
        if cell == "vcf":
            res = cell_table(rng, genome, TABLE_M, K, "vcf")
        elif cell == "wgs":
            res = cell_table(rng, genome, WGS_TABLE_M, K, "wgs")
        elif cell == "wide":
            res = cell_table(rng, genome, WGS_TABLE_M, 63, "wgs_k63")
            res.update(cell_table(rng, genome, WGS_TABLE_M, 101,
                                  "wgs_k101"))
        elif cell == "sizes":
            res = cell_sizes(rng, genome)
        elif cell in ("decode", "e2e"):
            with tempfile.TemporaryDirectory() as tmpdir:
                res = (cell_decode if cell == "decode" else cell_e2e)(
                    rng, genome, tmpdir)
        else:
            raise SystemExit(f"unknown cell {cell!r}")
        res[f"{cell}_wall_s"] = time.perf_counter() - t
        print(f"{cell}: {json.dumps(res)} [{card}]", flush=True)
        details.update(res)
    print(json.dumps({
        "metric": "parent_scan_reads_per_s",
        "value": details.get("vcf_tally_reads_per_s"),
        "unit": "reads/s",
        "baseline_reads_per_s": BASELINE_READS_PER_S,
        "device": device, "nvidia_smi": card,
        "details": details,
    }))


if __name__ == "__main__":
    main()
