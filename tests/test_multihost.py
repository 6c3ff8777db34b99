"""2-process CPU multi-host harness: sharded_count across processes.

Spawns two worker processes that join a jax.distributed runtime
(Gloo collectives over localhost), each feeding HALF the reads from
its own process — the per-host BAM-shard input model — and asserts
the merged distributed count is identical on both hosts and equal to
the single-process oracle (SURVEY.md §4 "multi-host tests on a
simulated mesh"; BASELINE.md 2-host target).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
outdir = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

# join the runtime BEFORE any jax call initialises the backend
# (importing the package creates device constants)
os.environ["KDF_COORDINATOR"] = f"localhost:{port}"
os.environ["KDF_NUM_PROCESSES"] = str(nproc)
os.environ["KDF_PROCESS_ID"] = str(pid)
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)

from kmer_denovo_filter_tpu.parallel import multihost

assert multihost.initialize()   # idempotent no-op once joined
assert jax.device_count() == 2 * nproc

K = 31
rng = np.random.default_rng(7)           # same stream on both procs
codes_all = rng.integers(0, 4, size=(16, 64), dtype=np.uint8)
codes_all[rng.random(codes_all.shape) < 0.02] = 4
lengths_all = rng.integers(K, 65, size=16).astype(np.int32)

half = 8
codes = codes_all[pid * half:(pid + 1) * half]
lengths = lengths_all[pid * half:(pid + 1) * half]

keys, counts = multihost.sharded_count_multihost(codes, lengths, K)
np.savez(os.path.join(outdir, f"result_{pid}.npz"),
         keys=keys, counts=counts)
print(f"[{pid}] distinct={keys.shape[0]} total={counts.sum()}")

# multi-host routed filtered counter: the table is the distinct
# k-mers just counted; feeding the same per-host batches must tally
# every table key exactly its global count
from kmer_denovo_filter_tpu.parallel import (
    ShardedFilteredCounter,
    ShardedKmerIndex,
    sharded_scan_reads_for_hits,
)

mesh = multihost.global_mesh()
tc = ShardedFilteredCounter(keys, K, mesh)
tc.feed(codes, lengths)
tally = tc.result()
np.savez(os.path.join(outdir, f"tally_{pid}.npz"), tally=tally)
assert np.array_equal(tally, counts), "routed tally != distributed count"
print(f"[{pid}] routed tally ok total={tally.sum()}")

# multi-host anchoring scan: each host gets the mask for ITS reads
hits = sharded_scan_reads_for_hits(ShardedKmerIndex(keys, K, mesh),
                                   codes, lengths)
assert hits.shape[0] == codes.shape[0]
np.savez(os.path.join(outdir, f"scan_{pid}.npz"), hits=hits)
print(f"[{pid}] routed scan ok found={hits.sum()}")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(os.environ.get("KDF_SKIP_MULTIHOST") == "1",
                    reason="multihost harness disabled")
def test_two_process_sharded_count(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", str(port),
         str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    r0 = np.load(tmp_path / "result_0.npz")
    r1 = np.load(tmp_path / "result_1.npz")
    # identical merged result on every host
    assert np.array_equal(r0["keys"], r1["keys"])
    assert np.array_equal(r0["counts"], r1["counts"])

    # equals the single-process oracle over the full read set
    from collections import Counter

    from kmer_denovo_filter_tpu.kmer import extract_read_kmers
    from kmer_denovo_filter_tpu.ops import encode as enc

    K = 31
    rng = np.random.default_rng(7)
    codes_all = rng.integers(0, 4, size=(16, 64), dtype=np.uint8)
    codes_all[rng.random(codes_all.shape) < 0.02] = 4
    lengths_all = rng.integers(K, 65, size=16).astype(np.int32)
    bases = np.array(list("ACGTN"))
    expected = Counter()
    for row, ln in zip(codes_all, lengths_all):
        seq = "".join(bases[row[:ln]])
        per_pos, _ = extract_read_kmers(seq, K)
        expected.update(per_pos.values())
    got_kmers = enc.keys_to_kmers(r0["keys"], K)
    got = dict(zip(got_kmers, r0["counts"].tolist()))
    assert got == dict(expected)

    # the multi-host routed tally agrees on both hosts
    t0 = np.load(tmp_path / "tally_0.npz")["tally"]
    t1 = np.load(tmp_path / "tally_1.npz")["tally"]
    assert np.array_equal(t0, t1)
    assert np.array_equal(t0, r0["counts"])

    # the multi-host anchoring scan returns each host's own mask;
    # stitched together they must equal the single-process oracle
    h0 = np.load(tmp_path / "scan_0.npz")["hits"]
    h1 = np.load(tmp_path / "scan_1.npz")["hits"]
    stitched = np.concatenate([h0, h1])
    import jax

    from kmer_denovo_filter_tpu import engine as eng
    index = eng.KmerIndex(r0["keys"], K)
    expected = eng.scan_reads_for_hits(index, codes_all, lengths_all)
    assert np.array_equal(stitched, expected)
    assert expected.any()


# ── Owner-sharded merge: 1/N memory contract ────────────────────────

SHARDED_MERGE_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
outdir = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
os.environ["KDF_COORDINATOR"] = f"localhost:{port}"
os.environ["KDF_NUM_PROCESSES"] = str(nproc)
os.environ["KDF_PROCESS_ID"] = str(pid)
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)

from kmer_denovo_filter_tpu.parallel import multihost

# per-host partials with heavy cross-host key overlap (the WGS case:
# every host's stripe sees most distinct genome k-mers)
rng = np.random.default_rng(100 + pid)
n_rows = 4096
keys = rng.integers(0, 512, size=(n_rows, 2)).astype(np.uint32)
keys[:, 1] &= np.uint32(0xFFFFFFFC)
counts = rng.integers(1, 5, size=n_rows).astype(np.int64)

my_keys, my_counts = multihost.merge_counts_sharded(keys, counts)
stats = dict(multihost.LAST_MERGE_STATS)

# shard keys must actually be owned by this process
owner = multihost._owner_of_keys(my_keys, nproc)
assert (owner == pid).all(), "foreign keys in shard"

survivors = my_keys[my_counts >= 8]
global_survivors = multihost.allgather_keys_sorted(survivors)

np.savez(os.path.join(outdir, f"shard_{pid}.npz"),
         keys=my_keys, counts=my_counts, in_keys=keys,
         in_counts=counts, survivors=global_survivors,
         peak_round_bytes=stats["peak_round_bytes"],
         local_in_bytes=stats["local_in_bytes"])
print(f"[{pid}] shard rows={my_keys.shape[0]} "
      f"peak_round={stats['peak_round_bytes']}")
"""


@pytest.mark.skipif(os.environ.get("KDF_SKIP_MULTIHOST") == "1",
                    reason="multihost harness disabled")
def test_four_process_sharded_merge_memory(tmp_path):
    """merge_counts_sharded: disjoint owner shards whose union equals
    the global merge, with per-round transient bytes ~1/N of the
    global table (no host ever materializes the whole table)."""
    nproc = 4
    worker = tmp_path / "worker_merge.py"
    worker.write_text(SHARDED_MERGE_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(nproc), str(port),
         str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    shards = [np.load(tmp_path / f"shard_{pid}.npz")
              for pid in range(nproc)]

    # oracle: single-host merge of every input partial
    from kmer_denovo_filter_tpu.ops import encode as enc

    all_k = np.concatenate([s["in_keys"] for s in shards])
    all_c = np.concatenate([s["in_counts"] for s in shards])
    order = enc.lexsort_keys(all_k)
    sk, sc = all_k[order], all_c[order]
    new = np.ones(sk.shape[0], dtype=bool)
    new[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    seg = np.cumsum(new) - 1
    want_counts = np.zeros(int(seg[-1]) + 1, dtype=np.int64)
    np.add.at(want_counts, seg, sc)
    want_keys = sk[new]

    got_k = np.concatenate([s["keys"] for s in shards])
    got_c = np.concatenate([s["counts"] for s in shards])
    o2 = enc.lexsort_keys(got_k)
    assert np.array_equal(got_k[o2], want_keys)
    assert np.array_equal(got_c[o2], want_counts)

    # disjointness: union row count == sum of shard rows
    assert sum(s["keys"].shape[0] for s in shards) == want_keys.shape[0]

    # 1/N transient memory: each owner round gathers ~global/N bytes
    global_bytes = want_keys.nbytes + want_counts.nbytes
    for s in shards:
        assert int(s["peak_round_bytes"]) < global_bytes / nproc * 2.5, (
            int(s["peak_round_bytes"]), global_bytes)

    # shard-local filters + survivor gather match the global filter
    want_surv = want_keys[want_counts >= 8]
    for s in shards:
        assert np.array_equal(s["survivors"], want_surv)


# ── End-to-end: 2-process kmer-discovery deployment ─────────────────

E2E_WORKER = r"""
import os, sys

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
out_prefix = sys.argv[4]
giab = sys.argv[5]
candidate_summary = sys.argv[6]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

# the deployment contract: KDF_* env + the stock CLI entry point
os.environ["KDF_COORDINATOR"] = f"localhost:{port}"
os.environ["KDF_NUM_PROCESSES"] = str(nproc)
os.environ["KDF_PROCESS_ID"] = str(pid)

from kmer_denovo_filter_tpu.cli import discovery_main

discovery_main([
    "--child", os.path.join(giab, "HG002_child.bam"),
    "--mother", os.path.join(giab, "HG004_mother.bam"),
    "--father", os.path.join(giab, "HG003_father.bam"),
    "--ref-fasta", os.path.join(giab, "mini_ref.fa"),
    "--ref-jf", os.path.join(giab, "mini_ref.fa.k31.jf"),
    "--out-prefix", out_prefix,
    "--min-child-count", "3",
    "--kmer-size", "31",
    "--candidate-summary", candidate_summary,
])
print(f"[{pid}] discovery pipeline done")
"""


@pytest.mark.skipif(os.environ.get("KDF_SKIP_MULTIHOST") == "1",
                    reason="multihost harness disabled")
@pytest.mark.parametrize("nproc", [2, 4])
def test_discovery_end_to_end_multiprocess(tmp_path, nproc,
                                           generated_example_output,
                                           generated_discovery_output):
    """`kmer-discovery` as an N-process deployment writes outputs
    (from process 0) byte-identical to the single-process run; the
    4-process case exercises the owner-sharded Module-1 merge with
    uneven stripes."""
    from tests.conftest import GIAB_DIR, GIAB_DISCOVERY_DATA_EXISTS

    if not GIAB_DISCOVERY_DATA_EXISTS:
        pytest.skip("GIAB discovery test data not available")

    worker = tmp_path / "worker_e2e.py"
    worker.write_text(E2E_WORKER)
    out_prefix = str(tmp_path / "mh_discovery")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(nproc), str(port),
         out_prefix, GIAB_DIR, generated_example_output["summary"]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    # process 0 wrote every output file; byte parity with single-process
    single = generated_discovery_output
    for key, suffix in [("bed", ".bed"),
                        ("bedgraph", ".kmer_coverage.bedgraph"),
                        ("read_coverage_bed", ".read_coverage.bed"),
                        ("metrics", ".metrics.json"),
                        ("summary", ".summary.txt"),
                        ("bedpe", ".sv.bedpe")]:
        multi_path = out_prefix + suffix
        assert os.path.isfile(multi_path), f"missing {multi_path}"
        with open(multi_path, "rb") as fh:
            multi_bytes = fh.read()
        with open(single[key], "rb") as fh:
            single_bytes = fh.read()
        assert multi_bytes == single_bytes, f"{suffix} differs"

    # informative BAM: identical record set (BGZF framing may differ)
    from kmer_denovo_filter_tpu.htsio.bam import BamReader

    def bam_records(path):
        r = BamReader(path)
        return [(rec.query_name, rec.tid, rec.pos, rec.flag,
                 rec.query_sequence, rec.get_tag("dk"))
                for rec in r.records]

    assert (bam_records(out_prefix + ".informative.bam")
            == bam_records(single["bam"]))


VCF_E2E_WORKER = r"""
import os, sys

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
outdir = sys.argv[4]
giab = sys.argv[5]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

os.environ["KDF_COORDINATOR"] = f"localhost:{port}"
os.environ["KDF_NUM_PROCESSES"] = str(nproc)
os.environ["KDF_PROCESS_ID"] = str(pid)

from kmer_denovo_filter_tpu.cli import vcf_main

vcf_main([
    "--vcf", os.path.join(giab, "candidates.vcf.gz"),
    "--child", os.path.join(giab, "HG002_child.bam"),
    "--mother", os.path.join(giab, "HG004_mother.bam"),
    "--father", os.path.join(giab, "HG003_father.bam"),
    "--output", os.path.join(outdir, "out.vcf.gz"),
    "--metrics", os.path.join(outdir, "metrics.json"),
    "--summary", os.path.join(outdir, "summary.txt"),
    "--proband-id", "HG002",
])
print(f"[{pid}] vcf pipeline done")
"""


@pytest.mark.skipif(os.environ.get("KDF_SKIP_MULTIHOST") == "1",
                    reason="multihost harness disabled")
def test_two_process_vcf_end_to_end(tmp_path, generated_example_output):
    """`kmer-denovo` as a 2-process deployment: parent scans stripe
    across processes; process 0's outputs match single-process."""
    import gzip

    from tests.conftest import GIAB_DIR, GIAB_DATA_EXISTS

    if not GIAB_DATA_EXISTS:
        pytest.skip("GIAB test data not available")

    worker = tmp_path / "worker_vcf.py"
    worker.write_text(VCF_E2E_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", str(port),
         str(tmp_path), GIAB_DIR],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    def vcf_data_lines(path):
        with gzip.open(path, "rt") as fh:
            return [l for l in fh if not l.startswith("#")]

    assert (vcf_data_lines(str(tmp_path / "out.vcf.gz"))
            == vcf_data_lines(generated_example_output["vcf"]))
    with open(tmp_path / "metrics.json") as fh:
        multi_metrics = fh.read()
    with open(generated_example_output["metrics"]) as fh:
        single_metrics = fh.read()
    assert multi_metrics == single_metrics
    with open(tmp_path / "summary.txt") as fh:
        multi_summary = fh.read()
    with open(generated_example_output["summary"]) as fh:
        single_summary = fh.read()
    assert multi_summary == single_summary
