"""Process set-up (compile cache, cluster config) and the GPU entry
points' CPU-side behaviour: refusal without a card, and the smoke
phases' checks at a tiny size."""

import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from kmer_denovo_filter_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture
def cache_dir_config():
    """Restore JAX's compile-cache directory after a test sets it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   cache_dir_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert runtime.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_in_checkout(monkeypatch, cache_dir_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == runtime.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.dirname(path) == REPO
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("env,expected", [
    ({}, None),
    ({"KDF_COORDINATOR": "localhost:1234", "KDF_NUM_PROCESSES": "4",
      "KDF_PROCESS_ID": "2"},
     {"coordinator_address": "localhost:1234", "num_processes": 4,
      "process_id": 2, "local_device_ids": None}),
    ({"KDF_COORDINATOR": "localhost:1234", "KDF_NUM_PROCESSES": "4",
      "KDF_PROCESS_ID": "3", "KDF_LOCAL_DEVICE_IDS": "3"},
     {"coordinator_address": "localhost:1234", "num_processes": 4,
      "process_id": 3, "local_device_ids": [3]}),
])
def test_distributed_config(env, expected):
    assert runtime.distributed_config(env) == expected


def _run_cpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    """No GPU: non-zero exit and no result line."""
    res = _run_cpu([script])
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    assert '"ok"' not in res.stdout and "reads/s" not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding only chip_smoke.py cannot run it."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _vcf_gz(path, lines):
    with gzip.open(path, "wt") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("\n".join(lines) + "\n")


def _record(chrom, pos, ann):
    fmt = "GT:" + ":".join(chip_smoke.ANNOTATION_KEYS)
    return "\t".join([chrom, pos, ".", "G", "T", ".", "PASS", ".", fmt,
                      "0/1:" + ":".join(ann)])


@pytest.mark.parametrize("pos,field,ok", [
    ("55007083", 5, True),    # MAX_PKC at a drifted locus
    ("55007083", 0, False),   # DKU is never whitelisted
    ("1000", 5, False),       # MAX_PKC elsewhere
])
def test_compare_vcf_whitelist(tmp_path, pos, field, ok):
    ann = [str(i) for i in range(11)]
    got = list(ann)
    got[field] = "99"
    _vcf_gz(tmp_path / "gold.vcf.gz", [_record("chr11", pos, ann)])
    _vcf_gz(tmp_path / "got.vcf.gz", [_record("chr11", pos, got)])
    if ok:
        chip_smoke.compare_vcf(tmp_path / "got.vcf.gz",
                               tmp_path / "gold.vcf.gz")
    else:
        with pytest.raises(AssertionError):
            chip_smoke.compare_vcf(tmp_path / "got.vcf.gz",
                                   tmp_path / "gold.vcf.gz")


def test_summary_calls_of_golden():
    assert chip_smoke.summary_calls(os.path.join(
        chip_smoke.GOLD, "summary.txt")) == (12, 10)


def test_smoke_engine_phase_tiny(monkeypatch):
    """The deployment-size phase's checks, at a CPU-sized scale."""
    monkeypatch.setenv("KDF_SHARDED", "0")
    stats = chip_smoke.phase_engine(
        0, "cpu", n_reads=4096, batch=2048,
        sizes=(4096, 1 << 14, 1 << 15), wide_m=1 << 13)
    assert set(stats) == {"stream_count", "k31_4096", "k31_16384",
                          "k31_32768", "k63_8192"}
    assert stats["k63_8192"]["k"] == 63


def test_smoke_four_phase_tiny():
    """The --four phase's comparisons on four of the CPU devices."""
    chip_smoke.phase_four(0, "cpu", n_devices=4, n_reads=4096,
                          batch=1024, m=1 << 13)


def test_smoke_oracle_matches_kmer_module():
    """The smoke run's numpy oracle agrees with the string oracle."""
    from kmer_denovo_filter_tpu import kmer as K
    from kmer_denovo_filter_tpu.ops import encode as enc

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (6, 40), dtype=np.uint8)
    codes[2, 7] = 4
    oracle = chip_smoke.Oracle([codes], 17)
    uniq, counts = oracle.stream_count()
    want = {}
    for row in codes:
        seq = "".join("ACGTN"[c] for c in row)
        for kmer in K.extract_read_kmers(seq, 17)[0].values():
            want[kmer] = want.get(kmer, 0) + 1
    keys = enc.kmers_to_keys(sorted(want), 17)
    import bench
    assert np.array_equal(uniq, bench.key_view(keys))
    assert counts.tolist() == [want[k] for k in sorted(want)]


@pytest.fixture
def gpu_present():
    """Skip unless nvidia-smi answers (the card tests' own check)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
            [smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_present):
    """The whole smoke run on the card (outside the CPU-forcing env)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=1200)
    assert res.returncode == 0, res.stderr[-2000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"


def test_distributed_config_needs_every_variable():
    with pytest.raises(KeyError):
        runtime.distributed_config({"KDF_COORDINATOR": "localhost:1"})


def test_multihost_initialize_without_coordinator(monkeypatch):
    from kmer_denovo_filter_tpu.parallel import multihost

    monkeypatch.delenv("KDF_COORDINATOR", raising=False)
    assert multihost.initialize() is False
    assert not multihost.active()
    assert multihost.stripe() is None
