"""Shared fixtures; forces the JAX CPU backend with 8 virtual devices.

Mirrors the reference's session-scoped GIAB fixtures
(reference tests/conftest.py:24–165) so golden-comparison tests run
each pipeline exactly once.
"""

import os

# Run tests on an 8-device virtual CPU mesh (for sharding tests), also
# on a machine with a GPU: tests that need the card are marked ``gpu``
# and decide inside a fixture whether one is present.
os.environ["JAX_PLATFORMS"] = "cpu"
# The suite writes nothing into the checkout: no persistent compile
# cache (runtime.enable_compile_cache), here or in worker processes.
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import tempfile  # noqa: E402

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (skips without one); run the card's "
        "tests with `python -m pytest tests/ -m gpu`")

# In-repo dataset first (self-contained checkout); fall back to a
# sibling reference checkout for cross-validation runs.
GIAB_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "data", "giab"))
if not os.path.isfile(os.path.join(GIAB_DIR, "HG002_child.bam")):
    GIAB_DIR = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..",
                     "reference", "tests", "data", "giab"))
if not os.path.isdir(GIAB_DIR):
    GIAB_DIR = "/root/reference/tests/data/giab"
GIAB_DATA_EXISTS = os.path.isfile(os.path.join(GIAB_DIR, "HG002_child.bam"))
GIAB_DISCOVERY_DATA_EXISTS = (
    GIAB_DATA_EXISTS
    and os.path.isfile(os.path.join(GIAB_DIR, "mini_ref.fa"))
)

# The reference tool's committed golden outputs (parity targets),
# shipped in-repo; fall back to a reference checkout if absent.
REF_EXAMPLE_OUTPUT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "data", "ref_example_output"))
if not os.path.isfile(os.path.join(REF_EXAMPLE_OUTPUT_DIR,
                                   "metrics.json")):
    REF_EXAMPLE_OUTPUT_DIR = "/root/reference/tests/example_output"
REF_EXAMPLE_OUTPUT_DISCOVERY_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "data",
                 "ref_example_output_discovery"))
if not os.path.isfile(os.path.join(REF_EXAMPLE_OUTPUT_DISCOVERY_DIR,
                                   "giab_discovery.metrics.json")):
    REF_EXAMPLE_OUTPUT_DISCOVERY_DIR = (
        "/root/reference/tests/example_output_discovery")


@pytest.fixture(scope="session")
def generated_example_output():
    """Run the GIAB VCF pipeline once; return output paths."""
    if not GIAB_DATA_EXISTS:
        pytest.skip("GIAB test data not available")
    from kmer_denovo_filter_tpu.cli import parse_args
    from kmer_denovo_filter_tpu.pipeline import run_pipeline

    tmpdir = tempfile.mkdtemp(prefix="kmer_example_output_")
    out_vcf = os.path.join(tmpdir, "annotated.vcf.gz")
    metrics_json = os.path.join(tmpdir, "metrics.json")
    summary_txt = os.path.join(tmpdir, "summary.txt")
    args = parse_args([
        "--child", os.path.join(GIAB_DIR, "HG002_child.bam"),
        "--mother", os.path.join(GIAB_DIR, "HG004_mother.bam"),
        "--father", os.path.join(GIAB_DIR, "HG003_father.bam"),
        "--vcf", os.path.join(GIAB_DIR, "candidates.vcf.gz"),
        "--output", out_vcf,
        "--metrics", metrics_json,
        "--summary", summary_txt,
        "--proband-id", "HG002",
    ])
    run_pipeline(args)
    return {
        "vcf": out_vcf,
        "vcf_tbi": out_vcf + ".tbi",
        "metrics": metrics_json,
        "summary": summary_txt,
    }


@pytest.fixture(scope="session")
def generated_discovery_output(generated_example_output):
    """Run the GIAB discovery pipeline once; return output paths."""
    if not GIAB_DISCOVERY_DATA_EXISTS:
        pytest.skip("GIAB discovery test data not available")
    from kmer_denovo_filter_tpu.cli import parse_args
    from kmer_denovo_filter_tpu.pipeline import run_discovery_pipeline

    tmpdir = tempfile.mkdtemp(prefix="kmer_discovery_output_")
    out_prefix = os.path.join(tmpdir, "giab_discovery")
    args = parse_args([
        "--child", os.path.join(GIAB_DIR, "HG002_child.bam"),
        "--mother", os.path.join(GIAB_DIR, "HG004_mother.bam"),
        "--father", os.path.join(GIAB_DIR, "HG003_father.bam"),
        "--ref-fasta", os.path.join(GIAB_DIR, "mini_ref.fa"),
        "--ref-jf", os.path.join(GIAB_DIR, "mini_ref.fa.k31.jf"),
        "--out-prefix", out_prefix,
        "--min-child-count", "3",
        "--kmer-size", "31",
        "--candidate-summary", generated_example_output["summary"],
    ])
    run_discovery_pipeline(args)
    return {
        "bed": f"{out_prefix}.bed",
        "bedgraph": f"{out_prefix}.kmer_coverage.bedgraph",
        "read_coverage_bed": f"{out_prefix}.read_coverage.bed",
        "metrics": f"{out_prefix}.metrics.json",
        "summary": f"{out_prefix}.summary.txt",
        "bam": f"{out_prefix}.informative.bam",
        "bam_bai": f"{out_prefix}.informative.bam.bai",
        "bedpe": f"{out_prefix}.sv.bedpe",
    }


@pytest.fixture(scope="session")
def generated_comparison_output(generated_example_output,
                                generated_discovery_output):
    """Run the region-comparison script against the GIAB outputs."""
    import importlib.util
    scripts_dir = os.path.join(os.path.dirname(__file__), "..", "scripts")
    spec = importlib.util.spec_from_file_location(
        "compare_regions", os.path.join(scripts_dir, "compare_regions.py"))
    cr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cr)

    bg = cr.load_bedgraph(generated_discovery_output["bedgraph"])
    disc = cr.load_discovery_bed(generated_discovery_output["bed"])
    variants = cr.load_vcf_variants(generated_example_output["vcf"])
    result = cr.compare(bg, disc, variants)
    summary_text = cr.format_summary(result)

    out_dir = os.path.dirname(generated_discovery_output["bedgraph"])
    comparison_path = os.path.join(out_dir, "giab_discovery.comparison.txt")
    with open(comparison_path, "w") as fh:
        fh.write(summary_text + "\n")
    return {"comparison": comparison_path}
