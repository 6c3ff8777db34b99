"""Synthetic end-to-end tests for the discovery pipeline.

Mirrors the reference's synthetic discovery coverage
(reference tests/discovery/test_pipeline.py, 1598 LoC): region
detection, every filter knob, SV classification via SA tags, bedGraph
semantics — built with the package's own writers.
"""

import json
import os

import pytest

from kmer_denovo_filter_tpu.cli import parse_args
from kmer_denovo_filter_tpu.pipeline import run_discovery_pipeline
from tests.helpers import (
    create_bam,
    create_bam_with_flags,
    create_ref_fasta,
    create_vcf,
)

K = 15
READ_LEN = 60
# default per-read filter for k=15 is k//4 = 3 distinct unique k-mers


def _tiled(seq, prefix, start, end, step=6, read_len=READ_LEN,
           insert=None):
    reads = []
    i = 0
    for pos in range(start, end - read_len + 1, step):
        sub = seq[pos:pos + read_len]
        if insert is not None:
            ipos, ins = insert
            off = ipos - pos
            if 5 <= off < read_len - 5:
                newseq = sub[:off] + ins + sub[off:read_len - len(ins)]
                reads.append((f"{prefix}{i}", pos, newseq))
                i += 1
                continue
        reads.append((f"{prefix}{i}", pos, sub))
        i += 1
    return reads


@pytest.fixture()
def disco(tmp_path):
    """Child carries a 20 bp novel insertion around pos 150."""
    ref_path = str(tmp_path / "ref.fa")
    seq = create_ref_fasta(ref_path, "chr1", 400)
    novel = "ACGTTGCAATCCGGATTAGC"  # non-repetitive novel sequence
    child = str(tmp_path / "child.bam")
    mother = str(tmp_path / "mother.bam")
    father = str(tmp_path / "father.bam")
    create_bam(child, "chr1",
               _tiled(seq, "c", 40, 360, insert=(150, novel)),
               ref_length=400)
    create_bam(mother, "chr1", _tiled(seq, "m", 40, 360),
               ref_length=400)
    create_bam(father, "chr1", _tiled(seq, "f", 40, 360),
               ref_length=400)
    return {"tmp": tmp_path, "seq": seq, "ref": ref_path,
            "child": child, "mother": mother, "father": father}


def _run(disco, tmp_path, extra=()):
    prefix = str(tmp_path / "disc")
    args = parse_args([
        "--child", disco["child"], "--mother", disco["mother"],
        "--father", disco["father"], "--ref-fasta", disco["ref"],
        "--out-prefix", prefix, "--kmer-size", str(K),
        "--min-child-count", "2",
        *extra,
    ])
    run_discovery_pipeline(args)
    return prefix


def _read_bed(prefix):
    rows = []
    for line in open(prefix + ".bed"):
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        rows.append({"chrom": f[0], "start": int(f[1]), "end": int(f[2]),
                     "reads": int(f[3]), "kmers": int(f[4]),
                     "class": f[9]})
    return rows


class TestRegionDetection:
    def test_novel_insertion_detected(self, disco, tmp_path):
        prefix = _run(disco, tmp_path)
        rows = _read_bed(prefix)
        assert len(rows) == 1
        r = rows[0]
        assert r["chrom"] == "chr1"
        assert r["start"] < 150 < r["end"]
        assert r["reads"] > 0
        assert r["kmers"] > 0
        with open(prefix + ".metrics.json") as fh:
            m = json.load(fh)
        assert m["proband_unique_kmers"] > 0
        assert m["candidate_regions"] == 1

    def test_no_novel_sequence_empty(self, disco, tmp_path):
        create_bam(disco["child"], "chr1",
                   _tiled(disco["seq"], "c", 40, 360), ref_length=400)
        prefix = _run(disco, tmp_path)
        with open(prefix + ".metrics.json") as fh:
            m = json.load(fh)
        assert m["candidate_regions"] == 0

    def test_kmers_in_parents_filtered(self, disco, tmp_path):
        """Insertion also present in mother → not proband-unique."""
        create_bam(disco["mother"], "chr1",
                   _tiled(disco["seq"], "m", 40, 360,
                          insert=(150, "ACGTTGCAATCCGGATTAGC")),
                   ref_length=400)
        prefix = _run(disco, tmp_path)
        with open(prefix + ".metrics.json") as fh:
            m = json.load(fh)
        assert m["proband_unique_kmers"] == 0
        assert m["candidate_regions"] == 0


class TestFilters:
    def test_min_supporting_reads(self, disco, tmp_path):
        prefix = _run(disco, tmp_path, ["--min-supporting-reads", "999"])
        assert _read_bed(prefix) == []

    def test_min_distinct_kmers(self, disco, tmp_path):
        prefix = _run(disco, tmp_path, ["--min-distinct-kmers", "9999"])
        assert _read_bed(prefix) == []

    def test_min_distinct_kmers_per_read_excludes(self, disco, tmp_path):
        prefix = _run(disco, tmp_path,
                      ["--min-distinct-kmers-per-read", "9999"])
        with open(prefix + ".metrics.json") as fh:
            m = json.load(fh)
        assert m["informative_reads"] == 0

    def test_filters_recorded_in_header(self, disco, tmp_path):
        prefix = _run(disco, tmp_path, ["--min-supporting-reads", "2"])
        head = open(prefix + ".bed").readline()
        assert head.startswith("#filters:")
        assert "min_supporting_reads=2" in head

    def test_parent_max_count_loosens(self, disco, tmp_path):
        """A single mother read with the insertion kills the k-mers at
        parent-max-count 0 but not at 1."""
        reads = _tiled(disco["seq"], "m", 40, 360)
        ins_reads = _tiled(disco["seq"], "mx", 100, 220,
                           insert=(150, "ACGTTGCAATCCGGATTAGC"))
        with_one = reads + [r for r in ins_reads if r[1] <= 150][:1]
        create_bam(disco["mother"], "chr1", with_one, ref_length=400)
        p0 = _run(disco, tmp_path / "a" if False else tmp_path, [])
        with open(p0 + ".metrics.json") as fh:
            base = json.load(fh)["proband_unique_kmers"]
        p1 = _run(disco, tmp_path, ["--parent-max-count", "3"])
        with open(p1 + ".metrics.json") as fh:
            loose = json.load(fh)["proband_unique_kmers"]
        assert loose > base


class TestSvClassification:
    def test_sa_linked_regions_classified_sv(self, tmp_path):
        """Two clusters linked by SA-tagged split reads → SV + BEDPE."""
        ref_path = str(tmp_path / "ref.fa")
        seq = create_ref_fasta(ref_path, "chr1", 1200)
        novel = "TTGACCGGAATTCCGGAACT"
        reads = []
        # cluster A around 100, cluster B around 900, both novel-bearing
        for i, pos in enumerate(range(80, 160, 6)):
            sub = seq[pos:pos + 40] + novel
            reads.append({
                "name": f"s{i}", "chrom_idx": 0, "pos": pos,
                "seq": sub,
                "cigar": [(0, 40), (4, len(novel))],
                "sa_tag": f"chr1,901,+,40M20S,60,0;",
                "flag": 0,
            })
            reads.append({
                "name": f"s{i}", "chrom_idx": 0, "pos": 900,
                "seq": seq[900:940] + novel,
                "cigar": [(0, 40), (4, len(novel))],
                "flag": 0x800,
            })
        child = str(tmp_path / "child.bam")
        create_bam_with_flags(child, ["chr1"], [1200], reads)
        mother = str(tmp_path / "mother.bam")
        father = str(tmp_path / "father.bam")
        create_bam(mother, "chr1", _tiled(seq, "m", 40, 1100),
                   ref_length=1200)
        create_bam(father, "chr1", _tiled(seq, "f", 40, 1100),
                   ref_length=1200)
        prefix = str(tmp_path / "disc")
        args = parse_args([
            "--child", child, "--mother", mother, "--father", father,
            "--ref-fasta", ref_path, "--out-prefix", prefix,
            "--kmer-size", str(K), "--min-child-count", "2",
            "--min-distinct-kmers-per-read", "1",
        ])
        run_discovery_pipeline(args)
        rows = _read_bed(prefix)
        assert len(rows) == 2
        assert all(r["class"] == "SV" for r in rows)
        bedpe = [l for l in open(prefix + ".sv.bedpe")
                 if not l.startswith("#")]
        assert len(bedpe) == 1
        fields = bedpe[0].split("\t")
        assert fields[0] == "chr1" and fields[3] == "chr1"
        assert fields[8].strip() == "INTRA"


class TestBedgraph:
    def test_bedgraph_written_and_merged(self, disco, tmp_path):
        prefix = _run(disco, tmp_path, ["--min-bedgraph-reads", "1"])
        lines = [l for l in open(prefix + ".kmer_coverage.bedgraph")
                 if not l.startswith("#")]
        assert lines
        prev_end = None
        for line in lines:
            chrom, start, end, val = line.split("\t")
            assert int(end) > int(start)
            assert int(val) > 0

    def test_min_bedgraph_reads_filters(self, disco, tmp_path):
        prefix = _run(disco, tmp_path, ["--min-bedgraph-reads", "999"])
        lines = [l for l in open(prefix + ".kmer_coverage.bedgraph")
                 if not l.startswith("#")]
        assert lines == []


class TestCandidateComparison:
    def test_candidate_summary_capture(self, disco, tmp_path):
        summary = str(tmp_path / "cand_summary.txt")
        with open(summary, "w") as fh:
            fh.write(
                "Per-Variant Results\n" + "-" * 120 + "\n"
                "  Variant  DKU DKT DKA DKU_DKT DKA_DKT ...\n"
                "  -------  --- --- --- ------- -------\n"
                "  chr1:151 A>AACGT    20    40    20   0.5000"
                "   0.5000       10    5.00        1            0"
                "         0.00            0  DE_NOVO\n\n")
        prefix = _run(disco, tmp_path,
                      ["--candidate-summary", summary])
        with open(prefix + ".metrics.json") as fh:
            m = json.load(fh)
        cc = m["candidate_comparison"]
        assert cc["hq_candidates"] == 1
        assert cc["captured"] == 1


class TestSnapshotResume:
    def test_save_and_resume_identical_outputs(self, disco, tmp_path):
        p1 = _run(disco, tmp_path, extra=("--save-proband-index",))
        snap = p1 + ".proband_unique.kdx.npz"
        assert os.path.exists(snap)

        prefix2 = str(tmp_path / "resumed")
        args = parse_args([
            "--child", disco["child"], "--mother", disco["mother"],
            "--father", disco["father"], "--ref-fasta", disco["ref"],
            "--out-prefix", prefix2, "--kmer-size", str(K),
            "--min-child-count", "2",
            "--proband-index", snap,
        ])
        run_discovery_pipeline(args)
        for ext in (".bed", ".metrics.json", ".summary.txt",
                    ".kmer_coverage.bedgraph"):
            a = open(p1 + ext).read()
            b = open(prefix2 + ext).read()
            # summary embeds the prefix-derived paths; normalize
            b = b.replace(os.path.basename(prefix2),
                          os.path.basename(p1))
            assert a == b, ext

    def test_resume_k_mismatch_rejected(self, disco, tmp_path):
        import numpy as np
        import pytest
        snap = str(tmp_path / "bad.kdx.npz")
        np.savez(snap, keys=np.zeros((1, 2), np.uint32), k=99,
                 child_candidate_kmers=1, non_ref_kmers=1)
        args = parse_args([
            "--child", disco["child"], "--mother", disco["mother"],
            "--father", disco["father"], "--ref-fasta", disco["ref"],
            "--out-prefix", str(tmp_path / "x"),
            "--kmer-size", str(K), "--proband-index", snap,
        ])
        with pytest.raises(ValueError, match="k=99"):
            run_discovery_pipeline(args)


class TestKmerIndexSnapshot:
    def test_engine_save_load(self, tmp_path):
        import numpy as np
        from kmer_denovo_filter_tpu import engine as eng
        keys = np.sort(np.arange(40, dtype=np.uint32)).reshape(20, 2)
        idx = eng.KmerIndex.from_keys_counts(
            keys, np.arange(20, dtype=np.int64), 31)
        path = str(tmp_path / "i.npz")
        idx.save(path)
        back = eng.KmerIndex.load(path)
        assert back.k == 31
        assert np.array_equal(back.keys_np, keys)
        assert np.array_equal(back.counts_np, np.arange(20))


def test_ref_cache_staleness_rebuild(tmp_path, caplog):
    """A .kdx.npz cache older than the FASTA is rebuilt, not reused."""
    import logging
    import os
    import time as _time

    import numpy as np

    from kmer_denovo_filter_tpu.discovery.pipeline import (
        ensure_ref_index)
    from tests.helpers import create_ref_fasta

    ref = str(tmp_path / "r.fa")
    create_ref_fasta(ref, "chr1", 200)
    idx1 = ensure_ref_index(ref, K)
    cache = f"{ref}.k{K}.kdx.npz"
    assert os.path.exists(cache)
    # edit the FASTA afterwards -> cache must be considered stale
    _time.sleep(0.01)
    create_ref_fasta(ref, "chr1", 250)
    os.utime(ref)
    with caplog.at_level(logging.WARNING):
        idx2 = ensure_ref_index(ref, K)
    assert idx2.n != idx1.n or not np.array_equal(
        idx2.keys_np, idx1.keys_np)
    assert any("older than" in r.message for r in caplog.records)
    # refreshed cache is reused on the next call
    idx3 = ensure_ref_index(ref, K)
    assert np.array_equal(idx3.keys_np, idx2.keys_np)


@pytest.mark.skipif(
    len(__import__("jax").devices()) < 2,
    reason="needs a multi-device mesh")
def test_discovery_sharded_module3_byte_identical(disco, tmp_path,
                                                  monkeypatch):
    """Full discovery with KDF_SHARDED=1 (anchoring scan + parent
    filters on the virtual mesh) produces byte-identical outputs."""
    monkeypatch.setenv("KDF_SHARDED", "0")
    base = _run(disco, tmp_path / "single")
    monkeypatch.setenv("KDF_SHARDED", "1")
    shard = _run(disco, tmp_path / "mesh")
    for suffix in (".bed", ".kmer_coverage.bedgraph",
                   ".read_coverage.bed", ".sv.bedpe"):
        a = open(base + suffix, "rb").read()
        b = open(shard + suffix, "rb").read()
        assert a == b, f"{suffix} differs under sharding"
    ja = json.load(open(base + ".metrics.json"))
    jb = json.load(open(shard + ".metrics.json"))
    for key in ("candidate_regions", "proband_unique_kmers",
                "informative_reads"):
        assert ja[key] == jb[key]
    assert ja["candidate_regions"] >= 1


# ──────────────────────────────────────────────────────────────────
# Pure unit tests for the host-side helpers (no pipeline run)
# ──────────────────────────────────────────────────────────────────

from kmer_denovo_filter_tpu.discovery.pipeline import (  # noqa: E402
    SULOVARI_DNM_REGIONS,
    _RegionLocator,
    _classify_regions,
    _compare_candidates_to_regions,
    _evaluate_dnm_regions,
    _parse_candidate_summary,
    _sa_breakpoints,
    _value_runs,
    _write_bedgraph,
    _write_bedpe,
    _write_read_coverage_bed,
)


class TestValueRuns:
    def test_consecutive_equal_values_merge(self):
        runs = list(_value_runs({10: 2, 11: 2, 12: 2}))
        assert runs == [(10, 13, 2)]

    def test_value_change_starts_new_run(self):
        runs = list(_value_runs({10: 2, 11: 3, 12: 3}))
        assert runs == [(10, 11, 2), (11, 13, 3)]

    def test_gap_starts_new_run(self):
        runs = list(_value_runs({10: 2, 12: 2}))
        assert runs == [(10, 11, 2), (12, 13, 2)]

    def test_empty(self):
        assert list(_value_runs({})) == []

    def test_single_position(self):
        assert list(_value_runs({7: 9})) == [(7, 8, 9)]

    def test_unsorted_input_is_sorted(self):
        runs = list(_value_runs({12: 1, 10: 1, 11: 1}))
        assert runs == [(10, 13, 1)]


class TestWriteBedgraphUnits:
    def _read(self, path):
        lines = open(path).read().rstrip("\n").split("\n")
        assert lines[0].startswith("#track type=bedGraph")
        return [l.split("\t") for l in lines[1:] if l]

    def test_basic_merge(self, tmp_path):
        out = str(tmp_path / "a.bedgraph")
        _write_bedgraph({"chr1": {5: 3, 6: 3, 7: 3}}, out)
        assert self._read(out) == [["chr1", "5", "8", "3"]]

    def test_different_values_not_merged(self, tmp_path):
        out = str(tmp_path / "a.bedgraph")
        _write_bedgraph({"chr1": {5: 3, 6: 4}}, out)
        assert self._read(out) == [["chr1", "5", "6", "3"],
                                   ["chr1", "6", "7", "4"]]

    def test_multi_chrom_sorted(self, tmp_path):
        out = str(tmp_path / "a.bedgraph")
        _write_bedgraph({"chr2": {1: 1}, "chr1": {9: 2}}, out)
        rows = self._read(out)
        assert [r[0] for r in rows] == ["chr1", "chr2"]

    def test_empty_coverage(self, tmp_path):
        out = str(tmp_path / "a.bedgraph")
        _write_bedgraph({}, out)
        assert self._read(out) == []

    def test_min_reads_filter_against_read_coverage(self, tmp_path):
        out = str(tmp_path / "a.bedgraph")
        _write_bedgraph({"chr1": {5: 9, 6: 9}}, out,
                        read_coverage={"chr1": {5: 5, 6: 1}},
                        min_reads=3)
        assert self._read(out) == [["chr1", "5", "6", "9"]]

    def test_header_mentions_min_reads(self, tmp_path):
        out = str(tmp_path / "a.bedgraph")
        _write_bedgraph({}, out, min_reads=7)
        assert "min_reads>=7" in open(out).readline()


class TestWriteReadCoverageBed:
    def test_avg_kmers_and_filter(self, tmp_path):
        out = str(tmp_path / "a.bed")
        _write_read_coverage_bed(
            kmer_coverage={"chr1": {5: 12, 6: 12, 7: 1}},
            read_coverage={"chr1": {5: 4, 6: 4, 7: 1}},
            bed_path=out, min_reads=3)
        lines = [l for l in open(out) if not l.startswith("#")]
        assert lines == ["chr1\t5\t7\t4\t3.0\n"]

    def test_header(self, tmp_path):
        out = str(tmp_path / "a.bed")
        _write_read_coverage_bed({}, {}, out)
        head = open(out).read()
        assert "read_count\tavg_kmers_per_read" in head


class TestRegionLocator:
    REGIONS = [("chr1", 10, 20), ("chr1", 30, 40), ("chr2", 0, 5)]

    def test_inside(self):
        loc = _RegionLocator(self.REGIONS)
        assert loc.region_at("chr1", 15) == ("chr1", 10, 20)
        assert loc.region_at("chr1", 10) == ("chr1", 10, 20)

    def test_end_exclusive(self):
        loc = _RegionLocator(self.REGIONS)
        assert loc.region_at("chr1", 20) is None

    def test_between_regions(self):
        loc = _RegionLocator(self.REGIONS)
        assert loc.region_at("chr1", 25) is None

    def test_before_first(self):
        loc = _RegionLocator(self.REGIONS)
        assert loc.region_at("chr1", 5) is None

    def test_unknown_chrom(self):
        loc = _RegionLocator(self.REGIONS)
        assert loc.region_at("chrX", 15) is None


class TestSaBreakpoints:
    def test_parses_entries(self):
        got = list(_sa_breakpoints("chr2,100,+,60M,60,0;chr3,7,-,30M,5,1;"))
        assert got == [("chr2", 99), ("chr3", 6)]

    def test_empty_and_none(self):
        assert list(_sa_breakpoints("")) == []
        assert list(_sa_breakpoints(None)) == []

    def test_malformed_entries_skipped(self):
        got = list(_sa_breakpoints("chr2;chr3,notanint,+;chr4,8,+;"))
        assert got == [("chr4", 7)]


class TestClassifyRegionsUnit:
    def _classify(self, ann, links=()):
        key = ("chr1", 0, 10)
        anns = {key: dict(ann)}
        _classify_regions([key], anns, list(links))
        return anns[key]["class"]

    def test_split_reads_sv(self):
        assert self._classify({"split_reads": 2}) == "SV"

    def test_discordant_sv(self):
        assert self._classify({"discordant_pairs": 3}) == "SV"

    def test_unmapped_mates_sv(self):
        assert self._classify({"unmapped_mates": 2}) == "SV"

    def test_linked_region_sv(self):
        link = {"region_a": ("chr1", 0, 10), "region_b": ("chr2", 0, 5)}
        assert self._classify({}, [link]) == "SV"

    def test_clean_region_small(self):
        assert self._classify({"split_reads": 0, "discordant_pairs": 0,
                               "unmapped_mates": 0}) == "SMALL"

    def test_single_split_read_ambiguous(self):
        assert self._classify({"split_reads": 1}) == "AMBIGUOUS"


class TestWriteBedpeFormat:
    def test_format(self, tmp_path):
        out = str(tmp_path / "a.bedpe")
        _write_bedpe([{
            "region_a": ("chr1", 100, 200),
            "region_b": ("chr5", 900, 950),
            "supporting_reads": {"r1", "r2", "r3"},
            "sv_type_hint": "translocation",
        }], out)
        lines = open(out).read().rstrip("\n").split("\n")
        assert lines[0].startswith("#chrom1\tstart1")
        assert lines[1] == ("chr1\t100\t200\tchr5\t900\t950"
                            "\tSV_1\t3\ttranslocation")

    def test_empty(self, tmp_path):
        out = str(tmp_path / "a.bedpe")
        _write_bedpe([], out)
        assert len(open(out).read().rstrip("\n").split("\n")) == 1


class TestParseCandidateSummary:
    TABLE = "\n".join([
        "=" * 60,
        "  kmer-denovo  —  De Novo Variant Summary",
        "=" * 60,
        "",
        "Per-Variant Results",
        "-" * 120,
        "  Variant                          DKU   DKT   DKA  DKU_DKT"
        "  DKA_DKT  MAX_PKC  AVG_PKC  MIN_PKC  MAX_PKC_ALT  AVG_PKC_ALT"
        "  MIN_PKC_ALT  Call",
        "  -------                          ---   ---   ---  -------"
        "  -------  -------  -------  -------  -----------  -----------"
        "  -----------  ----",
        "  chr1:100 A>T                      29    64    21   0.4531"
        "   0.3281      141   102.63       26          141       135.16"
        "          124  DE_NOVO",
        "  chr1:200 C>G                       1    40     1   0.0250"
        "   0.0250       75    49.05       24           30        26.65"
        "           24  DE_NOVO",
        "",
    ])

    def test_hq_thresholds(self, tmp_path):
        p = tmp_path / "summary.txt"
        p.write_text(self.TABLE)
        cands = _parse_candidate_summary(str(p))
        assert len(cands) == 1
        c = cands[0]
        assert (c["chrom"], c["pos"]) == ("chr1", 100)
        assert (c["ref"], c["alt"]) == ("A", "T")
        assert c["dka"] == 21 and c["dka_dkt"] == 0.3281
        assert c["call"] == "DE_NOVO"

    def test_custom_thresholds_capture_both(self, tmp_path):
        p = tmp_path / "summary.txt"
        p.write_text(self.TABLE)
        cands = _parse_candidate_summary(str(p), dka_dkt_min=0.01,
                                         dka_min=0)
        assert len(cands) == 2

    def test_missing_file(self):
        assert _parse_candidate_summary("/nonexistent/summary.txt") == []


class TestCompareCandidatesToRegions:
    CAND = {"chrom": "chr1", "pos": 150, "ref": "A", "alt": "T",
            "dka": 21, "dka_dkt": 0.4, "call": "DE_NOVO"}

    def test_candidate_inside_region(self):
        (r,) = _compare_candidates_to_regions(
            [dict(self.CAND)], [("chr1", 100, 200)])
        assert r["captured"] is True
        assert r["region"] == "chr1:101-200"

    def test_candidate_outside_region(self):
        (r,) = _compare_candidates_to_regions(
            [dict(self.CAND)], [("chr1", 300, 400)])
        assert r["captured"] is False and r["region"] is None

    def test_candidate_wrong_chrom(self):
        (r,) = _compare_candidates_to_regions(
            [dict(self.CAND)], [("chr9", 100, 200)])
        assert r["captured"] is False

    def test_boundary_semantics(self):
        """Capture uses start < pos <= end (1-based VCF pos)."""
        cand = dict(self.CAND, pos=200)
        (r,) = _compare_candidates_to_regions(
            [cand], [("chr1", 100, 200)])
        assert r["captured"] is True
        cand = dict(self.CAND, pos=100)
        (r,) = _compare_candidates_to_regions(
            [cand], [("chr1", 100, 200)])
        assert r["captured"] is False


class TestEvaluateDnmRegions:
    def _detail(self, key, **kw):
        base = {"chrom": key[0], "start": key[1], "end": key[2],
                "reads": 5, "unique_kmers": 50, "max_clip_len": 10,
                "unmapped_mates": 0, "discordant_pairs": 0,
                "split_reads": 0, "class": "SMALL"}
        base.update(kw)
        return base

    def test_point_event_overlap(self):
        """size=None events evaluate as 1 bp intervals."""
        region = ("chr14", 23280700, 23280800)
        res = _evaluate_dnm_regions(
            [region], [self._detail(region)],
            dnm_regions=[("chr14", 23280711, None,
                          "microsatellite_expansion")])
        assert res[0]["detected"] is True
        assert res[0]["assessment"] == "DETECTED"

    def test_no_overlap(self):
        res = _evaluate_dnm_regions(
            [("chr17", 1000, 1100)], [],
            dnm_regions=[("chr17", 53340465, 107, "deletion")])
        assert res[0]["detected"] is False
        assert res[0]["assessment"] == "NOT_DETECTED"
        assert res[0]["sv_class"] == "NONE"
        assert res[0]["kmer_signal"] == 0.0

    def test_adjacent_not_overlapping(self):
        """A region ending exactly at the locus start doesn't count."""
        res = _evaluate_dnm_regions(
            [("chr17", 53340365, 53340465)], [],
            dnm_regions=[("chr17", 53340465, 107, "deletion")])
        assert res[0]["detected"] is False

    def test_multi_region_overlap_aggregates(self):
        ra = ("chr7", 142786000, 142790000)
        rb = ("chr7", 142790100, 142796900)
        res = _evaluate_dnm_regions(
            [ra, rb],
            [self._detail(ra, reads=3, unique_kmers=30),
             self._detail(rb, reads=4, unique_kmers=40,
                          split_reads=2, **{"class": "SV"})],
            dnm_regions=[("chr7", 142786222, 10607, "deletion")])
        r = res[0]
        assert r["detected"] is True
        assert len(r["discovery_regions"]) == 2
        assert r["total_reads"] == 7
        assert r["total_unique_kmers"] == 70
        assert r["split_reads"] == 2

    def test_sv_class_priority(self):
        """SV > AMBIGUOUS > SMALL across matched regions."""
        ra = ("chr3", 85552300, 85552400)
        rb = ("chr3", 85552400, 85552500)
        res = _evaluate_dnm_regions(
            [ra, rb],
            [self._detail(ra, **{"class": "SMALL"}),
             self._detail(rb, **{"class": "AMBIGUOUS"})],
            dnm_regions=[("chr3", 85552367, 64, "sv_like")])
        assert res[0]["sv_class"] == "AMBIGUOUS"

    def test_kmer_signal_normalised_by_span(self):
        region = ("chr5", 97089276, 97089376)
        res = _evaluate_dnm_regions(
            [region], [self._detail(region, unique_kmers=50)],
            dnm_regions=[("chr5", 97089276, 43, "sv_like")])
        assert res[0]["kmer_signal"] == round(50 / 100, 4)

    def test_default_loci_are_sulovari(self):
        res = _evaluate_dnm_regions([], [])
        assert len(res) == len(SULOVARI_DNM_REGIONS) == 7
        assert {r["event_type"] for r in res} >= {
            "deletion", "sv_like", "microsatellite_expansion"}

    def test_result_fields(self):
        (r,) = _evaluate_dnm_regions(
            [], [], dnm_regions=[("chr18", 62805217, 34, "sv_like")])
        for field in ("locus", "event_type", "event_size", "detected",
                      "discovery_regions", "total_reads",
                      "total_unique_kmers", "max_clip_len",
                      "unmapped_mates", "discordant_pairs",
                      "split_reads", "sv_class", "kmer_signal",
                      "assessment"):
            assert field in r, field


class TestScanPathParity:
    def test_packed_and_record_paths_identical(self, disco, tmp_path,
                                               monkeypatch):
        """The two-pass packed anchoring scan and the per-record
        fallback must produce byte-identical discovery outputs."""
        from kmer_denovo_filter_tpu.htsio.bam import BamReader

        p1 = _run(disco, tmp_path / "packed")
        # force the fallback by hiding the native scan from every
        # reader the pipeline opens
        monkeypatch.setattr(BamReader, "iter_packed_indexed",
                            lambda self, *a, **k: None)
        p2 = _run(disco, tmp_path / "records")

        for suffix in (".bed", ".kmer_coverage.bedgraph",
                       ".read_coverage.bed", ".sv.bedpe",
                       ".summary.txt"):
            a = open(p1 + suffix).read()
            b = open(p2 + suffix).read()
            assert a == b, f"{suffix} differs between scan paths"
        ja = json.load(open(p1 + ".metrics.json"))
        jb = json.load(open(p2 + ".metrics.json"))
        ja.pop("elapsed_seconds", None)
        jb.pop("elapsed_seconds", None)
        assert ja == jb
        # the informative BAMs carry the same (name, flag) sets
        from kmer_denovo_filter_tpu.htsio.bam import open_bam
        reads1 = sorted((r.query_name, r.flag) for r in
                        open_bam(p1 + ".informative.bam").fetch(
                            until_eof=True))
        reads2 = sorted((r.query_name, r.flag) for r in
                        open_bam(p2 + ".informative.bam").fetch(
                            until_eof=True))
        assert reads1 == reads2
        assert reads1  # non-empty: the scan actually found reads

    def test_streaming_path_identical(self, disco, tmp_path,
                                      monkeypatch):
        """Forcing the streaming reader (KDF_STREAM_THRESHOLD_BYTES=0)
        must produce byte-identical discovery outputs through the
        native chunk scan path."""
        p1 = _run(disco, tmp_path / "whole")
        monkeypatch.setenv("KDF_STREAM_THRESHOLD_BYTES", "0")
        p2 = _run(disco, tmp_path / "stream")
        for suffix in (".bed", ".kmer_coverage.bedgraph",
                       ".read_coverage.bed", ".sv.bedpe",
                       ".summary.txt"):
            assert (open(p1 + suffix).read()
                    == open(p2 + suffix).read()), suffix
        ja = json.load(open(p1 + ".metrics.json"))
        jb = json.load(open(p2 + ".metrics.json"))
        assert ja == jb

    def test_host_ref_index_identical(self, disco, tmp_path,
                                      monkeypatch):
        """Forcing the host-resident reference index (the single-chip
        whole-genome path) must not change any discovery output."""
        from kmer_denovo_filter_tpu import engine as eng

        p1 = _run(disco, tmp_path / "device")
        # clear the ref cache so the gated factory actually runs again
        import glob as _glob
        for c in _glob.glob(disco["ref"] + "*.kdx.npz"):
            os.unlink(c)
        # force the host index directly (the budget gate on the
        # 8-device test mesh would pick the sharded index instead)
        monkeypatch.setattr(
            eng, "make_membership_index",
            lambda keys, k, counts=None: eng.HostKmerIndex(
                keys, k, counts))
        p2 = _run(disco, tmp_path / "host")
        for suffix in (".bed", ".kmer_coverage.bedgraph",
                       ".read_coverage.bed", ".sv.bedpe",
                       ".summary.txt"):
            assert (open(p1 + suffix).read()
                    == open(p2 + suffix).read()), suffix

    def test_host_parent_filter_identical(self, disco, tmp_path,
                                          monkeypatch):
        """Forcing the host C++ filtered counter for Module 2 (the
        over-budget single-device path) keeps outputs identical."""
        from kmer_denovo_filter_tpu.htsio import native

        if not native.available():
            import pytest as _pytest
            _pytest.skip("native library unavailable")
        p1 = _run(disco, tmp_path / "dev2")
        monkeypatch.setenv("KDF_SHARDED", "0")
        monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", "0")
        p2 = _run(disco, tmp_path / "host2")
        for suffix in (".bed", ".kmer_coverage.bedgraph",
                       ".sv.bedpe", ".summary.txt"):
            assert (open(p1 + suffix).read()
                    == open(p2 + suffix).read()), suffix
