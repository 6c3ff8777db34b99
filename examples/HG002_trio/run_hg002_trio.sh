#!/usr/bin/env bash
# =============================================================================
# run_hg002_trio.sh — end-to-end GIAB HG002 trio de novo filtering on a
# GPU host.
#
# Device-engine counterpart of the reference HPC pipeline
# (reference examples/HG002_trio/run_hg002_trio.sh, 708 LoC): same
# stages and artifacts, but no Apptainer/Jellyfish — the k-mer engine
# runs on the host's NVIDIA GPU(s) and the only host dependencies are
# Python (jax with its CUDA plugin + this package) and wget.  Runs
# interactively or under SLURM.  With --gpus N > 1, stages 3-4 run as
# N processes, one per card (KDF_LOCAL_DEVICE_IDS), joined through
# jax.distributed on localhost.
#
# Trio
#   HG002 / NA24385 — son (child / proband)
#   HG003 / NA24149 — father
#   HG004 / NA24143 — mother
#
# Stages (each skippable / individually resumable)
#   1  download   GIAB trio BAMs + v4.2.1 benchmark VCFs (+ GRCh38)
#   2  candidates child-private putative de novo sites (pure Python,
#                 no bcftools; scripts/identify_putative_denovos.py)
#   3  vcf-mode   kmer-denovo annotation on the GPU
#   4  discovery  kmer-discovery (VCF-free) with candidate comparison
#   5  review     ±PAD bp mini BAMs + IGV review TSV
#
# Usage
#   # SLURM:
#   sbatch [--partition=... --account=...] \
#       examples/HG002_trio/run_hg002_trio.sh \
#       --data-dir /scratch/$USER/hg002_data \
#       --results-dir /scratch/$USER/hg002_results
#   # Interactive:
#   bash examples/HG002_trio/run_hg002_trio.sh --data-dir d --results-dir r
#
# Disk: downloads ~500 GB; working ~50 GB (no jellyfish intermediates —
# the k-mer tables are device-resident).  Wall: dominated by downloads.
# =============================================================================

# ── SLURM directives (override with sbatch flags) ────────────────────
#SBATCH --job-name=hg002-kmer-denovo
#SBATCH --output=hg002_kmer_denovo_%j.log
#SBATCH --error=hg002_kmer_denovo_%j.err
#SBATCH --time=48:00:00
#SBATCH --cpus-per-task=16
#SBATCH --mem=64G

set -euo pipefail

# ── Defaults (env-overridable) ───────────────────────────────────────
DATA_DIR="${DATA_DIR:-hg002_data}"
RESULTS_DIR="${RESULTS_DIR:-hg002_results}"
KMER_SIZE="${KMER_SIZE:-31}"
THREADS="${THREADS:-${SLURM_CPUS_PER_TASK:-16}}"
GPUS="${GPUS:-1}"
PAD_BP="${PAD_BP:-1000}"
REF_FASTA="${REF_FASTA:-}"
KRAKEN2_DB="${KRAKEN2_DB:-}"
SKIP_DOWNLOAD="${SKIP_DOWNLOAD:-0}"
SKIP_DISCOVERY="${SKIP_DISCOVERY:-0}"
START_STAGE="${START_STAGE:-1}"
STOP_STAGE="${STOP_STAGE:-5}"
DRY_RUN=0

usage() {
    cat <<EOF
Usage: $0 [options]
  --data-dir DIR        download/work directory (default: $DATA_DIR)
  --results-dir DIR     output directory (default: $RESULTS_DIR)
  --kmer-size K         odd k-mer size (default: $KMER_SIZE)
  --threads N           host decode threads (default: $THREADS)
  --gpus N              processes, one per GPU (default: $GPUS)
  --pad BP              mini-BAM padding around candidates (default: $PAD_BP)
  --ref-fasta PATH      GRCh38 FASTA (downloaded if absent and unset)
  --kraken2-db DIR      optional Kraken2 DB for contamination fractions
  --skip-download       assume stage-1 files already exist
  --skip-discovery      skip stage 4 entirely
  --start-stage N       first stage to run (1-5, default 1)
  --stop-stage N        last stage to run (1-5, default 5)
  --dry-run             print the plan and exit
  -h, --help            this help
Stages: 1=download 2=candidates 3=vcf-mode 4=discovery 5=review
EOF
}

while [[ $# -gt 0 ]]; do
    case "$1" in
        --data-dir)       DATA_DIR="$2"; shift 2 ;;
        --results-dir)    RESULTS_DIR="$2"; shift 2 ;;
        --kmer-size)      KMER_SIZE="$2"; shift 2 ;;
        --threads)        THREADS="$2"; shift 2 ;;
        --gpus)           GPUS="$2"; shift 2 ;;
        --pad)            PAD_BP="$2"; shift 2 ;;
        --ref-fasta)      REF_FASTA="$2"; shift 2 ;;
        --kraken2-db)     KRAKEN2_DB="$2"; shift 2 ;;
        --skip-download)  SKIP_DOWNLOAD=1; shift ;;
        --skip-discovery) SKIP_DISCOVERY=1; shift ;;
        --start-stage)    START_STAGE="$2"; shift 2 ;;
        --stop-stage)     STOP_STAGE="$2"; shift 2 ;;
        --dry-run)        DRY_RUN=1; shift ;;
        -h|--help)        usage; exit 0 ;;
        *) echo "Unknown option: $1" >&2; usage >&2; exit 1 ;;
    esac
done

log()  { printf '[%s] %s\n' "$(date '+%Y-%m-%d %H:%M:%S')" "$*"; }
die()  { log "ERROR: $*" >&2; exit 1; }
run_stage() { [[ "$1" -ge "$START_STAGE" && "$1" -le "$STOP_STAGE" ]]; }

[[ "$KMER_SIZE" =~ ^[0-9]+$ ]] || die "--kmer-size must be an integer"
(( KMER_SIZE % 2 == 1 )) || die "--kmer-size must be odd (got $KMER_SIZE)"
(( KMER_SIZE >= 3 && KMER_SIZE <= 201 )) \
    || die "--kmer-size out of range 3..201"
[[ "$START_STAGE" -le "$STOP_STAGE" ]] \
    || die "--start-stage > --stop-stage"
[[ "$GPUS" =~ ^[1-9][0-9]*$ ]] || die "--gpus must be a positive integer"

SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_DIR="$(cd "$SCRIPT_DIR/../.." && pwd)"
export PYTHONPATH="$REPO_DIR:${PYTHONPATH:-}"
PY=(python)

# run_cli ENTRY ARGS... — one CLI process, or with --gpus N > 1 one per
# card: each takes only its own GPU, so no two processes reserve one
# card's memory; process 0 writes the outputs.
run_cli() {
    local entry="$1"; shift
    local code="from kmer_denovo_filter_tpu.cli import $entry; $entry()"
    if (( GPUS <= 1 )); then
        "${PY[@]}" -c "$code" "$@"
        return
    fi
    local port=$(( 20000 + RANDOM % 20000 )) i rc=0 pids=()
    for (( i = 0; i < GPUS; i++ )); do
        KDF_COORDINATOR="localhost:$port" KDF_NUM_PROCESSES="$GPUS" \
        KDF_PROCESS_ID="$i" KDF_LOCAL_DEVICE_IDS="$i" \
            "${PY[@]}" -c "$code" "$@" &
        pids+=($!)
    done
    for i in "${pids[@]}"; do wait "$i" || rc=$?; done
    return "$rc"
}

# validate the optional Kraken2 DB up front (fail fast, not in stage 3)
if [[ -n "$KRAKEN2_DB" ]]; then
    for req in hash.k2d opts.k2d taxo.k2d; do
        [[ -f "$KRAKEN2_DB/$req" ]] \
            || die "Kraken2 DB missing $req under: $KRAKEN2_DB"
    done
    command -v kraken2 >/dev/null \
        || die "--kraken2-db given but kraken2 is not in PATH"
fi

GIAB_BASE="https://ftp-trace.ncbi.nlm.nih.gov/ReferenceSamples/giab"
ALN_BASE="$GIAB_BASE/data"
VCF_BASE="$GIAB_BASE/release"
REF_URL="https://ftp-trace.ncbi.nlm.nih.gov/ReferenceSamples/giab/release/references/GRCh38/GCA_000001405.15_GRCh38_no_alt_analysis_set.fasta.gz"

declare -A BAMS=(
    [HG002]="$ALN_BASE/AshkenazimTrio/HG002_NA24385_son/NIST_Illumina_2x250bps/novoalign_bams/HG002.GRCh38.2x250.bam"
    [HG003]="$ALN_BASE/AshkenazimTrio/HG003_NA24149_father/NIST_Illumina_2x250bps/novoalign_bams/HG003.GRCh38.2x250.bam"
    [HG004]="$ALN_BASE/AshkenazimTrio/HG004_NA24143_mother/NIST_Illumina_2x250bps/novoalign_bams/HG004.GRCh38.2x250.bam"
)
declare -A VCFS=(
    [HG002]="$VCF_BASE/AshkenazimTrio/HG002_NA24385_son/NISTv4.2.1/GRCh38/HG002_GRCh38_1_22_v4.2.1_benchmark.vcf.gz"
    [HG003]="$VCF_BASE/AshkenazimTrio/HG003_NA24149_father/NISTv4.2.1/GRCh38/HG003_GRCh38_1_22_v4.2.1_benchmark.vcf.gz"
    [HG004]="$VCF_BASE/AshkenazimTrio/HG004_NA24143_mother/NISTv4.2.1/GRCh38/HG004_GRCh38_1_22_v4.2.1_benchmark.vcf.gz"
)

CHILD_BAM="$DATA_DIR/$(basename "${BAMS[HG002]}")"
FATHER_BAM="$DATA_DIR/$(basename "${BAMS[HG003]}")"
MOTHER_BAM="$DATA_DIR/$(basename "${BAMS[HG004]}")"
CANDIDATES="$RESULTS_DIR/putative_denovos.vcf.gz"
ANNOTATED="$RESULTS_DIR/annotated.vcf.gz"
[[ -n "$REF_FASTA" ]] || REF_FASTA="$DATA_DIR/GRCh38.fa"

log "── HG002 trio pipeline plan ──────────────────────────────────"
log "  data dir:     $DATA_DIR"
log "  results dir:  $RESULTS_DIR"
log "  k-mer size:   $KMER_SIZE    threads: $THREADS    pad: ±${PAD_BP} bp"
log "  GPUs:         $GPUS (one process each)"
log "  ref FASTA:    $REF_FASTA"
log "  kraken2 DB:   ${KRAKEN2_DB:-(disabled)}"
log "  stages:       $START_STAGE..$STOP_STAGE" \
    "$( ((SKIP_DOWNLOAD)) && echo '(downloads skipped)')" \
    "$( ((SKIP_DISCOVERY)) && echo '(discovery skipped)')"
log "──────────────────────────────────────────────────────────────"
[[ "$DRY_RUN" -eq 1 ]] && exit 0

mkdir -p "$DATA_DIR" "$RESULTS_DIR"

# fetch <url> <dest> — idempotent, resumable download with size check
fetch() {
    local url="$1" dest="$2"
    if [[ -s "$dest" ]]; then
        log "  [skip] $(basename "$dest") (already exists)"
        return 0
    fi
    command -v wget >/dev/null || die "wget is required for downloads"
    log "  [get ] $(basename "$dest")"
    wget --continue --quiet --show-progress -O "$dest.part" "$url" \
        || die "download failed: $url"
    [[ -s "$dest.part" ]] || die "empty download: $url"
    mv "$dest.part" "$dest"
}

# ── Stage 1: downloads ───────────────────────────────────────────────
if run_stage 1 && [[ "$SKIP_DOWNLOAD" -eq 0 ]]; then
    log "Stage 1/5: downloads → $DATA_DIR"
    for sample in HG002 HG003 HG004; do
        fetch "${BAMS[$sample]}"      "$DATA_DIR/$(basename "${BAMS[$sample]}")"
        fetch "${BAMS[$sample]}.bai"  "$DATA_DIR/$(basename "${BAMS[$sample]}").bai"
        fetch "${VCFS[$sample]}"      "$DATA_DIR/$(basename "${VCFS[$sample]}")"
        fetch "${VCFS[$sample]}.tbi"  "$DATA_DIR/$(basename "${VCFS[$sample]}").tbi"
    done
    if [[ ! -s "$REF_FASTA" && ! -s "$REF_FASTA.gz" ]]; then
        fetch "$REF_URL" "$REF_FASTA.gz"
        log "  decompressing reference"
        gunzip -k "$REF_FASTA.gz" && mv "${REF_FASTA%.fa}.fasta" "$REF_FASTA" 2>/dev/null || true
        [[ -s "$REF_FASTA" ]] || gunzip -c "$REF_FASTA.gz" > "$REF_FASTA"
    fi
else
    log "Stage 1/5: SKIPPED"
fi

# validate stage-1 artifacts before any compute stage
if run_stage 2 || run_stage 3 || run_stage 4; then
    for f in "$CHILD_BAM" "$FATHER_BAM" "$MOTHER_BAM"; do
        [[ -s "$f" ]]      || die "missing BAM: $f (run stage 1 first)"
        [[ -s "$f.bai" ]]  || die "missing index: $f.bai"
    done
fi

# ── Stage 2: putative de novo candidates (child-private sites) ──────
if run_stage 2; then
    if [[ -s "$CANDIDATES" ]]; then
        log "Stage 2/5: [skip] $CANDIDATES (already exists)"
    else
        log "Stage 2/5: child-private candidate sites"
        "${PY[@]}" "$REPO_DIR/scripts/identify_putative_denovos.py" \
            --child-vcf "$DATA_DIR/$(basename "${VCFS[HG002]}")" \
            --father-vcf "$DATA_DIR/$(basename "${VCFS[HG003]}")" \
            --mother-vcf "$DATA_DIR/$(basename "${VCFS[HG004]}")" \
            --output "$CANDIDATES"
    fi
    [[ -s "$CANDIDATES" ]] || die "stage 2 produced no candidates file"
else
    log "Stage 2/5: SKIPPED"
fi

# ── Stage 3: kmer-denovo (VCF mode, device engine) ───────────────────
if run_stage 3; then
    if [[ -s "$ANNOTATED" && -s "$RESULTS_DIR/metrics.json" ]]; then
        log "Stage 3/5: [skip] $ANNOTATED (already exists)"
    else
        log "Stage 3/5: kmer-denovo on the GPU"
        kraken_args=()
        [[ -n "$KRAKEN2_DB" ]] && kraken_args=(--kraken2-db "$KRAKEN2_DB")
        run_cli vcf_main \
            --child "$CHILD_BAM" --mother "$MOTHER_BAM" \
            --father "$FATHER_BAM" \
            --vcf "$CANDIDATES" \
            --output "$ANNOTATED" \
            --metrics "$RESULTS_DIR/metrics.json" \
            --summary "$RESULTS_DIR/summary.txt" \
            --informative-reads "$RESULTS_DIR/informative.bam" \
            --kmer-size "$KMER_SIZE" --threads "$THREADS" \
            --proband-id HG002 \
            --report "$RESULTS_DIR/report.html" \
            "${kraken_args[@]}"
    fi
    [[ -s "$ANNOTATED" ]] || die "stage 3 produced no annotated VCF"
else
    log "Stage 3/5: SKIPPED"
fi

# ── Stage 4: kmer-discovery (VCF-free) ───────────────────────────────
if run_stage 4 && [[ "$SKIP_DISCOVERY" -eq 0 ]]; then
    if [[ -s "$RESULTS_DIR/discovery.bed" ]]; then
        log "Stage 4/5: [skip] discovery outputs already exist"
    elif [[ ! -s "$REF_FASTA" ]]; then
        log "Stage 4/5: SKIPPED (no reference FASTA at $REF_FASTA)"
    else
        log "Stage 4/5: kmer-discovery on the GPU"
        # the proband index snapshot makes stage 4 itself resumable
        run_cli discovery_main \
            --child "$CHILD_BAM" --mother "$MOTHER_BAM" \
            --father "$FATHER_BAM" \
            --ref-fasta "$REF_FASTA" \
            --out-prefix "$RESULTS_DIR/discovery" \
            --kmer-size "$KMER_SIZE" --threads "$THREADS" \
            --save-proband-index "$RESULTS_DIR/proband_index.npz" \
            --candidate-summary "$RESULTS_DIR/summary.txt"
    fi
else
    log "Stage 4/5: SKIPPED"
fi

# ── Stage 5: mini BAMs + IGV review TSV ──────────────────────────────
if run_stage 5; then
    [[ -s "$ANNOTATED" ]] \
        || die "stage 5 needs the annotated VCF (run stage 3)"
    log "Stage 5/5: ±${PAD_BP} bp mini BAMs + IGV review TSV"
    "${PY[@]}" "$REPO_DIR/scripts/extract_mini_bams.py" \
        --vcf "$ANNOTATED" \
        --bam "child=$CHILD_BAM" --bam "father=$FATHER_BAM" \
        --bam "mother=$MOTHER_BAM" \
        --padding "$PAD_BP" \
        --out-dir "$RESULTS_DIR/mini_bams"
    "${PY[@]}" "$REPO_DIR/scripts/create_igv_review_tsv.py" \
        --vcf "$ANNOTATED" \
        --mini-dir "$RESULTS_DIR/mini_bams" \
        --output "$RESULTS_DIR/igv_review.tsv"
else
    log "Stage 5/5: SKIPPED"
fi

log "Done. Results in $RESULTS_DIR"
