"""kmer_denovo_filter_tpu — device-native de novo mutation k-mer engine.

A ground-up JAX/XLA re-design of the capabilities of
jlanej/kmer_denovo_filter (reference: /root/reference):

* ``kmer-denovo``   — VCF-mode candidate variant annotation with k-mer
  evidence (DKU/DKT/DKA, PKC stats, optional Kraken2 fractions).
* ``kmer-discovery`` — VCF-free whole-genome discovery of regions
  carrying proband-unique k-mers (BED/bedGraph/BEDPE/metrics/summary).
* ``kmer-report``    — standalone self-contained HTML report.

Architectural differences from the reference (see SURVEY.md §7):

* The reference delegates all heavy compute to external native binaries
  (Jellyfish, samtools, pysam/htslib, pyahocorasick) driven by
  subprocesses and Unix pipes.  This package replaces that entire layer
  with a device-resident k-mer engine: 2-bit packed canonical k-mer
  keys, sort-based counting and vectorized binary-search probing on
  the accelerator via plain jnp/lax, plus a self-contained htslib-free
  BAM/VCF/FASTA/BGZF/tabix I/O stack.
* Multi-chip scaling uses ``jax.sharding.Mesh`` + ``shard_map`` with
  hash-prefix sharded k-mer tables and all-to-all query routing
  (see kmer_denovo_filter_tpu/parallel/).
"""

__version__ = "0.1.0"
