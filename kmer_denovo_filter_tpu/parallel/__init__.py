"""Multi-chip scaling: hash-prefix sharded k-mer tables over a Mesh."""

from kmer_denovo_filter_tpu.parallel.sharded import (  # noqa: F401
    ShardedFilteredCounter,
    ShardedKmerIndex,
    make_mesh,
    sharded_count,
    sharded_scan_reads_for_hits,
)
from kmer_denovo_filter_tpu.parallel import multihost  # noqa: F401
