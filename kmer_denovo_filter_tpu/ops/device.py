"""Device (jnp/XLA) k-mer kernels: extraction, sort-count, probe.

This is the device replacement for Jellyfish's count/query/dump core
(reference core/jellyfish_wrappers.py, kmer_utils.py:124–245):

* :func:`extract_canonical_windows` — all canonical k-mer keys of a
  padded 2-bit read batch, fully vectorised (shift/or word packing;
  no per-window gather of k bases).
* :func:`sort_count` — sort-based canonical counting
  (``jellyfish count -C`` ≡ a multi-operand ``lax.sort`` over W
  uint32 words + segment sum).
* :func:`lookup_sorted` / :func:`lookup_bucketed` — batched
  membership/count probe (``jellyfish query`` ≡ vectorised binary
  search; the bucketed form starts from per-prefix rank offsets).
* :func:`filtered_tally_step_bucketed` / :func:`scan_hits_step_bucketed`
  — the engine's fused per-batch steps: extract → dedup → probe the
  distinct keys → tally, or → per-window hit mask.

All functions are jit-compatible with static ``k``; shapes are padded
by the engine layer to limit recompiles.  The invalid/padding sentinel
is all-ones in every word, which (k odd) can never be a real canonical
key and sorts after all real keys.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from kmer_denovo_filter_tpu.ops.encode import words_per_kmer

SENTINEL = jnp.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("k",))
def extract_canonical_windows(codes, lengths, k):
    """Canonical k-mer keys for every window of a padded read batch.

    Args:
        codes: (B, L) uint8/int32 2-bit base codes; 4 marks N/padding.
        lengths: (B,) int32 true read lengths.
        k: k-mer length (static).

    Returns:
        keys: (B, S, W) uint32 canonical keys, S = L - k + 1
            (sentinel rows where invalid).
        valid: (B, S) bool — window inside the read and free of N.
    """
    codes = codes.astype(jnp.int32)
    b, length = codes.shape
    s = length - k + 1
    if s <= 0:
        raise ValueError(f"reads shorter than k={k}")
    w = words_per_kmer(k)
    full_words = k // 16
    rem = k % 16  # >0 because k is odd

    is_bad = (codes >= 4).astype(jnp.int32)
    clean = jnp.where(codes >= 4, 0, codes)
    comp = 3 - clean

    # pack32[t] = big-endian pack of clean[t..t+15]; needs 15 pad cols.
    padded = jnp.pad(clean, ((0, 0), (0, 15)))
    t_len = length  # t in [0, L-1]
    pack32 = jnp.zeros((b, t_len), dtype=jnp.uint32)
    for i in range(16):
        pack32 = pack32 | (
            padded[:, i:i + t_len].astype(jnp.uint32)
            << jnp.uint32(2 * (15 - i)))

    # rpack32[t] packs comp[t] (MSB) down to comp[t-15] (LSB), using a
    # 15-column leading pad so t-15 never indexes out of bounds.
    comp_p = jnp.pad(comp, ((0, 0), (15, 0)))
    rpack32 = jnp.zeros((b, t_len), dtype=jnp.uint32)
    for i in range(16):
        rpack32 = rpack32 | (
            comp_p[:, i:i + t_len].astype(jnp.uint32)
            << jnp.uint32(2 * i))

    last_mask = jnp.uint32(((1 << (2 * rem)) - 1) << (32 - 2 * rem))

    fwd_words = []
    rc_words = []
    for wi in range(w):
        if wi < full_words:
            fwd_words.append(jax.lax.dynamic_slice_in_dim(
                pack32, 16 * wi, s, axis=1))
            # rc word wi: MSB = comp[s + k - 1 - 16*wi] = rpack32 at
            # that index, so slice start is k - 1 - 16*wi.
            rc_words.append(jax.lax.dynamic_slice_in_dim(
                rpack32, k - 1 - 16 * wi, s, axis=1))
        else:
            fwd_words.append(jax.lax.dynamic_slice_in_dim(
                pack32, 16 * wi, s, axis=1) & last_mask)
            # rc last word: rpack32p index s + rem - 1 (with 15-lead pad)
            rc_words.append(jax.lax.dynamic_slice_in_dim(
                rpack32, rem - 1, s, axis=1) & last_mask)

    # canonical = word-wise lexicographic min(fwd, rc)
    lt = jnp.zeros((b, s), dtype=bool)
    eq = jnp.ones((b, s), dtype=bool)
    for wi in range(w):
        lt = lt | (eq & (fwd_words[wi] < rc_words[wi]))
        eq = eq & (fwd_words[wi] == rc_words[wi])
    pick_fwd = lt | eq

    # validity: no N in window, window fits in the read
    bad_prefix = jnp.cumsum(
        jnp.pad(is_bad, ((0, 0), (1, 0))), axis=1)  # (B, L+1)
    bad_in_win = (jax.lax.dynamic_slice_in_dim(bad_prefix, k, s, axis=1)
                  - jax.lax.dynamic_slice_in_dim(bad_prefix, 0, s, axis=1))
    starts = jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
    valid = (bad_in_win == 0) & (starts + k <= lengths[:, None])

    key_words = []
    for wi in range(w):
        word = jnp.where(pick_fwd, fwd_words[wi], rc_words[wi])
        key_words.append(jnp.where(valid, word, SENTINEL))
    keys = jnp.stack(key_words, axis=-1)
    return keys, valid


@functools.partial(jax.jit, static_argnames=("w",))
def sort_count(flat_keys, w):
    """Sort flattened keys and compute run lengths.

    Args:
        flat_keys: (N, W) uint32 (sentinel rows allowed).
        w: word count (static).

    Returns:
        sorted_keys: (N, W) uint32 in ascending order.
        starts: (N,) bool, True at the first row of each run.
        counts: (N,) int32, run length at each start row (0 elsewhere).
    """
    n = flat_keys.shape[0]
    operands = tuple(flat_keys[:, j] for j in range(w))
    sorted_ops = jax.lax.sort(operands, num_keys=w)
    skeys = jnp.stack(sorted_ops, axis=-1)
    neq = jnp.zeros(n, dtype=bool)
    for j in range(w):
        neq = neq.at[1:].set(neq[1:] | (sorted_ops[j][1:] != sorted_ops[j][:-1]))
    starts = neq.at[0].set(True)
    counts = _run_lengths(starts)
    return skeys, starts, counts


def _run_lengths(starts):
    """Run length at each run-start row (0 elsewhere).

    Segment-sum over run ids (one scatter-add + one gather).
    """
    n = starts.shape[0]
    group = jnp.cumsum(starts.astype(jnp.int32)) - 1
    counts_per_group = jax.ops.segment_sum(
        jnp.ones(n, dtype=jnp.int32), group, num_segments=n)
    return jnp.where(starts, counts_per_group[group], 0)


@functools.partial(jax.jit, static_argnames=("w",))
def sort_count_perm(flat_keys, w):
    """:func:`sort_count` + the sort permutation (original row index)."""
    n = flat_keys.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    operands = tuple(flat_keys[:, j] for j in range(w)) + (iota,)
    sorted_ops = jax.lax.sort(operands, num_keys=w)
    skeys = jnp.stack(sorted_ops[:w], axis=-1)
    perm = sorted_ops[w]
    neq = jnp.zeros(n, dtype=bool)
    for j in range(w):
        neq = neq.at[1:].set(
            neq[1:] | (sorted_ops[j][1:] != sorted_ops[j][:-1]))
    starts = neq.at[0].set(True)
    group = jnp.cumsum(starts.astype(jnp.int32)) - 1
    counts = _run_lengths(starts)
    return skeys, starts, counts, group, perm


def _compact_uniques(skeys, starts, counts, w, cap):
    """Scatter run-start rows into fixed-capacity unique buffers.

    Returns (uniq_keys (cap, W), uniq_counts (cap,), overflow).
    Sentinel runs land in the discard slot; real runs beyond *cap*
    raise the overflow flag so the caller can retry with a larger cap.
    """
    n = skeys.shape[0]
    sent = jnp.ones(n, dtype=bool)
    for j in range(w):
        sent = sent & (skeys[:, j] == SENTINEL)
    real_start = starts & ~sent
    pos = jnp.cumsum(real_start.astype(jnp.int32)) - 1
    overflow = jnp.any(real_start & (pos >= cap))
    tgt = jnp.where(real_start & (pos < cap), pos, cap)
    ukeys = jnp.full((cap + 1, w), SENTINEL).at[tgt].set(skeys)[:cap]
    ucnts = jnp.zeros(cap + 1, jnp.int32).at[tgt].set(counts)[:cap]
    upos_of_group = pos  # per sorted row: unique slot of its run start
    return ukeys, ucnts, upos_of_group, overflow


def _lex_le_gather(table, idx, q, w):
    """table[idx] <= q, lexicographic over w words. idx clipped."""
    m = table.shape[0]
    idx_c = jnp.clip(idx, 0, m - 1)
    lt = jnp.zeros(q.shape[0], dtype=bool)
    eq = jnp.ones(q.shape[0], dtype=bool)
    for j in range(w):
        tj = table[idx_c, j]
        qj = q[:, j]
        lt = lt | (eq & (tj < qj))
        eq = eq & (tj == qj)
    return lt | eq


def build_bucket_offsets(keys_np, p_bits):
    """Host-side: per-prefix rank offsets for the bucketed probe.

    ``off[p]`` = first table row whose word0's top *p_bits* are >= p.
    Returns (off (2^p+1,) int32, max_bucket).
    """
    import numpy as _np
    prefixes = (keys_np[:, 0] >> np.uint32(32 - p_bits)).astype(_np.int64)
    counts = _np.bincount(prefixes, minlength=1 << p_bits)
    off = _np.zeros((1 << p_bits) + 1, dtype=_np.int32)
    _np.cumsum(counts, out=off[1:])
    return off, int(counts.max()) if counts.size else 0


@functools.partial(jax.jit, static_argnames=("w", "p_bits", "rounds"))
def lookup_bucketed(table, off, queries, w, p_bits, rounds):
    """Bucket-pointer probe: prefix offsets + short local binary search.

    The top *p_bits* of word0 select a precomputed rank range in the
    sorted table, so only ``rounds`` = ceil(log2(max_bucket)) binary
    search iterations remain — ~3-5x fewer gather passes than the
    full-table search, which is the dominant cost of device probes.
    """
    m = table.shape[0]
    n = queries.shape[0]
    p = (queries[:, 0] >> jnp.uint32(32 - p_bits)).astype(jnp.int32)
    lo = off[p] - 1          # table[lo] <= q (virtual -inf at -1)
    hi = off[p + 1]          # table[hi] > q

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) // 2
        le = _lex_le_gather(table, mid, queries, w)
        lo = jnp.where(le, mid, lo)
        hi = jnp.where(le, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, rounds, body, (lo, hi))
    idx_c = jnp.clip(lo, 0, m - 1)
    eq = jnp.ones(n, dtype=bool)
    for j in range(w):
        eq = eq & (table[idx_c, j] == queries[:, j])
    found = eq & (lo >= 0)
    return lo, found


@functools.partial(
    jax.jit, static_argnames=("k", "w", "m_pad", "cap", "p_bits",
                              "rounds"))
def filtered_tally_step_bucketed(table, off, acc, codes, lengths, k, w,
                                 m_pad, cap, p_bits, rounds):
    """Fused parent-scan step: extract → dedup → probe uniques → tally.

    Window keys are deduplicated with one sort (coverage-local read
    batches dedup 10–30×), only the ≤ ``cap`` distinct keys run the
    bucket-pointer probe, and each hit adds its in-batch multiplicity
    to the table tally.  Returns (acc', overflow): *overflow* means the
    batch had more than *cap* distinct keys and must be replayed with
    a larger one.
    """
    keys, _valid = extract_canonical_windows(codes, lengths, k)
    flat = keys.reshape(-1, w)
    skeys, starts, counts = sort_count(flat, w)
    ukeys, ucnts, _upos, overflow = _compact_uniques(
        skeys, starts, counts, w, cap)
    idx, found = lookup_bucketed(table, off, ukeys, w, p_bits, rounds)
    # misses and the compacted stream's zero-count sentinel padding
    # (which "finds" a padded table's sentinel rows) point past the
    # table and are dropped: sent to one row instead, they all hit
    # that row's address and serialise the scatter on the GPU
    rows = jnp.where(found & (ucnts > 0), idx, m_pad)
    acc = acc.at[rows].add(ucnts, mode="drop")
    return acc, overflow


@functools.partial(
    jax.jit, static_argnames=("k", "w", "cap", "p_bits", "rounds"))
def scan_hits_step_bucketed(table, off, codes, lengths, k, w, cap,
                            p_bits, rounds):
    """Fused anchoring step: per-window hit mask via dedup + probe.

    Probes each batch-distinct key once, then maps verdicts back to
    the (B, S) window grid through the sort permutation.  Returns
    (found (B, S) bool, overflow).
    """
    b, length = codes.shape
    s = length - k + 1
    keys, valid = extract_canonical_windows(codes, lengths, k)
    flat = keys.reshape(-1, w)
    skeys, starts, counts, group, perm = sort_count_perm(flat, w)
    ukeys, _ucnts, upos_of_row, overflow = _compact_uniques(
        skeys, starts, counts, w, cap)
    _idx, ufound = lookup_bucketed(table, off, ukeys, w, p_bits, rounds)
    row_found = ufound[jnp.clip(upos_of_row, 0, cap - 1)] \
        & (upos_of_row >= 0) & (upos_of_row < cap)
    n = flat.shape[0]
    found_flat = jnp.zeros(n, dtype=bool).at[perm].set(row_found)
    found = found_flat.reshape(b, s) & valid
    return found, overflow


@functools.partial(jax.jit, static_argnames=("w",))
def lookup_sorted(table, queries, w):
    """Vectorised binary search of query rows in a sorted key table.

    Args:
        table: (M, W) uint32 sorted ascending (sentinel padding at end).
        queries: (N, W) uint32.
        w: word count (static).

    Returns:
        idx: (N,) int32 position of the first row >= query.
        found: (N,) bool exact-match flag.
    """
    m = table.shape[0]
    n = queries.shape[0]
    steps = max(1, (m + 1).bit_length())
    lo = jnp.full(n, -1, dtype=jnp.int32)   # table[lo] <= q (virtual -inf)
    hi = jnp.full(n, m, dtype=jnp.int32)    # table[hi] > q (virtual +inf)

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) // 2
        le = _lex_le_gather(table, mid, queries, w)
        lo = jnp.where(le, mid, lo)
        hi = jnp.where(le, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    # exact match iff table[lo] == q
    idx_c = jnp.clip(lo, 0, m - 1)
    eq = jnp.ones(n, dtype=bool)
    for j in range(w):
        eq = eq & (table[idx_c, j] == queries[:, j])
    found = eq & (lo >= 0)
    return lo, found


def pad_pow2_rows(arr, fill):
    """Pad axis 0 to the next power of two (numpy helper)."""
    n = arr.shape[0]
    target = 1 if n == 0 else 1 << (n - 1).bit_length()
    if target == n:
        return arr
    pad = np.full((target - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
