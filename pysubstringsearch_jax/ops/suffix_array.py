"""Suffix-array construction.

The reference builds suffix arrays with libsais' SA-IS induced sorting
(reference: src/libsais/libsais.c:6597, called from src/lib.rs:24-40) — a
linear-time but inherently *sequential* algorithm: its hot loops are
data-dependent scatters (``SA[bucket[c]++] = ...``) that do not vectorize.

This module re-casts SA construction as **prefix doubling** (Manber–Myers):
O(n log n) fully-vectorizable work — each round is one key sort plus
elementwise rank relabeling, which XLA compiles to large fused device ops.
The SA of a string is unique, so any correct construction yields bytes
identical to libsais' output; conformance is exact.

Three backends, one contract (``uint8[n] -> int32[n]``):

- ``suffix_array_numpy`` — host reference implementation (np.lexsort rounds).
- ``suffix_array_jax``   — device implementation: padded, jit-compiled,
  ``lax.sort`` rounds inside a ``lax.while_loop`` with early exit.
- the native C++ SA-IS in :mod:`pysubstringsearch_jax.ops.native` (built
  on first use) for fast host-side builds.

Comparison convention (must match the reference's byte-compare at
src/lib.rs:224-228): plain bytewise order where a proper prefix sorts before
any extension.  We realize it by ranking real bytes as ``b + 1`` and
past-the-end as ``0``.
"""

from __future__ import annotations

import typing

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    'build_suffix_array',
    'suffix_array_numpy',
    'suffix_array_jax',
    'suffix_array_int',
]


# ---------------------------------------------------------------------------
# Host reference implementation
# ---------------------------------------------------------------------------

def suffix_array_numpy(data: np.ndarray) -> np.ndarray:
    """Prefix-doubling SA on the host; ground truth for the device kernels."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.int32)
    rank = data.astype(np.int64)
    order = np.argsort(rank, kind='stable').astype(np.int64)
    k = 1
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        if k < n:
            rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        r1 = rank[order]
        r2 = rank2[order]
        flags = np.empty(n, dtype=np.int64)
        flags[0] = 0
        flags[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank_sorted = np.cumsum(flags)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        if new_rank_sorted[-1] == n - 1 or k >= n:
            break
        k *= 2
    return order.astype(np.int32)


def suffix_array_int(
    data: np.ndarray,
    k: typing.Optional[int] = None,
    backend: str = 'auto',
) -> np.ndarray:
    """SA over an integer alphabet ``[0, k)`` — parity with the reference
    kernel's ``libsais_int`` entry point (src/libsais/libsais.c:6612-6625),
    which the product never calls but the kernel API exposes.

    Same comparison convention as the byte path: a proper prefix sorts
    before any extension.  ``k`` defaults to ``max(data) + 1``.
    """
    data = np.ascontiguousarray(data, dtype=np.int32)
    if data.size and data.min() < 0:
        raise ValueError('alphabet values must be non-negative')
    if k is None:
        k = int(data.max()) + 1 if data.size else 1
    if data.size and int(data.max()) >= k:
        raise ValueError('alphabet value out of range')
    if k > 1 << 30:
        raise ValueError('alphabet too large (k must be <= 2**30)')
    if backend in ('native', 'auto'):
        from . import native

        if native.available():
            return native.suffix_array_int_native(data, k)
        if backend == 'native':
            raise RuntimeError('native backend unavailable')
    if backend == 'jax':
        return _suffix_array_int_jax(data)
    # numpy prefix doubling is alphabet-agnostic.
    return _suffix_array_int_numpy(data)


def _suffix_array_int_numpy(data: np.ndarray) -> np.ndarray:
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.int32)
    rank = data.astype(np.int64)
    k = 1
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        if k < n:
            rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        r1, r2 = rank[order], rank2[order]
        flags = np.empty(n, dtype=np.int64)
        flags[0] = 0
        flags[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank_sorted = np.cumsum(flags)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        if new_rank_sorted[-1] == n - 1 or k >= n:
            break
        k *= 2
    return order.astype(np.int32)


def _suffix_array_int_jax(data: np.ndarray) -> np.ndarray:
    """Device doubling over an int alphabet: ranks start as ``value + 1``
    (pad sentinel 0) — not dense, but order-preserving, which is all a
    doubling round needs — then standard rounds from k=1."""
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.int32)
    N = _pad_len(n)
    padded = np.zeros(N, dtype=np.int32)
    padded[:n] = data + 1
    sa_full = _int_doubling_jit(jnp.asarray(padded), jnp.int32(n))
    return np.asarray(sa_full[N - n:])


# ---------------------------------------------------------------------------
# Device implementation (JAX; runs on any XLA backend)
# ---------------------------------------------------------------------------

def _init_round(data_padded: jnp.ndarray, n: jnp.ndarray):
    """Initial ordering by 6-byte prefix: one 2-key sort covers k in 1..6,
    so the doubling loop starts at k=6 — for natural text (ranks typically
    distinct by k ~ 16..64) this halves the round count versus a byte-wise
    start."""
    N = data_padded.shape[0]
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    d = jnp.where(iota < n, data_padded.astype(jnp.int32) + 1, 0)

    def shifted(j):
        return jnp.where(iota + j < n, jnp.roll(d, -j), 0)

    # Two base-257 3-byte limbs; each < 257**3, comfortably int32.
    limb0 = (d * 257 + shifted(1)) * 257 + shifted(2)
    limb1 = (shifted(3) * 257 + shifted(4)) * 257 + shifted(5)
    l0_s, l1_s, idx_s = lax.sort(
        (limb0, limb1, iota), num_keys=2, is_stable=False
    )
    changed = jnp.logical_or(
        l0_s != jnp.roll(l0_s, 1), l1_s != jnp.roll(l1_s, 1)
    )
    flags = jnp.where(iota == 0, 0, changed.astype(jnp.int32))
    rank_s = jnp.cumsum(flags, dtype=jnp.int32)
    rank = jnp.zeros((N,), jnp.int32).at[idx_s].set(rank_s)
    return rank, idx_s, rank_s[-1] + 1


def _doubling_round(rank: jnp.ndarray, k: jnp.ndarray):
    """One prefix-doubling round: sort by (rank[i], rank[i+k]), relabel."""
    N = rank.shape[0]
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    rank2 = jnp.where(iota + k < N, jnp.roll(rank, -k), -1)
    r1_s, r2_s, idx_s = lax.sort((rank, rank2, iota), num_keys=2, is_stable=False)
    changed = jnp.logical_or(r1_s != jnp.roll(r1_s, 1), r2_s != jnp.roll(r2_s, 1))
    flags = jnp.where(iota == 0, 0, changed.astype(jnp.int32))
    rank_s = jnp.cumsum(flags, dtype=jnp.int32)
    new_rank = jnp.zeros((N,), jnp.int32).at[idx_s].set(rank_s)
    return new_rank, idx_s, rank_s[-1] + 1


_init_round_jit = jax.jit(_init_round)
_doubling_round_jit = jax.jit(_doubling_round, donate_argnums=(0,))


def _doubling_kernel(data_padded: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """SA of ``data_padded[:n]`` returned as the tail of a length-N_pad array.

    The text is padded to a static length ``N`` with a rank-0 sentinel that is
    strictly smaller than any real byte's rank (``b + 1``).  The SA of the
    padded string is then ``[N-1, N-2, ..., n] ++ SA(text)`` — padding
    suffixes are the runs ``0^j``, ordered shortest-first, all before any real
    suffix — so the caller just slices off the first ``N - n`` entries.

    Single-program (lax.while_loop) with on-device early exit: used both by
    ``suffix_array_jax`` (the whole build is one dispatch — no per-round
    host syncs, see its docstring) and inside shard_map programs that need
    the build within one traced computation (sharded build / dry run).
    The loop body is sort-dominated, so while_loop per-iteration overhead is
    immaterial here, unlike the query path which unrolls statically.
    """
    N = data_padded.shape[0]
    rank, idx_s, num_ranks = _init_round(data_padded, n)

    def cond(state):
        k, _, _, num_ranks = state
        return jnp.logical_and(k < N, num_ranks < N)

    def body(state):
        k, rank, _, _ = state
        new_rank, idx_s, num_ranks = _doubling_round(rank, k)
        return k * 2, new_rank, idx_s, num_ranks

    _, _, sa_full, _ = lax.while_loop(
        cond, body, (jnp.int32(6), rank, idx_s, num_ranks)
    )
    return sa_full


_doubling_whole_jit = jax.jit(_doubling_kernel, donate_argnums=(0,))


# ---------------------------------------------------------------------------
# Segmented (tie-only) doubling — the default device build
# ---------------------------------------------------------------------------
#
# After the 6-byte initial sort, natural text leaves only a small fraction of
# suffixes in tied groups; re-sorting all N elements every round (as the plain
# kernel does, and as libsais' OpenMP block splits would, libsais.c:2138-2313)
# wastes nearly all of the sort.  This variant keeps the suffix order in
# *anchored* form —
#
#     sa[slot] = text position occupying SA slot `slot`
#     rank[pos] = slot of the FIRST member of pos's equivalence group
#     gs[slot]  = rank[sa[slot]]  (maintained incrementally)
#
# — so each round only compacts the tied slots into a fixed [S]-element
# buffer (S = N/4), sorts *that* by (group, rank[pos+k]), and scatters the
# refined order back.  Group-start slots double as rank labels, which makes
# relabeling purely local to each group: untouched slots never move and never
# change rank.  If a round's tie count overflows S (adversarial inputs, e.g.
# one repeated byte), it falls back to a full-size sort round via lax.cond —
# correctness never depends on the tie distribution.
#
# Pad suffixes (the 0^j tail runs) are placed at their final slots directly
# by the init round (slot = N-1-pos, singleton groups), so padding never
# occupies buffer capacity.

# Tie-buffer sizing, from the tie counts of the 272 MiB bench rows (a
# property of the text, whatever the device):
# the INIT leaves 33.7% of slots tied (> any practical buffer, so round 1
# always takes the full-size branch), while round 2 is left with ~0.02-0.5%
# — a smaller buffer halves the steady rounds' sort volume at no risk
# (overflow still falls back to the full branch via the loop's cond).
_SEG_DIV = 8  # buffer = N // _SEG_DIV


def _init_round_anchored(data_padded: jnp.ndarray, n: jnp.ndarray):
    """6-byte initial sort in anchored form: returns (sa, rank, gs)."""
    N = data_padded.shape[0]
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    d = jnp.where(iota < n, data_padded.astype(jnp.int32) + 1, 0)

    def shifted(j):
        return jnp.where(iota + j < n, jnp.roll(d, -j), 0)

    limb0 = (d * 257 + shifted(1)) * 257 + shifted(2)
    limb1 = (shifted(3) * 257 + shifted(4)) * 257 + shifted(5)
    l0_s, l1_s, idx_s = lax.sort(
        (limb0, limb1, iota), num_keys=2, is_stable=False
    )
    npad = N - n
    # The all-zero-limb group is exactly the pad positions; override their
    # slots with the known final order (shorter pad suffix = smaller) and
    # force singleton group boundaries across the pad region.
    sa = jnp.where(iota < npad, N - 1 - iota, idx_s)
    changed = jnp.logical_or(
        l0_s != jnp.roll(l0_s, 1), l1_s != jnp.roll(l1_s, 1)
    )
    changed = jnp.logical_or(changed, iota <= npad)
    gs = lax.cummax(jnp.where(changed, iota, 0))
    rank = jnp.zeros((N,), jnp.int32).at[sa].set(gs)
    return sa, rank, gs


def _tied_flags(gs: jnp.ndarray) -> jnp.ndarray:
    """tied[slot] = slot's group has size >= 2 (a neighbor shares its start)."""
    N = gs.shape[0]
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    eq_next = jnp.logical_and(gs == jnp.roll(gs, -1), iota < N - 1)
    return jnp.logical_or(eq_next, jnp.roll(eq_next, 1))


def _relabel_and_scatter(g, r2, pos, sa, rank, gs):
    """Sort a (group, r2, pos) buffer and scatter the refined order back.

    Group-start values double as rank labels: element b of the sorted buffer
    belongs at global slot ``g[b] + offset_within_group`` and its new rank is
    the global slot of the first buffer element with the same (g, r2).
    Sentinel entries carry g >= N, so every scatter they produce lands out of
    bounds and is dropped.
    """
    S = g.shape[0]
    bidx = lax.broadcasted_iota(jnp.int32, (S,), 0)
    g_s, r2_s, pos_s = lax.sort((g, r2, pos), num_keys=2, is_stable=False)
    new_group = jnp.logical_or(g_s != jnp.roll(g_s, 1), bidx == 0)
    gstart = lax.cummax(jnp.where(new_group, bidx, 0))
    global_slot = g_s + (bidx - gstart)
    change = jnp.logical_or(new_group, r2_s != jnp.roll(r2_s, 1))
    first_eq = lax.cummax(jnp.where(change, global_slot, 0))
    sa = sa.at[global_slot].set(pos_s, mode='drop')
    rank = rank.at[pos_s].set(first_eq, mode='drop')
    gs = gs.at[global_slot].set(first_eq, mode='drop')
    return sa, rank, gs


def _init_round_anchored_ranked(
    data_padded: jnp.ndarray, n: jnp.ndarray, brank: jnp.ndarray, bits: int
):
    """Ranked-alphabet initial sort in anchored form: two limbs of
    ``D = 30 // bits`` rank digits each cover 2D characters (12 at bits=5)
    in the SAME one 2-key sort the 6-byte init costs — for natural text
    that removes one whole doubling round per row (~9 s at 272 Mi).

    ``brank`` must be an order-preserving byte->rank map with ranks >= 1
    for every byte that can occur (alphabet_rank), so the produced order
    equals the byte-order SA; rank 0 is the pad/past-end digit, keeping
    the all-zero-limb group exactly the pad positions.  Requires the
    caller's padding margin: positions within D of the array end must be
    past ``n`` (true for every derive-path caller — PAD_MARGIN — and
    asserted nowhere because ``n`` is traced; see derive_sa).
    """
    N = data_padded.shape[0]
    D = 30 // bits
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    e = jnp.where(
        iota < n, jnp.take(brank, data_padded.astype(jnp.int32)), 0
    )
    # Doubling ladder (at most three N-arrays live — see
    # search._ranked_pack_device for the OOM measurement this avoids).
    s2 = (e << bits) + jnp.roll(e, -1)
    s4 = (s2 << (2 * bits)) + jnp.roll(s2, -2)
    if D == 6:
        packed = (s4 << (2 * bits)) + jnp.roll(s2, -4)
    else:
        assert D == 5
        packed = (s4 << bits) + jnp.roll(e, -4)
    limb0 = jnp.where(iota < n, packed, 0)
    limb1 = jnp.where(iota + D < n, jnp.roll(limb0, -D), 0)
    l0_s, l1_s, idx_s = lax.sort(
        (limb0, limb1, iota), num_keys=2, is_stable=False
    )
    npad = N - n
    sa = jnp.where(iota < npad, N - 1 - iota, idx_s)
    changed = jnp.logical_or(
        l0_s != jnp.roll(l0_s, 1), l1_s != jnp.roll(l1_s, 1)
    )
    changed = jnp.logical_or(changed, iota <= npad)
    gs = lax.cummax(jnp.where(changed, iota, 0))
    rank = jnp.zeros((N,), jnp.int32).at[sa].set(gs)
    return sa, rank, gs


def _segmented_kernel(data_padded: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """SA of ``data_padded[:n]`` as the tail of a length-N array (same
    contract as ``_doubling_kernel``), via segmented doubling."""
    sa0, rank0, gs0 = _init_round_anchored(data_padded, n)
    return _segmented_loop(data_padded.shape[0], 6, sa0, rank0, gs0)


def _segmented_kernel_ranked(
    data_padded: jnp.ndarray, n: jnp.ndarray, brank: jnp.ndarray, bits: int
) -> jnp.ndarray:
    """Segmented doubling with the ranked 2D-character init (same output
    as ``_segmented_kernel`` — the rank map is order-preserving)."""
    D = 30 // bits
    sa0, rank0, gs0 = _init_round_anchored_ranked(data_padded, n, brank, bits)
    return _segmented_loop(data_padded.shape[0], 2 * D, sa0, rank0, gs0)


def _segmented_loop(N: int, k0: int, sa0, rank0, gs0) -> jnp.ndarray:
    S = max(N // _SEG_DIV, 8)

    def cond(state):
        k, sa, rank, gs = state
        return jnp.logical_and(k < N, jnp.any(_tied_flags(gs)))

    def body(state):
        k, sa, rank, gs = state
        iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
        tied = _tied_flags(gs)
        m = jnp.sum(tied.astype(jnp.int32))

        def seg_branch(sa, rank, gs):
            dest = jnp.where(
                tied, jnp.cumsum(tied.astype(jnp.int32)) - 1, S
            )
            buf_slot = (
                jnp.full((S + 1,), N, jnp.int32)
                .at[jnp.minimum(dest, S)].set(iota)[:S]
            )
            valid = buf_slot < N
            bidx = lax.broadcasted_iota(jnp.int32, (S,), 0)
            safe = jnp.minimum(buf_slot, N - 1)
            pos = jnp.where(valid, jnp.take(sa, safe, axis=0), N)
            g = jnp.where(valid, jnp.take(gs, safe, axis=0), N + bidx)
            r2 = jnp.where(
                pos + k < N,
                jnp.take(rank, jnp.clip(pos + k, 0, N - 1), axis=0),
                -1,
            )
            return _relabel_and_scatter(g, r2, pos, sa, rank, gs)

        def full_branch(sa, rank, gs):
            pos = sa
            r2 = jnp.where(
                pos + k < N,
                jnp.take(rank, jnp.clip(pos + k, 0, N - 1), axis=0),
                -1,
            )
            return _relabel_and_scatter(gs, r2, pos, sa, rank, gs)

        sa, rank, gs = lax.cond(m <= S, seg_branch, full_branch, sa, rank, gs)
        return k * 2, sa, rank, gs

    _, sa, _, _ = lax.while_loop(
        cond, body, (jnp.int32(k0), sa0, rank0, gs0)
    )
    return sa


_segmented_whole_jit = jax.jit(_segmented_kernel, donate_argnums=(0,))


# ---------------------------------------------------------------------------
# Rotating segmented doubling — the big-row derive kernel
# ---------------------------------------------------------------------------
#
# _segmented_kernel keeps a full-size 3-array sort as its overflow fallback
# inside lax.cond, and XLA reserves memory for the larger branch whether or
# not it runs: ~24 bytes/char, on top of the 6-byte init's 3-key full sort.
# This variant never sorts more than S = N/8 elements at once, so its peak
# stays near the resident state at the reference's 512 MiB chunks:
#
# - init: 3-byte prefix ranks from ONE (key, index) pair sort (4 N-arrays
#   peak instead of 6) for rows past 2^28; the 6-byte 3-key init below that.
# - Each k-round sweeps the SLOT space in windows: a window selects every
#   tied group whose START slot lies in [off, off + S/2) — whole groups
#   only (a split group would collide in _relabel_and_scatter's rank
#   arithmetic) — so a window holds at most S/2 + max-group <= S members,
#   and ``off`` jumps straight to the next selectable group start (slot
#   indices are stable across passes, so a sweep covers every group exactly
#   once per round).
#
# Soundness requires every tied group to be refined at every round (a group
# whose refinement is deferred would later be probed at an offset exceeding
# its true shared-prefix length, and a group whose r2 lands inside an
# unrefined neighbor could under-split and then mis-split later).  Groups
# larger than S/2 cannot be processed windowed, so their PRESENCE at any
# round poisons the lazy schedule: the kernel flags it and the python
# caller re-runs the full-sort kernel, whose allocation then — and only
# then — has to fit.  Natural text never trips this (group sizes are n-gram
# frequencies, orders of magnitude below S/2 = N/8); one-symbol-run
# adversarial inputs do.
#
# Within a sweep, earlier windows' refinements make some r2 values FINER
# than k, which is harmless: with equal k-prefixes, ordering by the finer
# rank of the k-offset tails is the true suffix order restricted to the
# group — sorting by a refinement of the comparison key cannot contradict
# the final order.

def _init_round_anchored3(data_padded: jnp.ndarray, n: jnp.ndarray):
    """3-byte initial sort in anchored form via ONE (key, index) pair sort;
    returns (sa, rank, gs) with k covered = 3."""
    N = data_padded.shape[0]
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    d = jnp.where(iota < n, data_padded.astype(jnp.int32) + 1, 0)

    def shifted(j):
        return jnp.where(iota + j < n, jnp.roll(d, -j), 0)

    key = (d * 257 + shifted(1)) * 257 + shifted(2)
    k_s, idx_s = lax.sort((key, iota), num_keys=1, is_stable=False)
    npad = N - n
    sa = jnp.where(iota < npad, N - 1 - iota, idx_s)
    changed = k_s != jnp.roll(k_s, 1)
    changed = jnp.logical_or(changed, iota <= npad)
    gs = lax.cummax(jnp.where(changed, iota, 0))
    rank = jnp.zeros((N,), jnp.int32).at[sa].set(gs)
    return sa, rank, gs


def _rotating_init(data_padded: jnp.ndarray, n: jnp.ndarray):
    """Initial anchored state (k0, off, poisoned, sa, rank, gs)."""
    N = data_padded.shape[0]
    if N <= (1 << 28):
        sa0, rank0, gs0 = _init_round_anchored(data_padded, n)
        k0 = 6
    else:
        sa0, rank0, gs0 = _init_round_anchored3(data_padded, n)
        k0 = 3
    return (jnp.int32(k0), jnp.int32(0), jnp.bool_(False), sa0, rank0, gs0)


def _rotating_pass(state, N: int, S: int, W: int):
    """One windowed refinement pass (see the section comment above).

    Kept deliberately lean — per pass: one cumsum (buffer destinations),
    one reverse cummin (the jump to the next tied group start), and the
    S-element gather/sort/scatter.  Oversized groups are DETECTED by member
    offset (iota - gs >= S/2) rather than measured: a window may then
    partially select one — which corrupts the refinement — but the poison
    flag makes the caller discard the whole result and fall back, so the
    cheap detection is safe.
    """
    k, off, poisoned, sa, rank, gs = state
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    tied = _tied_flags(gs)
    member_off = iota - gs
    poisoned = jnp.logical_or(
        poisoned, jnp.any(jnp.logical_and(tied, member_off >= S // 2))
    )
    sel = jnp.logical_and(
        tied, jnp.logical_and(gs >= off, gs < off + W)
    )
    sel = jnp.logical_and(sel, member_off < S // 2)
    scnt = jnp.cumsum(sel.astype(jnp.int32))
    dest = jnp.where(sel, scnt - 1, S)
    buf_slot = (
        jnp.full((S + 1,), N, jnp.int32)
        .at[jnp.minimum(dest, S)].set(iota)[:S]
    )
    valid = buf_slot < N
    bidx = lax.broadcasted_iota(jnp.int32, (S,), 0)
    safe = jnp.minimum(buf_slot, N - 1)
    pos = jnp.where(valid, jnp.take(sa, safe, axis=0), N)
    g = jnp.where(valid, jnp.take(gs, safe, axis=0), N + bidx)
    r2 = jnp.where(
        pos + k < N,
        jnp.take(rank, jnp.clip(pos + k, 0, N - 1), axis=0),
        -1,
    )
    sa, rank, gs = _relabel_and_scatter(g, r2, pos, sa, rank, gs)
    # Jump to the next tied group start at or past the window end (slot
    # indices are stable, so a sweep covers every group exactly once).
    start_flag = jnp.logical_or(gs != jnp.roll(gs, 1), iota == 0)
    tstarts = jnp.where(
        jnp.logical_and(start_flag, _tied_flags(gs)), iota, N
    )
    rc = lax.cummin(tstarts, reverse=True)
    nxt = lax.dynamic_slice(rc, (jnp.minimum(off + W, N - 1),), (1,))[0]
    nxt = jnp.where(off + W >= N, N, nxt)
    done_k = nxt >= N
    k = jnp.where(done_k, k * 2, k)
    off = jnp.where(done_k, 0, nxt)
    return k, off, poisoned, sa, rank, gs


def _rotating_kernel(data_padded: jnp.ndarray, n: jnp.ndarray):
    """(sa_full, poisoned): every refinement pass in one ``while_loop``
    that runs until no tie is left, like ``_segmented_kernel``."""
    N = data_padded.shape[0]
    S = max(N // _SEG_DIV, 8)
    W = max(S // 2, 4)

    def cond(state):
        k, off, _, _, _, gs = state
        sweeping = jnp.logical_or(k < N, off > 0)
        return jnp.logical_and(sweeping, jnp.any(_tied_flags(gs)))

    _, _, poisoned, sa, _, _ = lax.while_loop(
        cond, lambda state: _rotating_pass(state, N, S, W),
        _rotating_init(data_padded, n),
    )
    return sa, poisoned


_rotating_jit = jax.jit(_rotating_kernel)


def segmented_rotating_sa(data_padded: jnp.ndarray, n) -> typing.Tuple[
        jnp.ndarray, jnp.ndarray]:
    """SA of ``data_padded[:n]`` as the tail of a length-N array via the
    rotating kernel, as one dispatch; returns (sa_full, poisoned) with
    ``poisoned`` a device bool scalar (True = result untrustworthy, re-run
    a full-sort kernel).  Nothing is read back, so callers can queue more
    work before they test the flag."""
    return _rotating_jit(data_padded, jnp.asarray(n, jnp.int32))


def _int_doubling_kernel(vals_padded: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Doubling kernel over pre-offset int32 ranks (real = value+1, pad 0).

    Same padded-SA layout as ``_doubling_kernel``; starts at k=1 because the
    initial ranks cover only one symbol.
    """
    N = vals_padded.shape[0]
    rank, idx_s, num_ranks = _doubling_round(vals_padded, jnp.int32(1))

    def cond(state):
        k, _, _, num_ranks = state
        return jnp.logical_and(k < N, num_ranks < N)

    def body(state):
        k, rank, _, _ = state
        new_rank, idx_s, num_ranks = _doubling_round(rank, k)
        return k * 2, new_rank, idx_s, num_ranks

    _, _, sa_full, _ = lax.while_loop(
        cond, body, (jnp.int32(2), rank, idx_s, num_ranks)
    )
    return sa_full


_int_doubling_jit = jax.jit(_int_doubling_kernel, donate_argnums=(0,))


def _pad_len(n: int) -> int:
    """Static-shape bucket for a length-n array (bounds distinct jit traces).

    Power of two below 16 MiB; 16 MiB granularity above (sort cost scales
    with the padded length, so doubling a 300 MB chunk to 512 MB would be
    ~1.7x wasted work for one saved retrace).
    """
    step = 1 << 24
    if n >= step:
        return -(-n // step) * step
    p = 8
    while p < n:
        p *= 2
    return p


def suffix_array_jax(
    data: np.ndarray,
    *,
    device: typing.Optional[jax.Device] = None,
    algorithm: str = 'segmented',
) -> np.ndarray:
    """Build the SA on an XLA device and return it as host int32[n].

    The entire build is ONE device dispatch (``lax.while_loop`` with on-device
    early exit) and the only device->host transfer is the final SA readback.
    The loop body is sort-dominated, so the while_loop's per-iteration
    overhead is small next to it.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.int32)
    if algorithm not in ('segmented', 'full'):
        raise ValueError(f'unknown SA algorithm: {algorithm!r}')
    N = _pad_len(n)
    padded = np.zeros(N, dtype=np.uint8)
    padded[:n] = data
    x = jnp.asarray(padded) if device is None else jax.device_put(padded, device)
    kernel = _segmented_whole_jit if algorithm == 'segmented' else _doubling_whole_jit
    sa_full = kernel(x, jnp.int32(n))
    return np.asarray(sa_full[N - n:])


def suffix_array_device(data_padded: jnp.ndarray, n) -> jnp.ndarray:
    """Device-to-device variant for fused build pipelines (no host round trip).

    Returns the full padded-SA; real entries are ``out[N - n:]``.
    """
    return _doubling_kernel(data_padded, jnp.asarray(n, jnp.int32))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_JAX_MIN_N = 1 << 16  # below this, host numpy beats device dispatch overhead


def build_suffix_array(
    data: np.ndarray,
    backend: str = 'auto',
) -> np.ndarray:
    """Build the suffix array of ``data`` (uint8) with the chosen backend.

    ``auto`` is the native C++ SA-IS whenever it built on this machine.
    Without it, chunks of at least ``_JAX_MIN_N`` bytes build on an
    accelerator and everything else with the numpy doubling.  The device
    build stays an explicit choice (``'jax'``): a Writer that picked it
    by itself would open the accelerator in processes that only build.
    """
    data = np.asarray(data, dtype=np.uint8)
    if backend == 'numpy':
        return suffix_array_numpy(data)
    if backend == 'jax':
        return suffix_array_jax(data)
    if backend == 'native':
        from . import native

        return native.suffix_array_native(data)
    if backend != 'auto':
        raise ValueError(f'unknown suffix-array backend: {backend!r}')

    from . import native

    if native.available():
        return native.suffix_array_native(data)
    if data.size >= _JAX_MIN_N and jax.default_backend() != 'cpu':
        return suffix_array_jax(data)
    return suffix_array_numpy(data)
