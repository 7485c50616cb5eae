"""Sharded index build and search over a device mesh (shard_map + pjit).

Chunk-data-parallel SPMD programs:

- ``sharded_build_step``: every device builds the suffix arrays of its local
  corpus chunks (the vectorized prefix-doubling sort) — the analog of the
  reference's per-chunk libsais calls, but running on all chips at once.
- ``sharded_probe``: every device answers the (replicated) query batch
  against its local chunks; per-chunk hit ranges are all-gathered (NCCL) so
  every host sees the full [C, B, 2] result tensor — the analog of the
  reference's mutex-merged result vector (src/lib.rs:205-280), as a
  collective instead of a lock.

All functions take the stacked chunk-major layout of models/index.py:
``text [C, N_pad] uint8, n [C] int32, sa [C, N_pad] int32``.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from ..ops.search import probe_bounds_loop
from ..ops.suffix_array import _doubling_kernel
from .mesh import CHUNK_AXIS


def _build_one(text_row: jnp.ndarray, n_row: jnp.ndarray) -> jnp.ndarray:
    """Head-aligned SA of one padded chunk (real entries in [0, n)).

    Uses the plain (full-sort) doubling kernel, not the segmented one: this
    function is vmapped over the chunk axis, and under vmap a ``lax.cond``
    (the segmented kernel's overflow fallback) lowers to a select that
    executes BOTH branches — which would pay the full sort every round on
    top of the segmented work.  The Writer's per-chunk host loop (the real
    build path) does use the segmented kernel.
    """
    sa_full = _doubling_kernel(text_row, n_row)
    # _doubling_kernel yields real entries at the tail; rotate to the head.
    return jnp.roll(sa_full, n_row - text_row.shape[0])


build_chunks = jax.vmap(_build_one)  # [C, N_pad], [C] -> [C, N_pad]
# Loop-form probe (production compilation shape: one small while_loop
# program per geometry instead of a log2(N)-step unrolled binary search;
# see ops/search.py:probe_bounds_loop).
_probe_chunks = jax.vmap(probe_bounds_loop, in_axes=(0, 0, 0, None, None))


def make_sharded_build(mesh):
    """jitted [C, N_pad] build step, C sharded over the mesh."""
    from jax.sharding import PartitionSpec as P

    fn = jax.shard_map(
        build_chunks,
        mesh=mesh,
        in_specs=(P(CHUNK_AXIS), P(CHUNK_AXIS)),
        out_specs=P(CHUNK_AXIS),
    )
    return jax.jit(fn)


def make_sharded_probe(mesh, gather: bool = True):
    """jitted sharded probe: (text, n, sa, patterns, lengths) -> [C, B, 2].

    With ``gather=True`` the per-device partial results are all-gathered over
    the mesh (an NCCL collective), so the output is replicated on every
    device.
    """
    from jax.sharding import PartitionSpec as P

    def local(text, n, sa, patterns, lengths):
        lo, cnt = _probe_chunks(text, n, sa, patterns, lengths)
        out = jnp.stack([lo, cnt], axis=-1)  # [C_local, B, 2]
        if gather:
            out = jax.lax.all_gather(out, CHUNK_AXIS, axis=0, tiled=True)
        return out

    # check_vma=False for the gathered case: the all_gather output is
    # replicated in value, but the varying-axis type system cannot express
    # varying -> invarying, so replication is asserted rather than inferred.
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(CHUNK_AXIS), P(CHUNK_AXIS), P(CHUNK_AXIS), P(), P()),
        out_specs=P() if gather else P(CHUNK_AXIS),
        check_vma=not gather,
    )
    return jax.jit(fn)


def _from_next(x, D: int):
    """Device d receives device d+1's ``x`` (the last device gets zeros)."""
    if D == 1:
        return jnp.zeros_like(x)
    return jax.lax.ppermute(x, CHUNK_AXIS, [(j, j - 1) for j in range(1, D)])


def _from_prev(x, D: int):
    """Device d receives device d-1's ``x`` (device 0 gets zeros)."""
    if D == 1:
        return jnp.zeros_like(x)
    return jax.lax.ppermute(x, CHUNK_AXIS, [(j, j + 1) for j in range(D - 1)])


def _block_sort(ops, num_keys: int, D: int):
    """Sort the mesh-wide concatenation of per-device blocks (each [L]).

    Local sort, then D rounds of odd-even transposition: each neighbour
    pair swaps blocks over ``ppermute``, sorts the 2L union and keeps its
    half (a merge-split; D such rounds sort any D sorted blocks).  Every
    block keeps its size, so no exchange needs a capacity.  The keys must
    order the elements totally: both partners sort the same union and must
    agree on where it splits.
    """
    L = ops[0].shape[0]
    d = jax.lax.axis_index(CHUNK_AXIS)
    ops = jax.lax.sort(ops, num_keys=num_keys, is_stable=False)
    for r in range(D):
        lows = list(range(r % 2, D - 1, 2))
        if not lows:
            continue
        perm = [(j, j + 1) for j in lows] + [(j + 1, j) for j in lows]
        theirs = [jax.lax.ppermute(x, CHUNK_AXIS, perm) for x in ops]
        both = jax.lax.sort(
            tuple(jnp.concatenate([a, b]) for a, b in zip(ops, theirs)),
            num_keys=num_keys, is_stable=False,
        )
        low = jnp.isin(d, jnp.array(lows))
        high = jnp.isin(d, jnp.array(lows) + 1)
        ops = tuple(
            jnp.where(low, u[:L], jnp.where(high, u[L:], x))
            for u, x in zip(both, ops)
        )
    return ops


def _dense_ranks(k1, k2, D: int):
    """Dense group ranks of mesh-sorted keys: (rank per element, number of
    distinct (k1, k2) pairs), as in ops.suffix_array._doubling_round."""
    L = k1.shape[0]
    d = jax.lax.axis_index(CHUNK_AXIS)
    iota = jnp.arange(L, dtype=jnp.int32)
    p1 = jnp.concatenate([_from_prev(k1[-1:], D), k1[:-1]])
    p2 = jnp.concatenate([_from_prev(k2[-1:], D), k2[:-1]])
    changed = jnp.logical_or(k1 != p1, k2 != p2)
    flags = jnp.where((d == 0) & (iota == 0), 0, changed.astype(jnp.int32))
    local = jnp.cumsum(flags, dtype=jnp.int32)
    totals = jax.lax.all_gather(local[-1], CHUNK_AXIS)  # [D]
    offset = jnp.sum(jnp.where(jnp.arange(D) < d, totals, 0))
    return local + offset, jnp.sum(totals) + 1


def _shifted_ranks(rank, k, D: int):
    """rank[i + k] for this device's positions i (-1 past the end).

    The wanted window spans blocks d+q and d+q+1 (q = k // L); a ring of
    D-1 ``ppermute`` steps passes every block by, and the two wanted ones
    are kept.  Each device holds at most four blocks at a time.
    """
    L = rank.shape[0]
    d = jax.lax.axis_index(CHUNK_AXIS)
    q, rem = k // L, k % L
    none = jnp.full_like(rank, -1)
    first, second, cur = none, none, rank
    for s in range(D):
        if s:
            cur = jax.lax.ppermute(
                cur, CHUNK_AXIS, [(j, (j - 1) % D) for j in range(D)]
            )
        blk = jnp.where(d + s < D, cur, none)
        first = jnp.where(q == s, blk, first)
        second = jnp.where(q + 1 == s, blk, second)
    return jax.lax.dynamic_slice(jnp.concatenate([first, second]), (rem,), (L,))


def _giant_kernel(text, n, D: int):
    """Per-device body of :func:`make_giant_chunk_build`: the prefix
    doubling of ops.suffix_array._doubling_kernel on a [N/D] text block.

    Each round sorts (rank[i], rank[i+k], i) across the mesh, relabels, and
    sorts (i, new rank) back into position order, so ranks stay split by
    position and the sorted positions by slot.
    """
    L = text.shape[0]
    N = L * D
    d = jax.lax.axis_index(CHUNK_AXIS)
    pos = d * L + jnp.arange(L, dtype=jnp.int32)
    # 6-byte initial ordering (ops.suffix_array._init_round): the next
    # block's first bytes complete this block's last windows.
    ext = jnp.concatenate([text, _from_next(text[:8], D)]).astype(jnp.int32)
    gext = d * L + jnp.arange(L + 8, dtype=jnp.int32)
    v = jnp.where(gext < n, ext + 1, 0)

    def s(j):
        return v[j: j + L]

    limb0 = (s(0) * 257 + s(1)) * 257 + s(2)
    limb1 = (s(3) * 257 + s(4)) * 257 + s(5)

    def relabel(k1, k2):
        k1, k2, sa = _block_sort((k1, k2, pos), 3, D)
        rank_s, num = _dense_ranks(k1, k2, D)
        _, rank = _block_sort((sa, rank_s), 1, D)
        return rank, sa, num

    rank, sa, num = relabel(limb0, limb1)

    def cond(state):
        k, _, _, num = state
        return jnp.logical_and(k < N, num < N)

    def body(state):
        k, rank, _, _ = state
        rank, sa, num = relabel(rank, _shifted_ranks(rank, k, D))
        return k * 2, rank, sa, num

    _, _, sa, _ = jax.lax.while_loop(cond, body, (jnp.int32(6), rank, sa, num))
    return sa


def make_giant_chunk_build(mesh):
    """SA build of ONE chunk split across every device of the mesh.

    The intra-chunk analog of sequence parallelism (SURVEY.md §5.7): the
    text [N_pad] is split into one block per device, and every array of the
    build stays split — each device holds O(N/D) of it, none the whole.  The
    sorts are distributed block sorts (``_block_sort``: local sort plus
    merge-splits between neighbours over ``ppermute``), and the
    ``rank[i + k]`` fetch is a ring of block passes.  Use when one chunk's
    build working set (~12 bytes/char transient) exceeds one device's
    memory; it does more sorting than a one-device build.

    Returns a jitted ``(text_padded [N], n) -> sa_full [N]`` with sharded
    input/output; ``N`` must be a multiple of the mesh size, with at least 8
    entries per device.  Callers slice ``[N-n:]`` for the real entries
    (same contract as ops.suffix_array._doubling_kernel).
    """
    from functools import partial

    from jax.sharding import PartitionSpec as P

    D = mesh.devices.size
    fn = jax.shard_map(
        partial(_giant_kernel, D=D),
        mesh=mesh,
        in_specs=(P(CHUNK_AXIS), P()),
        out_specs=P(CHUNK_AXIS),
        check_vma=False,  # loop carries mix per-device and agreed values
    )
    return jax.jit(fn)


def make_full_step(mesh):
    """The framework's "training step": build SAs for all sharded chunks and
    immediately answer a query batch, with hit counts psum-reduced across the
    mesh — exercises compute + collectives in one compiled program.  Used by
    the multi-chip dry-run and as the end-to-end unit of the build+search
    pipeline."""
    from jax.sharding import PartitionSpec as P

    def local(text, n, patterns, lengths):
        sa = build_chunks(text, n)
        lo, cnt = _probe_chunks(text, n, sa, patterns, lengths)
        bounds = jax.lax.all_gather(
            jnp.stack([lo, cnt], axis=-1), CHUNK_AXIS, axis=0, tiled=True
        )
        total_hits = jax.lax.psum(jnp.sum(cnt, axis=0), CHUNK_AXIS)  # [B]
        return bounds, total_hits

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(CHUNK_AXIS), P(CHUNK_AXIS), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,  # outputs replicated by all_gather/psum (see above)
    )
    return jax.jit(fn)
