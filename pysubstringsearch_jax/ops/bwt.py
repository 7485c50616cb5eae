"""Burrows–Wheeler transform and inverse.

Capability parity with the BWT surface of the reference's native kernel
(`libsais_bwt`, reference src/libsais/libsais.c:6642-6665, and
`libsais_unbwt`, libsais.c:7551-7638) — unreachable from the reference
*product* (its Rust wrapper only ever calls `libsais()`, src/lib.rs:30-36)
but part of the kernel's public API (libsais.h:38-304), so the framework
ships an equivalent.

Semantics (identical to libsais):

- ``bwt(T) -> (U, p)`` where, with ``SA`` the suffix array of ``T`` and
  ``i0`` the slot with ``SA[i0] == 0``: ``U[0] = T[n-1]``; the remaining
  ``n-1`` entries are ``T[SA[i]-1]`` in SA order with slot ``i0`` omitted;
  ``p = i0 + 1`` is the primary index (libsais.c:6655-6660).
- ``unbwt(U, p) -> T`` inverts it.

The forward transform is a handful of vectorized gathers over the SA — it
runs on device (`bwt_from_sa_device`) or host.  The inverse is an
inherently sequential LF-mapping walk (one pointer chase per output byte,
libsais.c:7245-7504); it runs on the host — C++ (native/sais.cpp) when
available, numpy otherwise.  A device inverse would need permutation
doubling (O(n log n) gathers) for no product benefit.
"""

from __future__ import annotations

import typing

import jax.numpy as jnp
import numpy as np

from .suffix_array import build_suffix_array

__all__ = [
    'bwt',
    'unbwt',
    'bwt_aux',
    'unbwt_aux',
    'bwt_from_sa',
    'bwt_from_sa_device',
    'byte_frequencies',
]


def byte_frequencies(data: np.ndarray) -> np.ndarray:
    """int32[256] symbol histogram — the ``freq`` output every libsais entry
    point optionally fills (reference src/libsais/libsais.h:46-49)."""
    data = np.asarray(data, dtype=np.uint8)
    return np.bincount(data, minlength=256).astype(np.int32)


def bwt_from_sa(data: np.ndarray, suffix_array: np.ndarray) -> typing.Tuple[np.ndarray, int]:
    """(U, primary_index) from text and its suffix array (host numpy)."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.uint8), 0
    if n == 1:
        # libsais.c:6649-6651: U[0] = T[0], return n.
        return data.copy(), 1
    sa = np.asarray(suffix_array, dtype=np.int64)
    i0 = int(np.nonzero(sa == 0)[0][0])
    vals = data[(sa - 1) % n]  # garbage at i0, dropped below
    u = np.empty(n, dtype=np.uint8)
    u[0] = data[n - 1]
    u[1 : i0 + 1] = vals[:i0]
    u[i0 + 1 :] = vals[i0 + 1 :]
    return u, i0 + 1


def bwt_from_sa_device(text: jnp.ndarray, sa: jnp.ndarray):
    """Device BWT: (uint8[n] U, int32 primary_index) from device (text, SA).

    Pure gathers + a vectorized shift — jittable, runs where the SA already
    lives after a device build (no host round trip of the 4x larger SA).
    """
    n = text.shape[0]
    i0 = jnp.argmin(sa)  # SA is a permutation of [0, n): argmin finds slot of 0
    vals = jnp.take(text, (sa - 1) % n, axis=0)
    iota = jnp.arange(n, dtype=jnp.int32)
    # U[i] = T[n-1] at i=0; vals[i-1] for 1 <= i <= i0; vals[i] for i > i0.
    shifted = jnp.take(vals, jnp.where(iota <= i0, iota - 1, iota) % n, axis=0)
    u = jnp.where(iota == 0, text[n - 1], shifted).astype(jnp.uint8)
    return u, (i0 + 1).astype(jnp.int32)


def bwt(data: np.ndarray, backend: str = 'auto') -> typing.Tuple[np.ndarray, int]:
    """BWT of ``data``; the SA is built with the chosen backend."""
    data = np.asarray(data, dtype=np.uint8)
    if data.size <= 1:
        return bwt_from_sa(data, np.empty(data.size, dtype=np.int32))
    return bwt_from_sa(data, build_suffix_array(data, backend=backend))


def bwt_aux(
    data: np.ndarray, r: int, backend: str = 'auto'
) -> typing.Tuple[np.ndarray, np.ndarray]:
    """BWT with sampled auxiliary indexes — ``libsais_bwt_aux`` parity
    (reference src/libsais/libsais.c:6667-6691).

    Returns ``(U, I)`` where ``U`` is the same transform as :func:`bwt` and
    ``I[j] = 1 + (SA slot of the suffix starting at position j*r)`` for
    ``j = 0 .. (n-1)//r`` (the reference records exactly these during its
    final induction sweeps, libsais.c:4555-4561, 5181-5190; ``I[0]`` is the
    primary index).  ``r`` must be a power of two >= 2 (libsais.c:6669).

    The point of the samples is a *parallel* inverse: each ``I[j]`` seeds an
    independent LF walk covering ``r`` output bytes (see :func:`unbwt_aux`) —
    the reference uses them for its OpenMP unbwt; here they make the inverse
    a vectorized multi-lane walk.
    """
    if r < 2 or (r & (r - 1)) != 0:
        raise ValueError('r must be a power of two >= 2')
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n <= 1:
        return data.copy(), np.array([n], dtype=np.int32)
    sa = build_suffix_array(data, backend=backend)
    u, _ = bwt_from_sa(data, sa)
    # slot_of[p] = SA slot holding text position p (inverse permutation).
    sampled = np.arange(0, n, r, dtype=np.int64)
    slot_of = np.empty(n, dtype=np.int64)
    slot_of[sa.astype(np.int64)] = np.arange(n, dtype=np.int64)
    return u, (slot_of[sampled] + 1).astype(np.int32)


def unbwt_aux(u: np.ndarray, r: int, I: np.ndarray) -> np.ndarray:
    """Inverse BWT from sampled indexes — ``libsais_unbwt_aux`` parity
    (reference src/libsais/libsais.c:7571-7587).

    The samples split the output into ``ceil(n/r)`` blocks, each recovered by
    an independent LF walk of at most ``r`` steps; the walks advance together
    as numpy lanes (the data-parallel analog of the reference's OpenMP
    per-block unbwt, libsais.c:7245-7504).  ``r == n`` with a single index
    degenerates to the plain :func:`unbwt` (libsais.c:7561-7564).
    """
    u = np.asarray(u, dtype=np.uint8)
    n = u.size
    I = np.asarray(I, dtype=np.int64)
    if r != n and (r < 2 or (r & (r - 1)) != 0):
        raise ValueError('r must be a power of two >= 2 (or r == n)')
    if n <= 1:
        if I.size == 0 or I[0] != n:
            raise ValueError('inconsistent auxiliary indexes')
        return u.copy()
    nb_idx = (n - 1) // r + 1
    if I.size < nb_idx:
        raise ValueError('not enough auxiliary indexes')
    if np.any(I[:nb_idx] <= 0) or np.any(I[:nb_idx] > n):
        raise ValueError('auxiliary index out of range')
    primary_index = int(I[0])
    lf = _lf_mapping(u)
    # Block j emits out[(j+1)*r - 1 .. j*r] (clipped to n) walking backward
    # from the rotation row of the suffix starting at its end boundary:
    # row I[j+1] for interior blocks, row 0 (the sentinel row '$T...') for
    # the block ending at n.
    nb = nb_idx
    ends = np.minimum((np.arange(nb, dtype=np.int64) + 1) * r, n)
    p = np.zeros(nb, dtype=np.int64)
    interior = ends < n
    p[interior] = I[(ends[interior] // r)]
    sizes = ends - np.arange(nb, dtype=np.int64) * r
    out = np.empty(n, dtype=np.uint8)
    max_steps = int(sizes.max())
    active_lanes = np.arange(nb, dtype=np.int64)
    for s in range(max_steps):
        mask = s < sizes
        lanes = active_lanes[mask]
        m = p[lanes]
        m = np.where(m < primary_index, m, m - 1)
        out[ends[lanes] - 1 - s] = u[m]
        p[lanes] = lf[m]
    return out


def _lf_mapping(u: np.ndarray) -> np.ndarray:
    """LF map over U-indices (sentinel row excluded); see _unbwt_numpy."""
    counts = np.bincount(u, minlength=256).astype(np.int64)
    starts = np.zeros(256, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    starts += 1
    return starts[u] + _stable_rank(u)


def _unbwt_numpy(u: np.ndarray, primary_index: int) -> np.ndarray:
    """LF-mapping inverse (numpy): counting phase vectorized, walk sequential.

    Derivation: libsais' U is the rotation-BWT column ``W`` of ``T + '$'``
    (``$`` the unique smallest sentinel) with the ``$`` entry at row
    ``primary_index`` removed.  For byte rows, ``LF(j) = C[W[j]] +
    occ(W[j], j)`` with ``C[c] = 1 + #{bytes < c in U}`` (the 1 is the
    sentinel, which owns first-column row 0).  Rotation row 0 is ``$T...``
    whose BWT char is ``T[n-1]``; walking LF from row 0 therefore emits T
    back-to-front in n steps.  ``m(j)`` maps W-row to U-index by skipping
    the removed sentinel slot.
    """
    n = u.size
    counts = np.bincount(u, minlength=256).astype(np.int64)
    starts = np.zeros(256, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    starts += 1
    lf = starts[u] + _stable_rank(u)
    out = np.empty(n, dtype=np.uint8)
    p = 0
    for i in range(n - 1, -1, -1):
        m = p if p < primary_index else p - 1
        out[i] = u[m]
        p = int(lf[m])
    return out


def _stable_rank(u: np.ndarray) -> np.ndarray:
    """rank[i] = number of j < i with u[j] == u[i] (vectorized)."""
    order = np.argsort(u, kind='stable')
    ranks_sorted = np.arange(u.size, dtype=np.int64)
    sym_sorted = u[order]
    firsts = np.zeros(u.size, dtype=np.int64)
    change = np.empty(u.size, dtype=bool)
    if u.size:
        change[0] = True
        change[1:] = sym_sorted[1:] != sym_sorted[:-1]
        firsts = np.maximum.accumulate(np.where(change, ranks_sorted, 0))
    rank = np.empty(u.size, dtype=np.int64)
    rank[order] = ranks_sorted - firsts
    return rank


def unbwt(u: np.ndarray, primary_index: int) -> np.ndarray:
    """Inverse BWT; prefers the native C++ walk, falls back to numpy."""
    u = np.asarray(u, dtype=np.uint8)
    n = u.size
    if n == 0:
        return u.copy()
    if n == 1:
        return u.copy()
    if not 1 <= primary_index <= n:
        raise ValueError('primary index out of range')
    from . import native

    if native.available():
        return native.unbwt_native(u, primary_index)
    return _unbwt_numpy(u, primary_index)
