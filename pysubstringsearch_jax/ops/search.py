"""Batched substring probe: vectorized lower/upper-bound search over the SA.

The reference answers one pattern at a time with a scalar binary search whose
every probe is a file seek (reference: src/lib.rs:212-252), and its
``search_multiple`` is a sequential Python loop (pysubstringsearch/__init__.py:61-73).
Here the whole query batch is a first-class axis: patterns are packed into a
``[B, L]`` uint8 tensor and *both* bounds for *all* patterns advance together
through one loop — each step is one batched suffix-window gather plus a
vectorized lexicographic compare.

Semantics match the reference byte compare exactly:

- ``lower`` = first SA slot whose suffix is >= the pattern, where a suffix
  that *starts with* the pattern compares equal (src/lib.rs:219-220).
- ``upper`` = first SA slot whose suffix is > the pattern and does not start
  with it.  ``count = upper - lower`` is the number of matching suffixes.

Shaping decisions:

- The two searches fuse: classify each (pattern, suffix) pair with a three-way
  compare ``cmp ∈ {-1, 0, +1}`` (0 = pattern is a prefix); ``lower`` is the
  first slot with ``cmp >= 0`` and ``upper`` the first with ``cmp >= 1`` —
  one predicate parameterized by a threshold, so both bounds run as a single
  ``[2B]`` search.
- The production path is :func:`probe_bounds_phased` — see the phased
  raw-limb section below for its cost model and design (one int32 gather
  per lane per step, alphabet-ranked deep seed tables).
- Chunks containing NUL bytes fall back to :func:`probe_bounds_limbs_loop`,
  the base-258 digit-limb bisection whose 0-digit encodes past-end exactly.
- :func:`probe_bounds` is the plain byte-window bisection — the executable
  oracle for both, and the deep-refinement engine for patterns longer than
  the packed key coverage.
"""

from __future__ import annotations

import functools
import threading
import typing
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    'pack_patterns',
    'probe_bounds',
    'probe_bounds_phased',
    'build_bucket_table',
    'build_seed_table_host',
    'gather_hit_positions',
    'BUCKET_TABLE_SIZE',
    'PAD_MARGIN',
    'RAW_LIMBS',
]

#: Digit space for byte ranks: real byte b -> b + 1, past-the-end -> 0, and
#: 257 as the +infinity digit used by upper-bound targets.
_RADIX = 258

#: Bucket table: one entry per 2-digit prefix value plus a terminator.
BUCKET_TABLE_SIZE = _RADIX * _RADIX + 1

#: Deep bucket table: one entry per 3-digit prefix (69 MB as int32).  Worth
#: it for large chunks: ~8 fewer bisection steps for one extra lookup, and
#: the table is small next to the packed limb keys (4n*num_limbs bytes).
BUCKET_TABLE_SIZE_3 = _RADIX * _RADIX * _RADIX + 1


def _bucket_depth(table_len: int) -> int:
    """Bucket-prefix depth encoded by a table's (static) length."""
    if table_len == BUCKET_TABLE_SIZE:
        return 2
    if table_len == BUCKET_TABLE_SIZE_3:
        return 3
    raise ValueError(f'not a bucket table length: {table_len}')


#: (base, depth) combinations a ranked seed table may use.  Alphabet-ranked
#: bases are powers of two so every combination's table length is unique —
#: the static table shape alone identifies the parameters at trace time.
_TABLE_COMBOS = tuple(
    (base, d)
    for base in (32, 64, 128, _RADIX)
    for d in (2, 3, 4, 5)
    if base ** d <= 1 << 28
)


def table_params(table_len: int):
    """(base, depth) encoded by a seed table's static length."""
    for base, d in _TABLE_COMBOS:
        if base ** d + 1 == table_len:
            return base, d
    raise ValueError(f'not a seed table length: {table_len}')


def pick_table_params(sigma: int, max_n: int):
    """Choose the ranked seed table's (base, depth) for an alphabet of
    ``sigma`` distinct bytes and chunks of at most ``max_n`` chars.

    Base: the smallest power-of-two holding every rank plus the two pad
    digits (0 = past-end/-inf, base-1 = +inf); full-byte alphabets fall back
    to the 258 digit base.  Depth: as deep as fits both a hard entry cap and
    the chunk size (a table bigger than the chunk costs more to build than
    the bisection steps it saves).  A deeper seed removes ~log2(sigma) probe
    iterations per extra byte — the cheapest steps this workload can buy.
    """
    base = next((b for b in (32, 64, 128) if sigma + 2 <= b), _RADIX)
    cap = min(48 << 20, max(base ** 2, max_n))
    depth = max(d for b, d in _TABLE_COMBOS if b == base and b ** d <= cap)
    return base, depth

#: Limbs per suffix in the packed prefix-key array: each limb holds 3 bytes
#: in base-258 digits (b+1; 0 = past-end), so the bucket (2 bytes) plus
#: KEY_LIMBS limbs cover the first ``2 + 3*KEY_LIMBS`` bytes of every suffix.
KEY_LIMBS = 5


def key_cover_bytes(num_limbs: int = KEY_LIMBS) -> int:
    return 2 + 3 * num_limbs

#: Zero-byte margin device text arrays carry after position n, so suffix
#: windows up to this long never clamp. Longer patterns stay correct via the
#: clamp+roll path, and patterns longer than the whole padded array cannot
#: match anything (handled by callers).
PAD_MARGIN = 1024


def pack_patterns(patterns, max_len: int | None = None):
    """Pack byte-string patterns into (uint8[B, L], int32[B]) host arrays.

    ``L`` is rounded up to the next limb-aligned boundary (8, 11, 14, 17 =
    ``key_cover_bytes(k)``, then multiples of 8) — this bounds jit retraces
    across pattern-length distributions while keeping the probe's static
    per-step gather width (``k_used = ceil((L-2)/3)`` limbs) as small as the
    batch allows.  An explicit ``max_len`` is used literally.
    """
    lengths = np.array([len(p) for p in patterns], dtype=np.int32)
    if max_len is None:
        L = int(lengths.max(initial=0))
        if L <= key_cover_bytes(KEY_LIMBS):
            L = next(
                w for w in (8, 11, 14, 17) if w >= max(8, L)
            )
        else:
            L = -(-L // 8) * 8
    else:
        L = max_len
    packed = np.zeros((len(patterns), L), dtype=np.uint8)
    for i, p in enumerate(patterns):
        packed[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    return packed, lengths


def _gather_suffix_windows(text, starts, L):
    """[B, L] windows text[starts[b] : starts[b]+L] as one element gather.

    Windows are fetched as ONE flat [B*L] element gather rather than B
    ``lax.dynamic_slice`` rows (the flat form won on the original target;
    not re-measured on a GPU yet — ROADMAP).

    The clip keeps accesses in-bounds; positions past the true text length
    are masked to rank 0 by the caller (via ``pos < n``), so clamped reads
    never influence results.
    """
    N = text.shape[0]
    B = starts.shape[0]
    pos = starts[:, None] + lax.broadcasted_iota(jnp.int32, (B, L), 1)
    flat = jnp.take(text, jnp.clip(pos.reshape(-1), 0, N - 1), axis=0)
    return flat.reshape(B, L)


def _cmp3(text, n, sa, slots, patterns_p1, lengths):
    """Three-way compare of each pattern against the suffix at SA[slot].

    text:        uint8 [N_pad] — chunk text (only [:n] is real; N_pad >= L)
    n:           int32 scalar  — true text length
    sa:          int32 [N_pad] — suffix array (real entries in [0, n))
    slots:       int32 [B]     — SA slot per query
    patterns_p1: int32 [B, L]  — pattern bytes + 1 (0 past the length)
    lengths:     int32 [B]

    Returns int32 [B]: -1 suffix < pattern, 0 pattern is a prefix, +1 greater.
    """
    B, L = patterns_p1.shape
    starts = jnp.take(sa, jnp.clip(slots, 0, jnp.maximum(n - 1, 0)), axis=0)
    rows = _gather_suffix_windows(text, starts, L)
    jpos = lax.broadcasted_iota(jnp.int32, (B, L), 1)
    pos = starts[:, None] + jpos
    # Rank scheme matching suffix_array.py: real byte -> b+1, past-end -> 0.
    s = jnp.where(pos < n, rows.astype(jnp.int32) + 1, 0)
    jmask = jpos < lengths[:, None]
    # Lexicographic compare without any minor-axis gather: the "value at
    # first differing byte" is selected with a min-reduce + one-hot sum
    # instead of a take_along_axis along the byte axis (elementwise work).
    d = jnp.sign(s - patterns_p1) * jmask.astype(jnp.int32)  # {-1, 0, +1}
    nz = d != 0
    firstj = jnp.min(jnp.where(nz, jpos, L), axis=1)  # [B]; L = no difference
    onehot = jnp.logical_and(jpos == firstj[:, None], nz)
    return jnp.sum(d * onehot, axis=1).astype(jnp.int32)


def _bisect_first_geq(text, n, sa, patterns_p1, lengths, thresholds, lo0, hi0,
                      steps: int):
    """First SA slot in [lo0, hi0) where cmp3 >= threshold (branchless).

    ``steps`` is STATIC and the loop is unrolled into straight-line XLA
    (the oracle form; production probes use the ``while_loop`` twins).
    """
    lo, hi = lo0, hi0
    for _ in range(steps):
        mid = (lo + hi) // 2
        cmp = _cmp3(text, n, sa, mid, patterns_p1, lengths)
        pred = cmp >= thresholds
        active = lo < hi
        hi = jnp.where(jnp.logical_and(active, pred), mid, hi)
        lo = jnp.where(jnp.logical_and(active, ~pred), mid + 1, lo)
    return lo


def _duplex(patterns, lengths):
    """Stack the query batch twice — lanes [0, B) search the lower bound
    (threshold 0), lanes [B, 2B) the upper (threshold 1)."""
    p1 = patterns.astype(jnp.int32) + 1
    jmask = lax.broadcasted_iota(jnp.int32, p1.shape, 1) < lengths[:, None]
    p1 = jnp.where(jmask, p1, 0)
    B = p1.shape[0]
    both = jnp.concatenate([p1, p1], axis=0)
    both_len = jnp.concatenate([lengths, lengths], axis=0)
    thresholds = jnp.concatenate(
        [jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.int32)], axis=0
    )
    return both, both_len, thresholds


def probe_bounds(text, n, sa, patterns, lengths):
    """(lower, count) int32 [B] for each pattern against one chunk.

    Jittable; all shapes static.  ``patterns`` is uint8 [B, L] (zero padded),
    ``lengths`` int32 [B].  Works for empty patterns (count = n) and empty
    chunks (count = 0).  Requires ``text.shape[0] >= L``.
    """
    n = jnp.asarray(n, jnp.int32)
    both, both_len, thresholds = _duplex(patterns, lengths)
    B = patterns.shape[0]
    lo0 = jnp.zeros((2 * B,), jnp.int32) + n * 0  # varying-ness follows n
    hi0 = jnp.full((2 * B,), 1, jnp.int32) * n
    steps = max(1, int(np.ceil(np.log2(max(2, int(text.shape[0])))))) + 1
    bounds = _bisect_first_geq(
        text, n, sa, both, both_len, thresholds, lo0, hi0, steps
    )
    lower = bounds[:B]
    return lower, bounds[B:] - lower


def probe_bounds_loop(text, n, sa, patterns, lengths):
    """Loop-form twin of :func:`probe_bounds`: the bisection runs inside a
    ``lax.while_loop`` with on-device convergence instead of log2(N)+1
    unrolled steps.  Same math, different compilation shape — one small
    program regardless of chunk size, where the unrolled form emits a
    ~29-step straight-line program at real chunk sizes.  This is the
    production shape for the sharded kernels (parallel/sharded.py),
    matching the single-device phased path's choice (see
    probe_bounds_limbs_loop)."""
    n = jnp.asarray(n, jnp.int32)
    both, both_len, thresholds = _duplex(patterns, lengths)
    B = patterns.shape[0]
    lo0 = jnp.zeros((2 * B,), jnp.int32) + n * 0
    hi0 = jnp.full((2 * B,), 1, jnp.int32) * n

    def cond(state):
        lo, hi = state
        return jnp.any(lo < hi)

    def body(state):
        lo, hi = state
        mid = (lo + hi) // 2
        cmp = _cmp3(text, n, sa, mid, both, both_len)
        pred = cmp >= thresholds
        active = lo < hi
        hi = jnp.where(jnp.logical_and(active, pred), mid, hi)
        lo = jnp.where(jnp.logical_and(active, ~pred), mid + 1, lo)
        return lo, hi

    lo, _ = lax.while_loop(cond, body, (lo0, hi0))
    lower = lo[:B]
    return lower, lo[B:] - lower


def build_bucket_table(text, n, sa, depth: int = 2):
    """int32 bucket table: table[k] = first SA slot whose suffix's
    ``depth``-digit prefix value is >= k (digits in the b+1 rank space).

    The device-side analogue of SA-IS bucket pointers: seeds every probe's
    bisection at its prefix bucket, replacing ~8*depth binary-search steps
    with two table lookups.
    """
    N = text.shape[0]
    n = jnp.asarray(n, jnp.int32)
    slot_iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    starts = jnp.clip(sa, 0, jnp.maximum(N - depth, 0))
    rows = jax.vmap(lambda s: lax.dynamic_slice(text, (s,), (depth,)))(starts)
    b = jnp.zeros((N,), jnp.int32)
    for j in range(depth):
        dj = jnp.where(
            sa + j < n, rows[:, j].astype(jnp.int32) + 1, 0
        )
        b = b * _RADIX + dj
    # Padding slots (>= n) sort after every real prefix value.
    b = jnp.where(slot_iota < n, b, _RADIX ** depth)
    size = _RADIX ** depth + 1
    probes = lax.broadcasted_iota(jnp.int32, (size,), 0)
    return jnp.searchsorted(b, probes, side='left').astype(jnp.int32)


def _pattern_limb_targets(patterns, lengths, thresholds, num_limbs,
                          bucket_depth: int = 2):
    """Bucket ids and limb targets for duplex lanes.

    Lower-bound lanes (threshold 0) pad past-the-pattern digits with 0 (the
    -infinity digit), upper-bound lanes with 257 (+infinity): the first slot
    whose key-sequence compares >= the lower target is exactly the lower
    bound, and >= +1 the upper — no per-byte length masks needed.
    """
    B2, L = patterns.shape
    width = max(key_cover_bytes(num_limbs), bucket_depth)
    pad = jnp.where(thresholds > 0, _RADIX - 1, 0)  # [2B]
    cols = min(L, width)
    ipos = lax.broadcasted_iota(jnp.int32, (B2, width), 1)
    raw = jnp.zeros((B2, width), jnp.int32)
    raw = raw.at[:, :cols].set(patterns[:, :cols].astype(jnp.int32) + 1)
    digits = jnp.where(ipos < lengths[:, None], raw, pad[:, None])
    bucket = digits[:, 0]
    for j in range(1, bucket_depth):
        bucket = bucket * _RADIX + digits[:, j]
    tgt = jnp.stack(
        [
            (digits[:, 2 + 3 * j] * _RADIX + digits[:, 3 + 3 * j]) * _RADIX
            + digits[:, 4 + 3 * j]
            for j in range(num_limbs)
        ],
        axis=1,
    )  # [2B, K]
    return bucket, tgt


def _limb_cmp3(limbs_flat, slots, targets, stride, k_used):
    """Three-way compare of packed suffix keys at SA slots vs targets.

    ``limbs_flat`` is PLANE-MAJOR: ``stride`` planes of ``N`` elements each,
    limb j of slot i at ``j * N + i``.  (Slot-major `[N, stride]` would be
    the natural layout; plane-major was forced by the original target's
    tiling of a small minor dimension and awaits re-measurement on the GPU
    — ROADMAP.)  Only the first ``k_used`` limbs are gathered and compared —
    enough whenever the target digits beyond them are all pads (see
    probe_bounds_limbs), which cuts the dominant per-step gather volume for
    short patterns.
    """
    B2 = slots.shape[0]
    K = k_used
    Nk = limbs_flat.shape[0]
    Ns = Nk // stride
    col = lax.broadcasted_iota(jnp.int32, (B2, K), 1)
    idx = col * Ns + slots[:, None]
    rows = jnp.take(
        limbs_flat, jnp.clip(idx.reshape(-1), 0, Nk - 1), axis=0
    ).reshape(B2, K)
    d = jnp.sign(rows - targets)
    nz = d != 0
    firstj = jnp.min(jnp.where(nz, col, K), axis=1)
    onehot = jnp.logical_and(col == firstj[:, None], nz)
    return jnp.sum(d * onehot, axis=1).astype(jnp.int32)


def probe_bounds_limbs_loop(text, n, sa, table, limbs_flat, patterns,
                            lengths, deep: bool = False,
                            num_limbs: int = KEY_LIMBS):
    """Loop-form production probe: bucket-seeded bisection over packed limb
    keys inside a ``lax.while_loop`` with on-device early exit.

    The unrolled form would specialize on the step count — every distinct
    bucket width would compile a fresh program.  The loop form is one small
    program for every width, converges in exactly the
    steps the widest seeded range needs (the while_loop exits when every
    lane's range is empty), and needs no width measurement at load time —
    the derive path can stay readback-free.

    ``deep`` (static) appends a second while_loop bisecting raw text windows
    inside the key-resolved range, for patterns longer than
    ``key_cover_bytes(num_limbs)``.
    """
    n = jnp.asarray(n, jnp.int32)
    both, both_len, thresholds = _duplex(patterns, lengths)
    B = patterns.shape[0]
    L = patterns.shape[1]
    k_used = max(1, min(num_limbs, -(-(L - 2) // 3)))
    bucket, tgt = _pattern_limb_targets(
        jnp.concatenate([patterns, patterns], axis=0).astype(jnp.uint8),
        both_len, thresholds, k_used,
        bucket_depth=_bucket_depth(table.shape[0]),
    )
    lo0 = jnp.take(table, bucket, axis=0)
    hi0 = jnp.take(table, bucket + 1, axis=0)

    def cond(state):
        lo, hi = state
        return jnp.any(lo < hi)

    def body(state):
        lo, hi = state
        mid = (lo + hi) // 2
        cmp = _limb_cmp3(limbs_flat, mid, tgt, num_limbs, k_used)
        pred = cmp >= thresholds
        active = lo < hi
        hi = jnp.where(jnp.logical_and(active, pred), mid, hi)
        lo = jnp.where(jnp.logical_and(active, ~pred), mid + 1, lo)
        return lo, hi

    lo, _ = lax.while_loop(cond, body, (lo0, hi0))
    if deep:
        l0 = jnp.concatenate([lo[:B], lo[:B]], axis=0)
        h0 = jnp.concatenate([lo[B:], lo[B:]], axis=0)

        def body2(state):
            lo, hi = state
            mid = (lo + hi) // 2
            cmp = _cmp3(text, n, sa, mid, both, both_len)
            pred = cmp >= thresholds
            active = lo < hi
            hi = jnp.where(jnp.logical_and(active, pred), mid, hi)
            lo = jnp.where(jnp.logical_and(active, ~pred), mid + 1, lo)
            return lo, hi

        lo, _ = lax.while_loop(cond, body2, (l0, h0))
    lower = lo[:B]
    return lower, lo[B:] - lower


@functools.lru_cache(maxsize=None)
def limbs_loop_batch_jit(deep: bool, num_limbs: int):
    """Jitted chunk-vmapped loop probe — one compiled program per
    (deep?, num_limbs), independent of corpus statistics."""

    def f(text, n, sa, table, limbs, patterns, lengths):
        return probe_bounds_limbs_loop(
            text, n, sa, table, limbs, patterns, lengths, deep, num_limbs
        )

    return jax.jit(jax.vmap(f, in_axes=(0, 0, 0, 0, 0, None, None)))


def build_limbs_host(
    data: np.ndarray, sa: np.ndarray, num_limbs: int = KEY_LIMBS
) -> np.ndarray:
    """[num_limbs, n] int32 packed prefix keys, plane-major (see _limb_cmp3).

    limb j of slot i packs bytes ``sa[i]+2+3j .. +3`` of the text as three
    base-258 digits (byte+1; 0 past the end).  Together with the 2-byte
    bucket id this gives each SA slot a ``key_cover_bytes()``-byte sortable
    prefix key, so probe bisection steps gather ``num_limbs`` int32 elements
    per lane instead of L text bytes — and need no per-byte length masks
    (the pad digits encode string end exactly).
    """
    n = data.size
    if n == 0:
        return np.zeros((num_limbs, 0), dtype=np.int32)
    # Digit stream in text order, padded so all windows are in-bounds.
    width = key_cover_bytes(num_limbs)
    digits = np.zeros(n + width, dtype=np.int32)
    digits[:n] = data.astype(np.int32) + 1
    out = np.empty((num_limbs, n), dtype=np.int32)
    base = sa.astype(np.int64) + 2
    for j in range(num_limbs):
        o = base + 3 * j
        out[j] = (
            (digits[o] * _RADIX + digits[o + 1]) * _RADIX + digits[o + 2]
        )
    return out


def pad_limbs_host(limbs: np.ndarray, n_pad: int) -> np.ndarray:
    """Place plane-major host limbs ``[num_limbs, n]`` into the flat padded
    device layout ``[num_limbs * n_pad]`` (plane j at ``j * n_pad``)."""
    num_limbs, n = limbs.shape
    out = np.zeros(num_limbs * n_pad, dtype=np.int32)
    for j in range(num_limbs):
        out[j * n_pad : j * n_pad + n] = limbs[j]
    return out


def build_bucket_table_host(
    data: np.ndarray, sa: np.ndarray, depth: int = 2
) -> np.ndarray:
    """Host (numpy) twin of build_bucket_table — used at index load (upload
    mode) so the load path is pure H2D with no device round trips before the
    first probe."""
    size = _RADIX ** depth + 1
    n = data.size
    if n == 0:
        return np.zeros(size, dtype=np.int32)
    b = np.zeros(n, dtype=np.int64)
    for j in range(depth):
        nxt = sa.astype(np.int64) + j
        dj = np.where(
            nxt < n, data[np.minimum(nxt, n - 1)].astype(np.int64) + 1, 0
        )
        b = b * _RADIX + dj  # non-decreasing over SA order
    probes = np.arange(size, dtype=np.int64)
    return np.searchsorted(b, probes, side='left').astype(np.int32)


def _digit_stream(text, n):
    """int32 [N] digit stream: text byte + 1 for positions < n, else 0."""
    N = text.shape[0]
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    return jnp.where(iota < n, text.astype(jnp.int32) + 1, 0), iota


def _shifted_digits(d, iota, n, j):
    """d shifted left by j with 0 (past-end digit) fill."""
    return jnp.where(iota + j < n, jnp.roll(d, -j), 0)


def build_limbs_device(text, n, sa, num_limbs: int = KEY_LIMBS):
    """Device twin of :func:`build_limbs_host`: packed prefix keys
    [N * num_limbs] int32 in SA-slot order, derived entirely on device.

    Limb streams are computed in TEXT order with rolled digit streams
    (elementwise passes over device memory), then permuted to SA order with
    one flat element gather per limb.

    PLANE-MAJOR output (limb j of slot i at ``j * N + i``, see _limb_cmp3):
    built with `concatenate`, never materializing an `[N, num_limbs]`
    array.
    """
    N = text.shape[0]
    n = jnp.asarray(n, jnp.int32)
    d, iota = _digit_stream(text, n)
    sa_c = jnp.clip(sa, 0, N - 1)
    cols = []
    for j in range(num_limbs):
        o = 2 + 3 * j
        lj = (
            _shifted_digits(d, iota, n, o) * _RADIX
            + _shifted_digits(d, iota, n, o + 1)
        ) * _RADIX + _shifted_digits(d, iota, n, o + 2)
        cols.append(jnp.take(lj, sa_c, axis=0))
    return jnp.concatenate(cols)


def build_bucket_table_device(text, n, sa, depth: int = 2):
    """Device twin of :func:`build_bucket_table_host` via scatter-min.

    ``table[k] = first SA slot whose depth-digit prefix value >= k``.  The
    prefix-value stream is computed in text order, gathered to SA order
    (non-decreasing), scatter-min'd into a first-slot-per-value table, and
    completed with a reverse cummin — one N-element scatter instead of a
    size-17M searchsorted bisection.
    """
    N = text.shape[0]
    n = jnp.asarray(n, jnp.int32)
    d, iota = _digit_stream(text, n)
    pv = jnp.zeros((N,), jnp.int32)
    for j in range(depth):
        pv = pv * _RADIX + _shifted_digits(d, iota, n, j)
    b = jnp.take(pv, jnp.clip(sa, 0, N - 1), axis=0)
    size = _RADIX ** depth + 1
    # Padding slots (>= n) get the terminator value so they never claim a
    # real bucket's first slot.
    b = jnp.where(iota < n, b, size - 1)
    first = jnp.full((size,), N, jnp.int32).at[b].min(iota, mode='drop')
    # table[k] = min over k' >= k of first[k']; clamp the N sentinel to n.
    table = lax.cummin(first, reverse=True)
    return jnp.minimum(table, n)


#: Largest padded row the segmented doubler derives; longer rows take the
#: rotating doubler (see :func:`derive_sa`).
SEGMENTED_MAX_PAD = 3 << 27


def derive_kernel(n_pad: int) -> str:
    """Name of the SA kernel :func:`derive_sa` runs for a padded row."""
    return 'segmented' if n_pad <= SEGMENTED_MAX_PAD else 'rotating'


def derive_sa(text, n, brank=None, bits=None):
    """text row -> (SA rolled to the front, poisoned host bool).

    Real SA entries land in slots [0, n); the tail holds pad-suffix
    positions >= n which no probe range can reach (bucket tables clamp to
    n).  Two kernels by row size:

    - up to 384 Mi padded: the segmented tie-only doubler
      (ops/suffix_array.py:_segmented_kernel) as ONE dispatch (its
      full-sort fallback branch reserves ~24 bytes/char).  With a
      ranked alphabet (``brank``/``bits`` from the index geometry), the
      init covers 2 * (30 // bits) characters instead of 6 in the same
      one sort, dropping a doubling round (the text must carry the
      derive path's PAD_MARGIN past ``n``).
    - larger rows: the rotating windowed doubler (segmented_rotating_sa),
      also one dispatch, which never sorts more than N/8 elements at once;
      adversarial inputs set ``poisoned`` (then a device scalar) and the
      caller re-runs :func:`derive_sa_full_jit`.
    """
    N = text.shape[0]
    if derive_kernel(N) == 'segmented':
        if brank is not None and bits is not None:
            return (
                _derive_sa_seg_ranked_jit(bits)(
                    text, jnp.asarray(n, jnp.int32), brank
                ),
                False,
            )
        return _derive_sa_seg_jit()(text, jnp.asarray(n, jnp.int32)), False
    from .suffix_array import segmented_rotating_sa

    sa_full, poisoned = segmented_rotating_sa(text, n)
    return _roll_front_jit()(sa_full, jnp.asarray(n, jnp.int32)), poisoned


@functools.lru_cache(maxsize=None)
def _derive_sa_seg_jit():
    from .suffix_array import _segmented_kernel

    def f(text, n):
        N = text.shape[0]
        return jnp.roll(_segmented_kernel(text, n), n - N)

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _derive_sa_seg_ranked_jit(bits: int):
    from .suffix_array import _segmented_kernel_ranked

    def f(text, n, brank):
        N = text.shape[0]
        return jnp.roll(
            _segmented_kernel_ranked(text, n, brank, bits), n - N
        )

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _roll_front_jit():
    def f(sa_full, n):
        N = sa_full.shape[0]
        return jnp.roll(sa_full, n - N)

    return jax.jit(f, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def derive_sa_full_jit():
    """Full-sort fallback for poisoned rotating derives (adversarial
    inputs): O(N) 3-array sorts per round — correct for anything, but its
    transients need ~24 bytes/char of HBM, so callers should keep rows at
    or below 256 MiB when inputs may be adversarial."""
    from .suffix_array import _doubling_kernel

    def f(text, n):
        N = text.shape[0]
        sa_full = _doubling_kernel(text, jnp.asarray(n, jnp.int32))
        return jnp.roll(sa_full, n - N)

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def derive_aux_jit(num_limbs: int, depth: int):
    """Device program: (text, n, sa) -> (packed limb keys, bucket table).
    Second stage of the derive load path — see :func:`derive_sa_jit`."""

    def f(text, n, sa):
        limbs = build_limbs_device(text, n, sa, num_limbs)
        table = build_bucket_table_device(text, n, sa, depth)
        return limbs, table

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def set_row_jit():
    """Donated in-place row write ``buf.at[i].set(row)``.

    The derive load path fills stacked [C, ...] device buffers one chunk at
    a time; donation lets XLA alias the output to the input buffer so the
    write costs one row, not a second buffer-sized allocation (a trailing
    ``jnp.stack`` transiently doubles the largest resident array)."""

    def f(buf, i, row):
        return buf.at[i].set(row)

    return jax.jit(f, donate_argnums=(0,))


# ---------------------------------------------------------------------------
# Phased raw-limb probe — the production query path
# ---------------------------------------------------------------------------
#
# Cost model: the probe's work is its gathers,
#
#     lanes x elements-per-lane-per-step x steps,
#
# at a per-element cost that was flat in array size and index locality on
# the original target (not measured on a GPU yet — ROADMAP).
#
# The round-1 probe gathered k_used (up to 5) int32 digit-limbs per lane per
# step.  This probe gathers exactly ONE int32 per lane per step and makes it
# carry 4 text bytes instead of 3:
#
# - Limb j of SA slot i packs text[sa[i]+D+4j .. +3] as a big-endian int32
#   with the top byte biased by -128 (an order-preserving signed encoding —
#   the classic sign-flip trick without leaving int32), where D = bucket
#   table depth.  Past-the-end bytes zero-fill, which sorts prefixes before
#   extensions PROVIDED the text contains no 0x00 byte; chunks containing
#   NUL fall back to the base-258 digit-limb probe (probe_bounds_limbs_loop)
#   whose 0-digit encodes past-end exactly.
# - The search runs in PHASES: the duplex pair (lower lane b, upper lane
#   b+B) bisects limb j within the current tie range; when both lanes of a
#   pair converge they have found [first slot with limb_j >= t_j, first slot
#   with limb_j > t_j) — the tie range of limb j — and the pair descends
#   into it for limb j+1 (an exchange across the duplex halves).  Equal
#   4-byte windows are 26x rarer than equal 3-byte windows at word
#   boundaries, so phase re-localization (the Sum log2 W_j overhead measured
#   in benchmarks/phase_sim.py) shrinks vs 3-byte limbs.
# - Patterns longer than the packed coverage (D + 4*num_limbs bytes) finish
#   with a raw text-window bisection inside the final tie range.
#
# Interpolated midpoints were simulated on the bench corpus and REJECTED:
# mean 96 steps vs binary's 19.5 (values cluster into lattice islands;
# interpolation crawls across them).  See benchmarks/phase_sim.py.

RAW_LIMBS = 3


def raw_cover_bytes(num_limbs: int = RAW_LIMBS, depth: int = 3) -> int:
    return depth + 4 * num_limbs


def build_raw_limbs_host(
    data: np.ndarray, sa: np.ndarray, num_limbs: int = RAW_LIMBS,
    depth: int = 3,
) -> np.ndarray:
    """[num_limbs, n] int32 raw-packed prefix keys, plane-major.

    Limb j of slot i = text bytes ``sa[i]+depth+4j .. +3`` packed big-endian
    with the top byte biased by -128; zero fill past the end.  Only valid
    for NUL-free chunks (see module comment above).
    """
    n = data.size
    if n == 0:
        return np.zeros((num_limbs, 0), dtype=np.int32)
    width = raw_cover_bytes(num_limbs, depth)
    b = np.zeros(n + width, dtype=np.int64)
    b[:n] = data
    out = np.empty((num_limbs, n), dtype=np.int32)
    base = sa.astype(np.int64) + depth
    for j in range(num_limbs):
        o = base + 4 * j
        v = (
            (b[o] - 128) * 16777216
            + b[o + 1] * 65536
            + b[o + 2] * 256
            + b[o + 3]
        )
        out[j] = v.astype(np.int32)
    return out


def build_raw_limbs_device(text, n, sa, num_limbs: int = RAW_LIMBS,
                           depth: int = 3):
    """Device twin of :func:`build_raw_limbs_host`: [N * num_limbs] int32 in
    SA-slot order, plane-major, derived entirely in HBM (text-order shifted
    byte streams packed, then one element gather per limb)."""
    N = text.shape[0]
    n = jnp.asarray(n, jnp.int32)
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    b = jnp.where(iota < n, text.astype(jnp.int32), 0)

    def shifted(j):
        return jnp.where(iota + j < n, jnp.roll(b, -j), 0)

    sa_c = jnp.clip(sa, 0, N - 1)
    cols = []
    for j in range(num_limbs):
        o = depth + 4 * j
        lj = (
            (shifted(o) - 128) * 16777216
            + shifted(o + 1) * 65536
            + shifted(o + 2) * 256
            + shifted(o + 3)
        )
        # Zero the padding slots (>= n) for state parity with the host
        # builder; probe ranges never reach them (tables clamp to n).
        cols.append(jnp.where(iota < n, jnp.take(lj, sa_c, axis=0), 0))
    return jnp.concatenate(cols)


@functools.lru_cache(maxsize=None)
def derive_aux_row_jit(kind: str, num_limbs: int, base: int, depth: int,
                       bits):
    """One row's full aux build (all limb planes + seed table) as a single
    program — the sharded derive path's form, where each device holds few
    rows and dispatches stay per-device (the stacked donated-buffer form in
    models/index.py is for the single-device load, whose HBM transients are
    the binding constraint)."""

    def f(text, n, sa, rank):
        if kind == 'ranked':
            limbs = build_ranked_limbs_device(
                text, n, sa, rank, num_limbs, depth, bits
            )
        elif kind == 'raw':
            limbs = build_raw_limbs_device(text, n, sa, num_limbs, depth)
        else:
            limbs = build_limbs_device(text, n, sa, num_limbs)
        table = build_seed_table_device(text, n, sa, rank, base, depth)
        return limbs, table

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def raw_pack_jit(depth: int):
    """[N] int32: position p's next 4 raw bytes packed big-endian with the
    top byte biased by -128 (the raw limb encoding) — packed ONCE per
    chunk; every limb plane is then a single dynamic-offset gather
    (:func:`derive_limb_raw_jit`), so the per-plane program count stays 1
    regardless of plane index."""

    def f(text, n):
        N = text.shape[0]
        n = jnp.asarray(n, jnp.int32)
        iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
        b = jnp.where(iota < n, text.astype(jnp.int32), 0)

        def shifted(o):
            return jnp.where(iota + o < n, jnp.roll(b, -o), 0)

        return (
            (b - 128) * 16777216
            + shifted(1) * 65536
            + shifted(2) * 256
            + shifted(3)
        )

    del depth  # packing is offset-free; depth applies at gather time
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def derive_limb_raw_jit(depth: int):
    """One raw limb plane — a dynamic-offset gather from the packed raw
    stream (:func:`raw_pack_jit`) — written straight into the stacked limb
    buffer.  ``(buf [C, K*N], i, j, packed [N], n, sa [N]) -> buf`` with
    plane j of chunk i filled; ``buf`` is DONATED; ``j`` is a TRACED
    operand, so all planes share one compiled program."""

    def f(buf, i, j, packed, n, sa):
        N = packed.shape[0]
        n = jnp.asarray(n, jnp.int32)
        iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
        o = depth + 4 * j
        idx = jnp.clip(jnp.clip(sa, 0, N - 1) + o, 0, N - 1)
        col = jnp.where(iota < n, jnp.take(packed, idx), 0)
        return lax.dynamic_update_slice(
            buf, col[None], (i, j * N)
        )

    return jax.jit(f, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def derive_table_raw_jit(base: int, depth: int):
    """Seed table of chunk i, written into the stacked table buffer
    (DONATED) — the table-only twin of :func:`derive_limb_raw_jit`."""

    def f(buf, i, text, n, sa, rank):
        table = build_seed_table_device(text, n, sa, rank, base, depth)
        return lax.dynamic_update_slice(buf, table[None], (i, 0))

    return jax.jit(f, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def derive_table_from_pack_jit(base: int, depth: int, bits: int):
    """Seed table of chunk i from the ALREADY-PACKED rank stream.

    For ranked encodings ``base == 1 << bits`` always holds
    (pick_table_params and ranked_bits quantize to the same power of two),
    so the first ``depth`` rank digits of suffix ``sa[slot]`` are just
    ``packed[sa[slot]] >> ((D - depth) * bits)`` — the whole table build
    reduces to one N-gather + scatter-min + reverse cummin, instead of
    re-deriving the digit stream (derive_table_raw_jit: depth shifted
    N-streams + the same tail); the derive load already materializes
    ``packed`` for the limb planes, so the table rides along.
    """
    D = ranked_limb_bytes(bits)
    assert base == 1 << bits and depth <= D

    def f(buf, i, packed, n, sa):
        N = packed.shape[0]
        n = jnp.asarray(n, jnp.int32)
        iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
        size = base ** depth + 1
        key = jnp.take(packed, jnp.clip(sa, 0, N - 1)) >> (
            (D - depth) * bits
        )
        b = jnp.where(iota < n, key, size - 1)
        first = jnp.full((size,), N, jnp.int32).at[b].min(iota, mode='drop')
        table = jnp.minimum(lax.cummin(first, reverse=True), n)
        return lax.dynamic_update_slice(buf, table[None], (i, 0))

    return jax.jit(f, donate_argnums=(0,))


def alphabet_rank(present: np.ndarray):
    """(rank[256] int32, sigma) for a boolean present-bytes mask.

    ``rank[b] = 1 + #present bytes < b`` — the rank of b when present, its
    insertion rank when absent; monotone in b either way, so rank-digit
    prefix values stay non-decreasing in SA order.  Digit 0 is the past-end
    pad; ``base - 1`` the +inf pad (callers pick base >= sigma + 2).
    """
    present = np.asarray(present, dtype=bool)
    rank = np.zeros(256, dtype=np.int32)
    rank[1:] = np.cumsum(present.astype(np.int32))[:-1]
    return rank + 1, int(present.sum())


def identity_rank():
    """rank/present pair for the full-byte (base 258) digit table."""
    return (
        np.arange(1, 257, dtype=np.int32),
        np.ones(256, dtype=np.int32),
    )


def build_seed_table_host(
    data: np.ndarray, sa: np.ndarray, rank: np.ndarray, base: int, depth: int
) -> np.ndarray:
    """Ranked seed table: table[k] = first SA slot whose depth-digit
    rank-prefix value is >= k.  Host (numpy) twin used at upload-mode load;
    the base-258 identity-rank case reproduces build_bucket_table_host."""
    size = base ** depth + 1
    n = data.size
    if n == 0:
        return np.zeros(size, dtype=np.int32)
    rk = rank.astype(np.int64)[data]
    b = np.zeros(n, dtype=np.int64)
    sa64 = sa.astype(np.int64)
    for j in range(depth):
        nxt = sa64 + j
        dj = np.where(nxt < n, rk[np.minimum(nxt, n - 1)], 0)
        b = b * base + dj
    probes = np.arange(size, dtype=np.int64)
    return np.searchsorted(b, probes, side='left').astype(np.int32)


def build_seed_table_device(text, n, sa, rank, base: int, depth: int):
    """Device twin of :func:`build_seed_table_host` via scatter-min (same
    construction as build_bucket_table_device, rank digits instead of
    byte+1 digits)."""
    N = text.shape[0]
    n = jnp.asarray(n, jnp.int32)
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    d = jnp.where(iota < n, jnp.take(rank, text.astype(jnp.int32)), 0)
    pv = jnp.zeros((N,), jnp.int32)
    for j in range(depth):
        pv = pv * base + jnp.where(iota + j < n, jnp.roll(d, -j), 0)
    b = jnp.take(pv, jnp.clip(sa, 0, N - 1), axis=0)
    size = base ** depth + 1
    b = jnp.where(iota < n, b, size - 1)
    first = jnp.full((size,), N, jnp.int32).at[b].min(iota, mode='drop')
    table = lax.cummin(first, reverse=True)
    return jnp.minimum(table, n)


def _tiny_map(values, table256):
    """Map byte values (int32 in [0, 256)) through a [256] int32 table:
    one exact integer gather."""
    return jnp.take(table256, values, axis=0)


def _pattern_buckets_ranked(raw_both, lengths, thresholds, rank, present,
                            base: int, depth: int):
    """(bucket ids [2B], prefix_present [2B]) for duplex lanes.

    Digits are alphabet ranks; lower lanes pad past-the-pattern digits with
    0, upper with base-1.  A pattern byte ABSENT from the corpus alphabet
    within the first ``depth`` bytes forces both lanes to the same id (its
    insertion rank followed by 0-pads), which collapses the seeded range to
    an empty range — count 0 with no probing.  (The collapsed POSITION may
    be the colliding rank's bucket start rather than the pattern's exact
    insertion slot; only counts are API-visible, and they are exact.)
    """
    B2, L = raw_both.shape
    cols = min(L, depth)
    ipos = lax.broadcasted_iota(jnp.int32, (B2, depth), 1)
    bytes_d = jnp.zeros((B2, depth), jnp.int32)
    bytes_d = bytes_d.at[:, :cols].set(raw_both[:, :cols].astype(jnp.int32))
    r = _tiny_map(bytes_d, rank)
    pres = _tiny_map(bytes_d, present) > 0
    in_len = ipos < lengths[:, None]
    bad = jnp.logical_and(in_len, ~pres)
    first_bad = jnp.min(jnp.where(bad, ipos, depth), axis=1)
    pad = jnp.where(thresholds > 0, base - 1, 0)
    dj = jnp.where(in_len, r, pad[:, None])
    dj = jnp.where(ipos == first_bad[:, None], r, dj)
    dj = jnp.where(ipos > first_bad[:, None], 0, dj)
    bucket = jnp.zeros((B2,), jnp.int32)
    for j in range(depth):
        bucket = bucket * base + dj[:, j]
    prefix_present = first_bad >= jnp.minimum(lengths, depth)
    return bucket, prefix_present


def _raw_targets(patterns, lengths, thresholds, num_limbs: int, depth: int):
    """(targets [2B, K] int32, k_lane [2B] int32) for duplex lanes.

    Lower lanes pad past-the-pattern bytes with 0x00, upper with 0xFF; the
    top byte of each limb is biased by -128 to match the stored encoding.
    ``k_lane`` = number of limb phases the pattern needs (0 when it fits the
    bucket digits; ``num_limbs`` when it extends past the packed coverage —
    the deep text refinement takes over from there).
    """
    B2, L = patterns.shape
    width = raw_cover_bytes(num_limbs, depth)
    pad = jnp.where(thresholds > 0, 255, 0)  # [2B]
    cols = min(L, width)
    ipos = lax.broadcasted_iota(jnp.int32, (B2, width), 1)
    raw = jnp.zeros((B2, width), jnp.int32)
    raw = raw.at[:, :cols].set(patterns[:, :cols].astype(jnp.int32))
    byteval = jnp.where(ipos < lengths[:, None], raw, pad[:, None])
    tgt = jnp.stack(
        [
            (byteval[:, depth + 4 * j] - 128) * 16777216
            + byteval[:, depth + 4 * j + 1] * 65536
            + byteval[:, depth + 4 * j + 2] * 256
            + byteval[:, depth + 4 * j + 3]
            for j in range(num_limbs)
        ],
        axis=1,
    )
    k_lane = jnp.clip(-(-(lengths - depth) // 4), 0, num_limbs)
    return tgt, k_lane.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Rank-packed limbs — small-alphabet corpora (the common case)
# ---------------------------------------------------------------------------
#
# When the corpus alphabet has sigma distinct bytes, each byte's rank fits
# ceil(log2(sigma + 2)) bits (two pad digits: 0 = past-end, all-ones = +inf),
# so one int32 limb carries 30 // bits ranked bytes instead of 4 raw ones —
# SIX bytes per gather at sigma <= 30 (natural text), FIVE at sigma <= 62.
# Wider coverage per limb means fewer phases per query (a 12-byte pattern is
# one phase after a depth-5 seed, not two), and rank digits encode past-end
# exactly, so NUL bytes in the text need no special casing (unlike the raw
# packing above).  One caveat: a pattern byte ABSENT from the alphabet maps
# to its insertion rank, which collides with the next present byte — digit
# order diverges from byte order there, so such patterns' counts are forced
# to 0 after the loop (they cannot match by definition; `bad` below).


def ranked_bits(sigma: int) -> typing.Optional[int]:
    """Bits per rank digit for the packed-rank limb encoding, or None when
    the alphabet is too large for it to beat raw byte packing."""
    if sigma <= 30:
        return 5
    if sigma <= 62:
        return 6
    return None


def ranked_limb_bytes(bits: int) -> int:
    return 30 // bits


def ranked_cover_bytes(num_limbs: int, depth: int, bits: int) -> int:
    return depth + ranked_limb_bytes(bits) * num_limbs


def build_ranked_limbs_host(
    data: np.ndarray, sa: np.ndarray, rank: np.ndarray,
    num_limbs: int, depth: int, bits: int,
) -> np.ndarray:
    """[num_limbs, n] int32 rank-packed prefix keys, plane-major.

    Limb j of slot i packs the rank digits of text bytes
    ``sa[i]+depth+D*j .. +D-1`` (D = 30 // bits) big-endian at ``bits`` bits
    per digit; past-the-end digits are 0."""
    n = data.size
    D = ranked_limb_bytes(bits)
    if n == 0:
        return np.zeros((num_limbs, 0), dtype=np.int32)
    width = depth + D * num_limbs
    dig = np.zeros(n + width, dtype=np.int64)
    dig[:n] = rank.astype(np.int64)[data]
    out = np.empty((num_limbs, n), dtype=np.int32)
    base_off = sa.astype(np.int64) + depth
    for j in range(num_limbs):
        o = base_off + D * j
        v = np.zeros(n, dtype=np.int64)
        for i in range(D):
            v = (v << bits) + dig[o + i]
        out[j] = v.astype(np.int32)
    return out


def build_ranked_limbs_device(text, n, sa, rank, num_limbs: int,
                              depth: int, bits: int):
    """Device twin of :func:`build_ranked_limbs_host` (all planes; tests and
    small chunks — the derive path splits packing and per-plane gathers into
    separate dispatches to bound HBM transients)."""
    packed = _ranked_pack_device(text, n, rank, bits)
    cols = [
        _ranked_limb_col_from_pack(packed, n, sa, j, depth, bits)
        for j in range(num_limbs)
    ]
    return jnp.concatenate(cols)


def _ranked_pack_device(text, n, rank, bits: int):
    """[N] int32: position p's next D rank digits packed big-endian.

    Doubling ladder (s2 from e, s4 from s2, s_D from s4) so at most three
    N-arrays are live at once — a naive D-term shift sum materializes D
    rolled copies.  Roll wrap-around only
    corrupts the last D-1 positions, which sit in the PAD_MARGIN padding no
    in-range gather can reach; past-end digits are exact zeros via e's mask.
    """
    N = text.shape[0]
    D = ranked_limb_bytes(bits)
    n = jnp.asarray(n, jnp.int32)
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    e = jnp.where(iota < n, jnp.take(rank, text.astype(jnp.int32)), 0)
    s2 = (e << bits) + jnp.roll(e, -1)
    s4 = (s2 << (2 * bits)) + jnp.roll(s2, -2)
    if D == 6:
        return (s4 << (2 * bits)) + jnp.roll(s2, -4)
    assert D == 5
    return (s4 << bits) + jnp.roll(e, -4)


def _ranked_limb_col_from_pack(packed, n, sa, j: int, depth: int,
                               bits: int):
    N = packed.shape[0]
    D = ranked_limb_bytes(bits)
    n = jnp.asarray(n, jnp.int32)
    iota = lax.broadcasted_iota(jnp.int32, (N,), 0)
    o = depth + D * j
    idx = jnp.clip(jnp.clip(sa, 0, N - 1) + o, 0, N - 1)
    return jnp.where(iota < n, jnp.take(packed, idx), 0)


@functools.lru_cache(maxsize=None)
def ranked_pack_jit(bits: int):
    return jax.jit(
        lambda text, n, rank: _ranked_pack_device(text, n, rank, bits)
    )


@functools.lru_cache(maxsize=None)
def derive_limb_ranked_jit(depth: int, bits: int):
    """Ranked twin of :func:`derive_limb_raw_jit`: one rank-packed limb
    plane — a single offset gather from the chunk's packed digit stream
    (:func:`ranked_pack_jit`) — written straight into the DONATED stacked
    limb buffer.  ``j`` is a TRACED operand: one program serves every
    plane."""

    def f(buf, i, j, packed, n, sa):
        N = packed.shape[0]
        col = _ranked_limb_col_from_pack(packed, n, sa, j, depth, bits)
        return lax.dynamic_update_slice(buf, col[None], (i, j * N))

    return jax.jit(f, donate_argnums=(0,))


def _ranked_targets(patterns, lengths, thresholds, rank, present,
                    num_limbs: int, depth: int, bits: int):
    """(targets [2B, K] int32, k_lane [2B], bad [2B] bool) for duplex lanes.

    Digits are alphabet ranks packed ``bits`` per digit; lower lanes pad
    past-the-pattern digits with 0, upper with the all-ones +inf digit.
    ``bad`` marks lanes whose pattern contains a byte absent from the
    alphabet within the packed coverage — their digit-space bounds are not
    byte-order-exact (rank collision), and the caller forces their counts
    to 0 (such patterns cannot match).
    """
    B2, L = patterns.shape
    D = ranked_limb_bytes(bits)
    width = depth + D * num_limbs
    pad = jnp.where(thresholds > 0, (1 << bits) - 1, 0)  # [2B]
    cols = min(L, width)
    ipos = lax.broadcasted_iota(jnp.int32, (B2, width), 1)
    raw = jnp.zeros((B2, width), jnp.int32)
    raw = raw.at[:, :cols].set(patterns[:, :cols].astype(jnp.int32))
    in_len = ipos < lengths[:, None]
    r = _tiny_map(raw, rank)
    pres = _tiny_map(raw, present) > 0
    digit = jnp.where(in_len, r, pad[:, None])
    tgt = jnp.stack(
        [
            functools.reduce(
                lambda acc, i, j=j: (acc << bits) + digit[:, depth + D * j + i],
                range(D),
                jnp.zeros((B2,), jnp.int32),
            )
            for j in range(num_limbs)
        ],
        axis=1,
    )
    k_lane = jnp.clip(-(-(lengths - depth) // D), 0, num_limbs)
    bad = jnp.any(jnp.logical_and(in_len, ~pres), axis=1)
    return tgt, k_lane.astype(jnp.int32), bad


def probe_bounds_phased(text, n, sa, table, limbs_flat, rank, present,
                        patterns, lengths, num_limbs: int = RAW_LIMBS,
                        deep: bool = False,
                        bits: typing.Optional[int] = None,
                        uniform_long: bool = False):
    """(lower, count) for a query batch via the phased packed-limb search.

    One int32 gather per lane per while-iteration; phases descend limb by
    limb through tie ranges (see the section comment above).  The seed
    table's static length encodes its (base, depth); ``rank``/``present``
    are the index's alphabet maps ([256] int32 each — identity_rank() for
    base-258 tables).  ``deep`` (static) appends a text-window bisection for
    patterns longer than the packed coverage.  ``bits`` (static) selects the
    limb encoding: None = raw 4-byte packing (NUL-free text only), else
    rank-packed digits at ``bits`` bits (30 // bits bytes per limb).
    """
    n = jnp.asarray(n, jnp.int32)
    both, both_len, thresholds = _duplex(patterns, lengths)
    B = patterns.shape[0]
    base, depth = table_params(table.shape[0])
    raw_both = jnp.concatenate([patterns, patterns], axis=0).astype(jnp.uint8)
    # Per-pair seeding is only sound when the CALLER guarantees every
    # real lane's pattern exceeds the seed depth (the class-dispatched
    # production path; class >= 1 members all satisfy it, and pad lanes'
    # bounds are discarded).  Mixed direct calls keep the exact duplex
    # seeding.
    pair_seed = uniform_long and patterns.shape[1] > depth
    if pair_seed:
        # Every real pattern in this class is longer than the seed depth,
        # so its first `depth` digits carry no pads: bucket ids (and hence
        # table/aux seeds) are IDENTICAL across the duplex pair — compute
        # them once per pair and tile.  (Pad lanes have length 0 and are
        # seed-resolved/done immediately; their bounds are discarded.)
        bucket_p, prefix_present_p = _pattern_buckets_ranked(
            patterns.astype(jnp.uint8), lengths,
            jnp.zeros((B,), jnp.int32), rank, present, base, depth,
        )
        bucket = jnp.concatenate([bucket_p, bucket_p])
        prefix_present = jnp.concatenate(
            [prefix_present_p, prefix_present_p]
        )
    else:
        bucket, prefix_present = _pattern_buckets_ranked(
            raw_both, both_len, thresholds, rank, present, base, depth
        )
    if bits is None:
        cover = raw_cover_bytes(num_limbs, depth)
        tgt, k_lane = _raw_targets(
            raw_both, both_len, thresholds, num_limbs, depth
        )
        bad_pair = None
    else:
        cover = ranked_cover_bytes(num_limbs, depth, bits)
        tgt, k_lane, bad = _ranked_targets(
            raw_both, both_len, thresholds, rank, present,
            num_limbs, depth, bits,
        )
        bad_pair = bad[:B]
    k_pair = k_lane[:B]  # equal across the duplex halves
    # A pattern of exactly `depth` bytes is decided by the table alone, but
    # its upper lane's bucket id equals the lower's (no pad digits) — bump it
    # so the upper answer is the next bucket's start (first prefix > pattern).
    # (Not when an absent byte already collapsed the ids on purpose.)
    bump = jnp.logical_and(
        jnp.logical_and(thresholds > 0, both_len == depth), prefix_present
    )
    if pair_seed:
        # bump never fires (lengths != depth for real lanes; pad lanes are
        # discarded), so the pair shares (lo0, hi0) — one gather pair per
        # pair instead of per lane.
        lo0_p = jnp.take(table, bucket_p, axis=0)
        hi0_p = jnp.take(table, bucket_p + 1, axis=0)
        lo0 = jnp.concatenate([lo0_p, lo0_p])
        hi0 = jnp.concatenate([hi0_p, hi0_p])
    else:
        lo0 = jnp.take(table, bucket + bump.astype(jnp.int32), axis=0)
        hi0 = jnp.take(table, bucket + 1, axis=0)
    Nk = limbs_flat.shape[0]
    Ns = Nk // max(num_limbs, 1)
    kcol = lax.broadcasted_iota(jnp.int32, (2 * B, num_limbs), 1)
    is_upper = thresholds > 0

    # done / j are per PAIR [B]; lanes idle once their pair is done.
    done0 = k_pair < 1  # bucket digits already decide these patterns
    j0 = jnp.zeros((B,), jnp.int32)
    # fresh = pair is ENTERING a phase this iteration: instead of bisecting,
    # the lower lane peeks the range start's limb value and the upper lane
    # the range end's.  Over a sorted range, an answer at either endpoint
    # resolves in this single probe — which covers the common skewed cases
    # outright: ranges whose packed keys are all EQUAL (buckets whose
    # continuation bytes are deterministic, e.g. any range inside one
    # word's occurrences — bisection would burn log2(width) iterations
    # discovering uniformity), zero-count patterns, and edge-hugging
    # bounds.  Unresolved lanes lose one iteration and bisect normally.
    fresh0 = ~done0

    def cond(state):
        lo, hi, j, done, fresh = state
        return jnp.any(~done)

    def body(state):
        lo, hi, j, done, fresh = state
        j2 = jnp.concatenate([j, j])
        done2 = jnp.concatenate([done, done])
        fresh2 = jnp.concatenate([fresh, fresh])
        mid = (lo + hi) // 2
        # Probe slot: phase-entry lanes peek their pair-range endpoints
        # (at entry each lane's own (lo, hi) IS the pair range).
        peek = jnp.where(is_upper, jnp.maximum(hi - 1, lo), lo)
        slot = jnp.where(fresh2, peek, mid)
        idx = j2 * Ns + jnp.clip(slot, 0, Ns - 1)
        v = jnp.take(limbs_flat, jnp.clip(idx, 0, Nk - 1), axis=0)
        # target of the current phase: one-hot select along K (K tiny).
        t = jnp.sum(
            jnp.where(kcol == j2[:, None], tgt, 0), axis=1
        )
        pred = jnp.where(is_upper, v > t, v >= t)
        # Endpoint resolution for fresh lanes, sharing the pair's two
        # endpoint values: answer == range start when the start's value
        # already satisfies the predicate; == range end when the end's
        # value does not.
        vA2 = jnp.concatenate([v[:B], v[:B]])
        vZ2 = jnp.concatenate([v[B:], v[B:]])
        hit_at_a = jnp.where(is_upper, vA2 > t, vA2 >= t)
        miss_at_z = jnp.where(is_upper, vZ2 <= t, vZ2 < t)
        pa2 = jnp.concatenate([lo[:B], lo[:B]])
        pz2 = jnp.concatenate([hi[:B], hi[:B]])
        nonempty2 = pa2 < pz2
        resolved = jnp.logical_and(
            jnp.logical_and(fresh2, nonempty2),
            jnp.logical_and(jnp.logical_or(hit_at_a, miss_at_z), ~done2),
        )
        res = jnp.where(hit_at_a, pa2, pz2)
        # Normal bisection applies to non-fresh active lanes only.
        active = jnp.logical_and(
            jnp.logical_and(lo < hi, ~done2), ~fresh2
        )
        hi = jnp.where(jnp.logical_and(active, pred), mid, hi)
        lo = jnp.where(jnp.logical_and(active, ~pred), mid + 1, lo)
        lo = jnp.where(resolved, res, lo)
        hi = jnp.where(resolved, res, hi)
        # Phase transition: both lanes of a pair converged.
        conv = lo >= hi
        pair_conv = jnp.logical_and(
            jnp.logical_and(conv[:B], conv[B:]), ~done
        )
        A = lo[:B]
        Z = lo[B:]
        adv = jnp.logical_and(
            pair_conv, jnp.logical_and(j + 1 < k_pair, A < Z)
        )
        done = jnp.logical_or(done, jnp.logical_and(pair_conv, ~adv))
        j = j + adv.astype(jnp.int32)
        adv2 = jnp.concatenate([adv, adv])
        A2 = jnp.concatenate([A, A])
        Z2 = jnp.concatenate([Z, Z])
        lo = jnp.where(adv2, A2, lo)
        hi = jnp.where(adv2, Z2, hi)
        return lo, hi, j, done, adv

    lo, hi, _, _, _ = lax.while_loop(
        cond, body, (lo0, hi0, j0, done0, fresh0)
    )
    if deep:
        # Patterns longer than the packed coverage: continue on raw text
        # within the key-resolved tie range.  Pairs already resolved start
        # with empty ranges pinned at their final answers.
        need = both_len[:B] > cover
        A = lo[:B]
        Z = lo[B:]
        l0 = jnp.concatenate([A, jnp.where(need, A, Z)], axis=0)
        h0 = jnp.concatenate([jnp.where(need, Z, A), Z], axis=0)

        def cond2(state):
            lo, hi = state
            return jnp.any(lo < hi)

        def body2(state):
            lo, hi = state
            mid = (lo + hi) // 2
            cmp = _cmp3(text, n, sa, mid, both, both_len)
            pred = cmp >= thresholds
            active = lo < hi
            hi = jnp.where(jnp.logical_and(active, pred), mid, hi)
            lo = jnp.where(jnp.logical_and(active, ~pred), mid + 1, lo)
            return lo, hi

        lo, _ = lax.while_loop(cond2, body2, (l0, h0))
    lower = lo[:B]
    count = lo[B:] - lower
    if bad_pair is not None:
        # Rank collision: a pattern byte absent from the alphabet shares its
        # insertion rank with the next present byte, so digit-space bounds
        # are not byte-order-exact there.  Such patterns cannot match —
        # force the API-visible count to 0 (deep lanes self-correct, but the
        # packed-coverage lanes need this).
        count = jnp.where(bad_pair, 0, count)
    return lower, count


@functools.lru_cache(maxsize=None)
def phased_batch_jit(deep: bool, num_limbs: int,
                     bits: 'typing.Optional[int]' = None,
                     uniform_long: bool = False):
    """Jitted chunk-vmapped phased probe — one compiled program per
    (deep?, num_limbs, bits, operand shapes), independent of corpus
    statistics.  rank/present are shared across chunks (union
    alphabet)."""

    def f(text, n, sa, table, limbs, rank, present, patterns, lengths):
        return probe_bounds_phased(
            text, n, sa, table, limbs, rank, present, patterns, lengths,
            num_limbs, deep, bits, uniform_long=uniform_long,
        )

    return jax.jit(
        jax.vmap(f, in_axes=(0, 0, 0, 0, 0, None, None, None, None))
    )


# ---------------------------------------------------------------------------
# AOT executable cache for per-class probe programs.
#
# The phased probe runs one program per (class width, padded class size) —
# a canonical shape ladder, NOT a function of the whole batch — so programs
# compile once per geometry and serve every future batch (and, through the
# persistent compilation cache, every future process).  Executables are
# compiled from ShapeDtypeStructs alone, which makes two things possible:
#
# - warm-up with NO index built yet (DeviceIndex.plan gives the geometry
#   from the container's host data), overlapping probe compilation with the
#   derive load's device work;
# - parallel compilation of cold classes (threads overlap them).
# ---------------------------------------------------------------------------

_EXEC_CACHE: dict = {}
_EXEC_LOCK = threading.Lock()


def _depth_of(table_len: int) -> int:
    return table_params(table_len)[1]


def _class_exec_key(num_limbs, bits, deep, C, n_pad, table_len, Bk,
                    width):
    return (num_limbs, bits, deep, C, n_pad, table_len, Bk, width)


def phased_class_exec(num_limbs: int, bits, deep: bool, C: int, n_pad: int,
                      table_len: int, Bk: int, width: int):
    """Compiled executable for one phase-class sub-probe shape (cached)."""
    key = _class_exec_key(num_limbs, bits, deep, C, n_pad, table_len,
                          Bk, width)
    exe = _EXEC_CACHE.get(key)
    if exe is not None:
        return exe
    s = jax.ShapeDtypeStruct
    base, _ = table_params(table_len)
    args = (
        s((C, n_pad), jnp.uint8),          # text
        s((C,), jnp.int32),                # n
        s((C, n_pad), jnp.int32),          # sa
        s((C, table_len), jnp.int32),      # table
        s((C, n_pad * num_limbs), jnp.int32),  # limbs
        s((256,), jnp.int32),              # rank
        s((256,), jnp.int32),              # present
        s((Bk, width), jnp.uint8),         # patterns
        s((Bk,), jnp.int32),               # lengths
    )
    lowered = phased_batch_jit(
        deep, num_limbs, bits, uniform_long=width > _depth_of(table_len)
    ).lower(*args)
    compiled = lowered.compile()
    with _EXEC_LOCK:
        _EXEC_CACHE.setdefault(key, compiled)
    return _EXEC_CACHE[key]


def warm_phased_classes(keys, parallel: bool = True) -> None:
    """Compile the given class-shape keys (tuples as accepted by
    :func:`phased_class_exec`), overlapping compilations in threads."""
    cold = [k for k in keys
            if _class_exec_key(*k) not in _EXEC_CACHE]
    if not cold:
        return
    if parallel and len(cold) > 1:
        with ThreadPoolExecutor(max_workers=min(8, len(cold))) as pool:
            list(pool.map(lambda k: phased_class_exec(*k), cold))
    else:
        for k in cold:
            phased_class_exec(*k)


def class_spec(lengths: np.ndarray, depth: int, limb_bytes: int,
               cover: int, num_limbs: int):
    """Canonical per-class (Bk, width, deep) spec and member indices for a
    batch's length distribution: class k = ceil((L - depth) / limb_bytes)
    limb phases, one extra class for patterns past the packed coverage.
    Class sizes pad to a grid (pow2 up to 1024, then multiples of 256):
    bounded program count with small lane waste, since probe cost is
    lane-proportional.  (The ladder was tuned on the original target; not
    re-measured on a GPU yet — ROADMAP.)"""
    lengths = np.asarray(lengths)
    classes = np.clip(
        -(-(lengths - depth) // max(limb_bytes, 1)), 0, num_limbs
    ).astype(np.int64)
    classes = np.where(lengths > cover, num_limbs + 1, classes)
    out = []
    for k in np.unique(classes):
        idx = np.flatnonzero(classes == k)
        if int(k) <= num_limbs:
            width = depth + limb_bytes * int(k) if k > 0 else depth
        else:
            width = -(-int(lengths[idx].max()) // 4) * 4
        if idx.size <= 1024:
            Bk = max(8, 1 << int(np.ceil(np.log2(idx.size))))
        else:
            Bk = -(-idx.size // 256) * 256
        out.append((int(Bk), int(width), bool(width > cover), idx))
    return out


@functools.lru_cache(maxsize=None)
def _gather_hits_jit(cap: int):
    """Jitted gather of up to ``cap`` matching text positions per query."""

    def gather(sa, lower, count):
        N = sa.shape[0]
        c = min(cap, N)
        B = lower.shape[0]
        off = lax.broadcasted_iota(jnp.int32, (B, c), 1)
        slot = lower[:, None] + off
        rows = jnp.take(sa, jnp.clip(slot.reshape(-1), 0, N - 1), axis=0)
        rows = rows.reshape(B, c)
        return jnp.where(off < count[:, None], rows, -1)

    return jax.jit(gather)


def gather_hit_positions(sa, lower, count, cap: int):
    """Text positions of up to ``cap`` hits per query; -1 pads. [B, cap]."""
    return _gather_hits_jit(cap)(sa, lower, count)


@functools.lru_cache(maxsize=None)
def _gather_flat_jit(T: int):
    """Jitted COMPACT hit gather: all queries' SA ranges flattened into one
    [T] positions array plus the owning query id per slot (-1 pads).

    Unlike the [B, cap] padded form, readback volume equals the true hit
    count (padded to the T bucket).
    """

    def gather(sa, lower, count):
        N = sa.shape[0]
        cum = jnp.cumsum(count)
        start = cum - count
        t = lax.broadcasted_iota(jnp.int32, (T,), 0)
        q = jnp.searchsorted(cum, t, side='right').astype(jnp.int32)
        qc = jnp.clip(q, 0, count.shape[0] - 1)
        slot = jnp.take(lower, qc) + (t - jnp.take(start, qc))
        pos = jnp.take(sa, jnp.clip(slot, 0, N - 1))
        valid = t < cum[-1]
        return (
            jnp.where(valid, pos, -1),
            jnp.where(valid, qc, -1),
        )

    return jax.jit(gather)


def gather_hits_flat(sa, lower, count, total: int):
    """(positions [T], query_ids [T]) device arrays for all hits of a batch,
    T = ``total`` rounded up to a power-of-two shape bucket; -1 pads."""
    T = max(8, 1 << int(np.ceil(np.log2(max(1, total)))))
    return _gather_flat_jit(T)(sa, lower, count)


def host_probe_bounds(data: bytes, sa: np.ndarray, pattern: bytes):
    """(lower, count) for one pattern on the host — exact scalar bisection
    used for patterns longer than PAD_MARGIN (outside the device windows)."""
    n = sa.shape[0]
    L = len(pattern)

    def cmp_at(slot: int) -> int:
        start = int(sa[slot])
        s = data[start : start + L]
        if s == pattern:
            return 0
        return -1 if s < pattern else 1

    def first_geq(threshold: int) -> int:
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if cmp_at(mid) >= threshold:
                hi = mid
            else:
                lo = mid + 1
        return lo

    lower = first_geq(0)
    upper = first_geq(1)
    return lower, upper - lower
