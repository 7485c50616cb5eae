"""Phased raw-limb probe (the production query path) vs brute force.

Covers: NUL-free corpora at both bucket depths, patterns at every phase
count (0 phases .. deep text refinement), high bytes (0xFF), empty patterns,
adversarial single-byte corpora, host/device raw-limb builder agreement, and
the DeviceIndex raw/digit fallback around NUL bytes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pysubstringsearch_jax.ops.search import (
    PAD_MARGIN,
    RAW_LIMBS,
    alphabet_rank,
    build_raw_limbs_device,
    build_raw_limbs_host,
    build_seed_table_device,
    build_seed_table_host,
    identity_rank,
    pack_patterns,
    pad_limbs_host,
    pick_table_params,
    probe_bounds,
    probe_bounds_phased,
    raw_cover_bytes,
)
from pysubstringsearch_jax.ops.suffix_array import (
    _pad_len,
    suffix_array_numpy,
)


def brute_counts(data: bytes, patterns):
    out = []
    for p in patterns:
        if len(p) == 0:
            out.append(len(data))
            continue
        out.append(
            sum(1 for i in range(len(data)) if data[i : i + len(p)] == p)
        )
    return np.array(out, dtype=np.int32)


def setup(data: bytes, depth: int, num_limbs: int = RAW_LIMBS,
          ranked: bool = False):
    n = len(data)
    n_pad = _pad_len(n + PAD_MARGIN)
    text = np.zeros(n_pad, dtype=np.uint8)
    text[:n] = np.frombuffer(data, dtype=np.uint8)
    sa = np.zeros(n_pad, dtype=np.int32)
    sa[:n] = suffix_array_numpy(text[:n])
    if ranked:
        pres = np.bincount(text[:n], minlength=256)[:256] > 0
        rank, sigma = alphabet_rank(pres)
        base, depth = pick_table_params(sigma, n)
    else:
        rank, pres_i = identity_rank()
        pres = pres_i > 0
        base = 258
    table = build_seed_table_host(text[:n], sa[:n], rank, base, depth)
    limbs = pad_limbs_host(
        build_raw_limbs_host(text[:n], sa[:n], num_limbs, depth), n_pad
    )
    return (
        jnp.asarray(text),
        jnp.int32(n),
        jnp.asarray(sa),
        jnp.asarray(table),
        jnp.asarray(limbs),
        jnp.asarray(rank),
        jnp.asarray(pres.astype(np.int32)),
        depth,
    )


CORPORA = [
    b'banana banana band ana nab\n',
    bytes(np.random.default_rng(1).integers(97, 100, 3000, dtype=np.uint8)),
    b'aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa',
    bytes(np.random.default_rng(2).integers(1, 256, 2500, dtype=np.uint8)),
    b'z' * 10 + b'\xff' * 10 + b'z\xff' * 10 + b'\n',
]


def sample_patterns(data: bytes, seed: int):
    rng = np.random.default_rng(seed)
    pats = [b'', b'\xff', data[:1], data[-1:], data[:2], data[:3], data[:4]]
    for l in (1, 2, 3, 4, 5, 6, 7, 8, 11, 12, 15, 16, 19, 24):
        if len(data) < 3:
            break
        i = int(rng.integers(0, max(len(data) - l, 1)))
        pats.append(data[i : i + l])
    for _ in range(30):
        i = int(rng.integers(0, len(data) - 1))
        l = int(rng.integers(1, min(20, len(data) - i) + 1))
        pats.append(data[i : i + l])
    if len(data) < 900:
        pats.append(data + b'x')
    pats.append(bytes(rng.integers(1, 256, 5, dtype=np.uint8)))
    return pats


@pytest.mark.parametrize('ci', range(len(CORPORA)))
@pytest.mark.parametrize('cfg', ['d2', 'd3', 'ranked'])
def test_phased_matches_brute_force(ci, cfg):
    data = CORPORA[ci]
    text, n, sa, table, limbs, rank, present, depth = setup(
        data, 2 if cfg == 'd2' else 3, ranked=cfg == 'ranked'
    )
    pats = sample_patterns(data, ci)
    if cfg == 'ranked':
        # Absent-byte patterns at several positions/lengths.
        pats += [b'\x00q', data[:1] + b'\x00', data[:4] + b'\xfe' * 3,
                 data[:7] + b'\x01']
        pats = [p for p in pats if b'\x00' not in p] + [b'\x02', b'\xfe']
    packed, lengths = pack_patterns(pats)
    expected = brute_counts(data, pats)
    deep = packed.shape[1] > raw_cover_bytes(RAW_LIMBS, depth)
    lo, cnt = probe_bounds_phased(
        text, n, sa, table, limbs, rank, present, jnp.asarray(packed),
        jnp.asarray(lengths), RAW_LIMBS, deep,
    )
    np.testing.assert_array_equal(np.asarray(cnt), expected)
    # Ranges must agree with the reference byte-window bisection wherever a
    # match exists (for misses only the count is API-visible: an absent-byte
    # pattern's empty range may sit at the colliding rank's bucket start,
    # not the exact insertion slot — see _pattern_buckets_ranked).
    lo_p, cnt_p = probe_bounds(
        text, n, sa, jnp.asarray(packed), jnp.asarray(lengths)
    )
    hit = expected > 0
    np.testing.assert_array_equal(np.asarray(lo)[hit], np.asarray(lo_p)[hit])


@pytest.mark.parametrize('num_limbs', [1, 2, 3])
def test_phased_limb_counts(num_limbs):
    """Every phase-count boundary: pattern lengths depth..cover+2."""
    data = CORPORA[1]
    text, n, sa, table, limbs, rank, present, depth = setup(
        data, 2, num_limbs
    )
    rng = np.random.default_rng(num_limbs)
    cover = raw_cover_bytes(num_limbs, depth)
    pats = []
    for l in range(1, cover + 3):
        i = int(rng.integers(0, len(data) - l))
        pats.append(data[i : i + l])
    packed, lengths = pack_patterns(pats)
    expected = brute_counts(data, pats)
    lo, cnt = probe_bounds_phased(
        text, n, sa, table, limbs, rank, present, jnp.asarray(packed),
        jnp.asarray(lengths), num_limbs, packed.shape[1] > cover,
    )
    np.testing.assert_array_equal(np.asarray(cnt), expected)


def test_seed_table_builders_agree():
    rng = np.random.default_rng(17)
    data = rng.integers(97, 109, size=2000, dtype=np.uint8)
    data[::31] = 0x0A
    n = data.size
    sa = suffix_array_numpy(data)
    N = _pad_len(n + 64)
    text = np.zeros(N, dtype=np.uint8)
    text[:n] = data
    sa_pad = np.zeros(N, dtype=np.int32)
    sa_pad[:n] = sa
    sa_pad[n:] = np.arange(N - 1, n - 1, -1)
    pres = np.bincount(data, minlength=256)[:256] > 0
    rank, sigma = alphabet_rank(pres)
    base, depth = pick_table_params(sigma, n)
    assert base == 32 and sigma == 13
    host = build_seed_table_host(data, sa, rank, base, depth)
    dev = np.asarray(
        build_seed_table_device(
            jnp.asarray(text), n, jnp.asarray(sa_pad), jnp.asarray(rank),
            base, depth,
        )
    )
    np.testing.assert_array_equal(dev, host)
    # identity-rank base-258 must reproduce the legacy digit table.
    from pysubstringsearch_jax.ops.search import build_bucket_table_host
    irank, _ = identity_rank()
    np.testing.assert_array_equal(
        build_seed_table_host(data, sa, irank, 258, 2),
        build_bucket_table_host(data, sa, 2),
    )


def test_raw_limb_builders_agree():
    rng = np.random.default_rng(11)
    data = rng.integers(1, 256, size=3000, dtype=np.uint8)
    data[::53] = 0x0A
    data[::89] = 0xFF
    n = data.size
    sa = suffix_array_numpy(data)
    N = _pad_len(n + 64)
    text = np.zeros(N, dtype=np.uint8)
    text[:n] = data
    sa_pad = np.zeros(N, dtype=np.int32)
    sa_pad[:n] = sa
    sa_pad[n:] = np.arange(N - 1, n - 1, -1)
    for depth in (2, 3):
        for k in (1, 3):
            host = build_raw_limbs_host(data, sa, k, depth)
            dev = np.asarray(
                build_raw_limbs_device(
                    jnp.asarray(text), n, jnp.asarray(sa_pad), k, depth
                )
            ).reshape(k, N)
            assert np.array_equal(dev[:, :n], host)


def test_device_index_kind_selection_and_fallback():
    """Limb-kind routing: small alphabets (with or without NUL bytes) take
    rank-packed limbs, big NUL-free alphabets raw 4-byte packing, big
    alphabets containing NUL the base-258 digit fallback — and every kind
    must produce brute-force-exact counts, both load modes."""
    from pysubstringsearch_jax.container import Chunk
    from pysubstringsearch_jax.models.index import DeviceIndex

    rng = np.random.default_rng(3)
    clean = rng.integers(97, 123, size=4000, dtype=np.uint8)
    clean[::41] = 0x0A
    nully_small = clean.copy()
    nully_small[::97] = 0
    big = rng.integers(1, 256, size=4000, dtype=np.uint8)
    big[::41] = 0x0A
    nully_big = big.copy()
    nully_big[::97] = 0
    cases = (
        (clean, 'ranked'),
        (nully_small, 'ranked'),  # rank digits encode NUL exactly
        (big, 'raw'),
        (nully_big, 'digit'),
    )
    for body, want_kind in cases:
        chunk = Chunk(
            data=body, suffix_array=suffix_array_numpy(body)
        )
        for mode in ('upload', 'derive'):
            idx = DeviceIndex([chunk], mode=mode)
            assert idx.kind == want_kind, (mode, want_kind, idx.kind)
            pats = [
                b'a', body[10:14].tobytes(), body[100:118].tobytes(),
                b'\x00', b'q\x00z', b'', body[7:9].tobytes(),
                body[20:31].tobytes(),
            ]
            packed, lengths = pack_patterns(pats)
            lo, cnt = idx.probe(packed, lengths)
            expected = brute_counts(body.tobytes(), pats)
            np.testing.assert_array_equal(cnt[0], expected)


@pytest.mark.parametrize('sigma_hi', [110, 123])  # bits 5 and 6
def test_ranked_limbs_match_brute_force(sigma_hi):
    """Rank-packed limbs (5/6-bit digits, 6/5 bytes per int32): brute-force
    parity including NUL text bytes, absent-byte patterns at collision
    positions, and every phase-count boundary."""
    from pysubstringsearch_jax.ops.search import (
        build_ranked_limbs_device,
        build_ranked_limbs_host,
        ranked_bits,
        ranked_cover_bytes,
    )

    rng = np.random.default_rng(sigma_hi)
    data = rng.integers(97, sigma_hi, size=3500, dtype=np.uint8)
    data[::41] = 0x0A
    data[::97] = 0x00  # NUL text bytes: ranked limbs must stay exact
    n = data.size
    n_pad = _pad_len(n + PAD_MARGIN)
    text = np.zeros(n_pad, dtype=np.uint8)
    text[:n] = data
    sa = np.zeros(n_pad, dtype=np.int32)
    sa[:n] = suffix_array_numpy(data)
    pres = np.bincount(data, minlength=256)[:256] > 0
    rank, sigma = alphabet_rank(pres)
    bits = ranked_bits(sigma)
    assert bits is not None
    base, depth = pick_table_params(sigma, n)
    table = build_seed_table_host(data, sa[:n], rank, base, depth)
    K = 2
    host_l = build_ranked_limbs_host(data, sa[:n], rank, K, depth, bits)
    dev_l = np.asarray(
        build_ranked_limbs_device(
            jnp.asarray(text), n, jnp.asarray(sa), jnp.asarray(rank),
            K, depth, bits,
        )
    ).reshape(K, n_pad)
    assert np.array_equal(dev_l[:, :n], host_l)
    limbs = pad_limbs_host(host_l, n_pad)
    cover = ranked_cover_bytes(K, depth, bits)
    pats = [b'', data[:1].tobytes(), b'\x00', data[40:42].tobytes()]
    for l in range(1, cover + 3):
        i = int(rng.integers(0, n - l))
        pats.append(data[i : i + l].tobytes())
    # Absent-byte patterns at several positions (rank-collision cases).
    absent = next(b for b in range(97, 256) if not pres[b])
    pref = data[100:112].tobytes()
    pats += [
        bytes([absent]), pref[:3] + bytes([absent]),
        pref[:depth] + bytes([absent]), pref[:depth + 2] + bytes([absent]),
        pref[: depth + 7] + bytes([absent]) + pref[:2],
        pref + bytes([absent]) + pref,  # absent byte beyond cover (deep)
    ]
    packed, lengths = pack_patterns(pats)
    expected = brute_counts(data.tobytes(), pats)
    lo, cnt = probe_bounds_phased(
        jnp.asarray(text), jnp.int32(n), jnp.asarray(sa),
        jnp.asarray(table), jnp.asarray(limbs), jnp.asarray(rank),
        jnp.asarray(pres.astype(np.int32)), jnp.asarray(packed),
        jnp.asarray(lengths), K, packed.shape[1] > cover, bits,
    )
    np.testing.assert_array_equal(np.asarray(cnt), expected)
    lo_p, _ = probe_bounds(
        jnp.asarray(text), jnp.int32(n), jnp.asarray(sa),
        jnp.asarray(packed), jnp.asarray(lengths)
    )
    hit = expected > 0
    np.testing.assert_array_equal(np.asarray(lo)[hit], np.asarray(lo_p)[hit])


def test_phased_empty_chunk():
    n_pad = 64
    text = jnp.zeros((n_pad,), jnp.uint8)
    sa = jnp.zeros((n_pad,), jnp.int32)
    table = jnp.zeros((258 * 258 + 1,), jnp.int32)
    limbs = jnp.zeros((n_pad * RAW_LIMBS,), jnp.int32)
    packed, lengths = pack_patterns([b'x', b''])
    rank, pres = identity_rank()
    lo, cnt = probe_bounds_phased(
        text, jnp.int32(0), sa, table, limbs, jnp.asarray(rank),
        jnp.asarray(pres), jnp.asarray(packed),
        jnp.asarray(lengths), RAW_LIMBS, False,
    )
    assert not np.asarray(cnt).any()


