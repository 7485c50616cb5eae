"""Probe-kernel agreement tests: the digit-limb fallback path (chunks
containing NUL bytes) and the plain bisection must both match brute-force
suffix counting on adversarial data (NUL bytes, high bytes, empty and
over-long patterns).  The phased raw-limb production path has its own module
(test_phased.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from pysubstringsearch_jax.ops.search import (
    KEY_LIMBS,
    PAD_MARGIN,
    build_bucket_table,
    build_bucket_table_host,
    build_limbs_host,
    key_cover_bytes,
    limbs_loop_batch_jit,
    pack_patterns,
    pad_limbs_host,
    probe_bounds,
    probe_bounds_limbs_loop,
)
from pysubstringsearch_jax.ops.suffix_array import suffix_array_numpy, _pad_len


def brute_counts(data: bytes, patterns):
    out = []
    for p in patterns:
        if len(p) == 0:
            out.append(len(data))
            continue
        out.append(sum(1 for i in range(len(data)) if data[i : i + len(p)] == p))
    return np.array(out, dtype=np.int32)


def device_args(data: bytes):
    n = len(data)
    n_pad = _pad_len(n + PAD_MARGIN)
    text = np.zeros(n_pad, dtype=np.uint8)
    text[:n] = np.frombuffer(data, dtype=np.uint8)
    sa = np.zeros(n_pad, dtype=np.int32)
    sa[:n] = suffix_array_numpy(text[:n])
    return jnp.asarray(text), jnp.int32(n), jnp.asarray(sa)


CORPORA = [
    b'banana banana band ana nab\n',
    bytes(np.random.default_rng(0).integers(0, 256, 2000, dtype=np.uint8)),
    bytes(np.random.default_rng(1).integers(97, 100, 3000, dtype=np.uint8)),
    b'\x00\x01\x00\x00\x02\x00\x01\x00' * 50,
    b'aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa',
]


def sample_patterns(data: bytes, seed: int):
    rng = np.random.default_rng(seed)
    pats = [b'', b'\x00', b'\xff', data[:1], data[-1:]]
    for _ in range(40):
        if len(data) < 3:
            break
        i = int(rng.integers(0, len(data) - 1))
        l = int(rng.integers(1, min(20, len(data) - i) + 1))
        pats.append(data[i : i + l])
    if len(data) < 900:
        # Longer than any suffix but still within the device-window
        # contract (L <= PAD_MARGIN); beyond it the API uses the host path.
        pats.append(data + b'x')
    pats.append(bytes(rng.integers(0, 256, 5, dtype=np.uint8)))
    return pats


@pytest.mark.parametrize('ci', range(len(CORPORA)))
def test_plain_and_limb_loop_match_brute_force(ci):
    data = CORPORA[ci]
    text, n, sa = device_args(data)
    pats = sample_patterns(data, ci)
    packed, lengths = pack_patterns(pats)
    expected = brute_counts(data, pats)

    lo_p, cnt_p = probe_bounds(text, n, sa, jnp.asarray(packed), jnp.asarray(lengths))
    np.testing.assert_array_equal(np.asarray(cnt_p), expected)

    table = build_bucket_table(text, n, sa)
    # Host and device table builders must agree exactly.
    host_table = build_bucket_table_host(
        np.frombuffer(data, dtype=np.uint8),
        np.asarray(sa)[: len(data)],
    )
    np.testing.assert_array_equal(np.asarray(table), host_table)

    # Digit-limb probe (production path for NUL-containing chunks), with
    # and without deep refinement.
    limbs = build_limbs_host(
        np.frombuffer(data, dtype=np.uint8), np.asarray(sa)[: len(data)]
    )
    limbs_pad = pad_limbs_host(limbs, text.shape[0])
    deep = packed.shape[1] > key_cover_bytes()
    lo_l, cnt_l = probe_bounds_limbs_loop(
        text, n, sa, table, jnp.asarray(limbs_pad),
        jnp.asarray(packed), jnp.asarray(lengths), deep,
    )
    np.testing.assert_array_equal(np.asarray(cnt_l), expected)
    np.testing.assert_array_equal(np.asarray(lo_l), np.asarray(lo_p))
    # Force the deep phase even when keys would suffice: must still agree.
    lo_d, cnt_d = probe_bounds_limbs_loop(
        text, n, sa, table, jnp.asarray(limbs_pad),
        jnp.asarray(packed), jnp.asarray(lengths), True,
    )
    np.testing.assert_array_equal(np.asarray(cnt_d), expected)
    np.testing.assert_array_equal(np.asarray(lo_d), np.asarray(lo_p))


def test_depth3_bucket_table_probe():
    """The 3-byte bucket table (used for large chunks) must seed the digit
    probe to the same results as the 2-byte table, including patterns
    shorter than the bucket depth (their pad digits hit empty buckets whose
    boundaries collapse to the exact answer)."""
    data = CORPORA[1] + b'\x00\xff' + CORPORA[0]
    text, n, sa = device_args(data)
    pats = sample_patterns(data, 9) + [b'a', b'\x00', b'ba', b'']
    packed, lengths = pack_patterns(pats)
    expected = brute_counts(data, pats)
    table3 = build_bucket_table_host(
        np.frombuffer(data, dtype=np.uint8), np.asarray(sa)[: len(data)], 3
    )
    dev3 = build_bucket_table(text, n, sa, 3)
    np.testing.assert_array_equal(np.asarray(dev3), table3)
    lo_p, cnt_p = probe_bounds(
        text, n, sa, jnp.asarray(packed), jnp.asarray(lengths)
    )
    limbs = build_limbs_host(
        np.frombuffer(data, dtype=np.uint8), np.asarray(sa)[: len(data)]
    )
    limbs_pad = pad_limbs_host(limbs, text.shape[0])
    deep = packed.shape[1] > key_cover_bytes()
    lo_l, cnt_l = probe_bounds_limbs_loop(
        text, n, sa, jnp.asarray(table3), jnp.asarray(limbs_pad),
        jnp.asarray(packed), jnp.asarray(lengths), deep,
    )
    np.testing.assert_array_equal(np.asarray(cnt_l), expected)
    np.testing.assert_array_equal(np.asarray(lo_l), np.asarray(lo_p))


@pytest.mark.parametrize('width', [8, 11, 14, 17])
def test_limb_probe_truncated_gather_widths(width):
    """Each packed pattern width L maps to a static k_used = ceil((L-2)/3);
    sweep the exact boundaries so every truncation level is exercised."""
    data = CORPORA[1]
    text, n, sa = device_args(data)
    rng = np.random.default_rng(width)
    pats = []
    for _ in range(24):
        i = int(rng.integers(0, len(data) - width))
        pats.append(data[i : i + int(rng.integers(1, width + 1))])
    packed, lengths = pack_patterns(pats, max_len=width)
    assert packed.shape[1] == width
    expected = brute_counts(data, pats)
    table = build_bucket_table(text, n, sa)
    limbs = build_limbs_host(
        np.frombuffer(data, dtype=np.uint8), np.asarray(sa)[: len(data)]
    )
    limbs_pad = pad_limbs_host(limbs, text.shape[0])
    lo, cnt = probe_bounds_limbs_loop(
        text, n, sa, table, jnp.asarray(limbs_pad),
        jnp.asarray(packed), jnp.asarray(lengths), False,
    )
    np.testing.assert_array_equal(np.asarray(cnt), expected)


def test_device_index_derive_matches_upload():
    """'derive' mode (text-only upload, SA/limbs/tables rebuilt on device)
    must be state- and result-identical to 'upload' mode."""
    from pysubstringsearch_jax.container import Chunk
    from pysubstringsearch_jax.models.index import DeviceIndex
    from pysubstringsearch_jax.ops.search import pack_patterns

    rng = np.random.default_rng(23)
    chunks = []
    for size in (5000, 3000):
        words = [
            bytes(rng.integers(97, 105, size=5, dtype=np.uint8).tobytes())
            for _ in range(40)
        ]
        body = b''
        while len(body) < size:
            body += b' '.join(
                words[i] for i in rng.integers(0, 40, size=4)
            ) + b'\n'
        data = np.frombuffer(body, dtype=np.uint8)
        chunks.append(Chunk(data=data, suffix_array=suffix_array_numpy(data)))

    up = DeviceIndex(chunks, mode='upload')
    dv = DeviceIndex(chunks, mode='derive', merge=False)
    for i, c in enumerate(chunks):
        n = c.data.size
        assert np.array_equal(
            np.asarray(up.sa)[i, :n], np.asarray(dv.sa)[i, :n]
        )
    assert np.array_equal(np.asarray(up.tables), np.asarray(dv.tables))
    assert np.array_equal(np.asarray(up.limbs), np.asarray(dv.limbs))

    pats = [b'a', b'ab', words[0], b'zzz', b'', words[1][:3] + b' ']
    packed, lengths = pack_patterns(pats)
    lo_u, cnt_u = up.probe(packed, lengths)
    lo_d, cnt_d = dv.probe(packed, lengths)
    assert np.array_equal(lo_u, lo_d)
    assert np.array_equal(cnt_u, cnt_d)


def test_device_table_and_limbs_match_host():
    """Device scatter-min bucket table and rolled-digit limb builder equal
    their host (numpy) twins on adversarial bytes (0x00, 0xff, newlines)."""
    from pysubstringsearch_jax.ops.search import (
        build_bucket_table_device,
        build_bucket_table_host,
        build_limbs_device,
        build_limbs_host,
    )

    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=3000, dtype=np.uint8)
    data[::97] = 0
    data[::89] = 255
    data[::53] = 0x0A
    n = data.size
    sa = suffix_array_numpy(data)
    N = _pad_len(n + 64)
    text = np.zeros(N, dtype=np.uint8)
    text[:n] = data
    sa_pad = np.zeros(N, dtype=np.int32)
    sa_pad[:n] = sa
    # pad slots carry pad positions (as the derive path produces them)
    sa_pad[n:] = np.arange(N - 1, n - 1, -1)
    for depth in (2, 3):
        host = build_bucket_table_host(data, sa, depth)
        dev = np.asarray(
            build_bucket_table_device(
                jnp.asarray(text), n, jnp.asarray(sa_pad), depth
            )
        )
        assert np.array_equal(dev, host)
    for k in (1, 5):
        host_l = build_limbs_host(data, sa, k)  # [k, n] plane-major
        dev_l = np.asarray(
            build_limbs_device(jnp.asarray(text), n, jnp.asarray(sa_pad), k)
        ).reshape(k, N)
        assert np.array_equal(dev_l[:, :n], host_l)
        assert not dev_l[:, n:].any()


def test_loop_probe_jit_batch():
    """The jitted chunk-vmapped digit-limb probe must satisfy brute force on
    a stacked single-chunk batch, deep on and off."""
    rng = np.random.default_rng(31)
    data = rng.integers(97, 103, size=4000, dtype=np.uint8)
    data[::41] = 0x0A
    n = data.size
    sa = suffix_array_numpy(data)
    N = _pad_len(n + 64)
    text = np.zeros((1, N), np.uint8)
    text[0, :n] = data
    sa_p = np.zeros((1, N), np.int32)
    sa_p[0, :n] = sa
    table = build_bucket_table_host(data, sa, 2)[None]
    limbs = pad_limbs_host(build_limbs_host(data, sa, 5), N)[None]
    ns = np.array([n], np.int32)
    # include long patterns to exercise the deep path
    pats = [b'a', b'ab', b'abcabc', b'\n', b'', data[100:130].tobytes()]
    packed, lengths = pack_patterns(pats)
    deep = packed.shape[1] > key_cover_bytes()
    lo_l, cnt_l = limbs_loop_batch_jit(deep, 5)(
        text, ns, sa_p, table, limbs, packed, lengths
    )
    for b, pat in enumerate(pats):
        want = sum(
            1 for i in range(n) if data.tobytes()[i:].startswith(pat)
        ) if pat else n
        assert int(np.asarray(cnt_l)[0, b]) == want, pat
