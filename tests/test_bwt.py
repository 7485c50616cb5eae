"""BWT / inverse-BWT and integer-alphabet SA — parity with the reference
kernel's extended API surface (libsais_bwt at libsais.c:6642, libsais_unbwt
at libsais.c:7551, libsais_int at libsais.c:6612), which the reference
product never calls but the kernel exposes."""

import jax.numpy as jnp
import numpy as np
import pytest

from pysubstringsearch_jax.ops import native
from pysubstringsearch_jax.ops.bwt import (
    bwt,
    bwt_aux,
    bwt_from_sa,
    bwt_from_sa_device,
    byte_frequencies,
    unbwt,
    unbwt_aux,
    _unbwt_numpy,
)
from pysubstringsearch_jax.ops.suffix_array import (
    suffix_array_int,
    suffix_array_numpy,
)


def brute_bwt(data: bytes):
    """Oracle: rotation-BWT of data + sentinel, sentinel entry removed."""
    n = len(data)
    s = list(data) + [-1]  # -1 = sentinel, smallest
    rows = sorted(range(n + 1), key=lambda i: s[i:] + s[:i])
    col = [s[(i - 1) % (n + 1)] for i in rows]
    p = col.index(-1)
    u = bytes(c for c in col if c >= 0)
    return u, p


CASES = [
    b'banana',
    b'mississippi',
    b'a',
    b'aa',
    b'abcabcabc',
    b'one\ntwo\nthree\n',
    bytes(range(256)) * 3,
]


@pytest.mark.parametrize('data', CASES, ids=range(len(CASES)))
def test_bwt_matches_rotation_oracle(data):
    u, p = bwt(np.frombuffer(data, dtype=np.uint8))
    u_ref, p_ref = brute_bwt(data)
    assert bytes(u) == u_ref
    assert p == p_ref


@pytest.mark.parametrize('data', CASES, ids=range(len(CASES)))
def test_unbwt_round_trip_numpy(data):
    arr = np.frombuffer(data, dtype=np.uint8)
    u, p = bwt(arr)
    assert bytes(_unbwt_numpy(u, p)) == data


def test_unbwt_round_trip_random():
    rng = np.random.default_rng(7)
    for n in (2, 3, 17, 1000, 4096):
        arr = rng.integers(0, 256, size=n, dtype=np.uint8)
        u, p = bwt(arr)
        assert bytes(unbwt(u, p)) == arr.tobytes()
        assert bytes(_unbwt_numpy(u, p)) == arr.tobytes()


@pytest.mark.skipif(not native.available(), reason='no native kernel')
def test_unbwt_native_matches_numpy():
    rng = np.random.default_rng(11)
    arr = rng.integers(97, 123, size=5000, dtype=np.uint8)
    u, p = bwt(arr)
    assert native.unbwt_native(u, p).tobytes() == _unbwt_numpy(u, p).tobytes()


def test_bwt_device_matches_host():
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, size=2048, dtype=np.uint8)
    sa = suffix_array_numpy(arr)
    u_host, p_host = bwt_from_sa(arr, sa)
    u_dev, p_dev = bwt_from_sa_device(jnp.asarray(arr), jnp.asarray(sa))
    assert np.array_equal(np.asarray(u_dev), u_host)
    assert int(p_dev) == p_host


def test_bwt_empty_and_single():
    u, p = bwt(np.empty(0, dtype=np.uint8))
    assert u.size == 0 and p == 0
    u, p = bwt(np.frombuffer(b'x', dtype=np.uint8))
    assert bytes(u) == b'x' and p == 1  # libsais.c:6649-6651 returns n
    assert bytes(unbwt(u, p)) == b'x'


def test_unbwt_rejects_bad_primary_index():
    with pytest.raises(ValueError):
        unbwt(np.frombuffer(b'ab', dtype=np.uint8), 0)
    with pytest.raises(ValueError):
        unbwt(np.frombuffer(b'ab', dtype=np.uint8), 3)


def brute_sa_int(vals):
    vals = list(vals)
    return sorted(range(len(vals)), key=lambda i: vals[i:])


@pytest.mark.parametrize('backend', ['numpy', 'jax', 'native'])
def test_suffix_array_int_backends(backend):
    if backend == 'native' and not native.available():
        pytest.skip('no native kernel')
    rng = np.random.default_rng(5)
    for n, k in ((1, 1), (7, 2), (100, 3), (1000, 50), (2000, 1 << 20)):
        vals = rng.integers(0, k, size=n, dtype=np.int32)
        sa = suffix_array_int(vals, k, backend=backend)
        assert sa.tolist() == brute_sa_int(vals.tolist())


def test_suffix_array_int_validation():
    with pytest.raises(ValueError):
        suffix_array_int(np.array([-1], dtype=np.int32))
    with pytest.raises(ValueError):
        suffix_array_int(np.array([5], dtype=np.int32), k=5)
    assert suffix_array_int(np.empty(0, dtype=np.int32)).size == 0


def test_bwt_aux_indexes_match_sa_slots():
    """I[j] = 1 + SA slot of suffix j*r (reference libsais.c:4555, 5181)."""
    rng = np.random.default_rng(13)
    arr = rng.integers(97, 105, size=1000, dtype=np.uint8)
    sa = suffix_array_numpy(arr)
    slot_of = np.empty(arr.size, dtype=np.int64)
    slot_of[sa] = np.arange(arr.size)
    for r in (2, 16, 256, 1024):
        u, I = bwt_aux(arr, r)
        u_ref, p_ref = bwt(arr)
        assert np.array_equal(u, u_ref)
        assert I.size == (arr.size - 1) // r + 1
        assert int(I[0]) == p_ref
        expect = slot_of[np.arange(0, arr.size, r)] + 1
        assert np.array_equal(I.astype(np.int64), expect)


@pytest.mark.parametrize('data', CASES, ids=range(len(CASES)))
def test_bwt_aux_round_trip(data):
    arr = np.frombuffer(data, dtype=np.uint8)
    for r in (2, 8, 64):
        u, I = bwt_aux(arr, r)
        assert bytes(unbwt_aux(u, r, I)) == data


def test_unbwt_aux_r_equals_n_is_plain_unbwt():
    """libsais_unbwt delegates to unbwt_aux with r=n (libsais.c:7561-7564)."""
    rng = np.random.default_rng(17)
    arr = rng.integers(0, 256, size=4096, dtype=np.uint8)
    u, p = bwt(arr)
    out = unbwt_aux(u, arr.size, np.array([p], dtype=np.int32))
    assert np.array_equal(out, arr)


def test_bwt_aux_validation():
    arr = np.frombuffer(b'banana', dtype=np.uint8)
    with pytest.raises(ValueError):
        bwt_aux(arr, 3)  # not a power of two (libsais.c:6669)
    with pytest.raises(ValueError):
        bwt_aux(arr, 1)
    u, I = bwt_aux(arr, 2)
    with pytest.raises(ValueError):
        unbwt_aux(u, 2, I[:1])  # too few indexes
    bad = I.copy()
    bad[1] = 0
    with pytest.raises(ValueError):
        unbwt_aux(u, 2, bad)  # out of range (libsais.c:7584)
    with pytest.raises(ValueError):
        unbwt_aux(u, 3, I)
    # n <= 1 degenerate forms: I[0] must equal n (libsais.c:7577-7580).
    one = np.frombuffer(b'z', dtype=np.uint8)
    u1, I1 = bwt_aux(one, 2)
    assert I1.tolist() == [1]
    assert bytes(unbwt_aux(u1, 2, I1)) == b'z'
    with pytest.raises(ValueError):
        unbwt_aux(u1, 2, np.array([0], dtype=np.int32))


def test_byte_frequencies():
    arr = np.frombuffer(b'abracadabra', dtype=np.uint8)
    f = byte_frequencies(arr)
    assert f.sum() == arr.size and f[ord('a')] == 5 and f[ord('r')] == 2
