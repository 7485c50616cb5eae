"""LineTable: vectorized batch extraction vs the per-query reference path."""

import numpy as np

from pysubstringsearch_jax.ops.extract import LineTable
from pysubstringsearch_jax.ops.suffix_array import suffix_array_numpy


def _make_chunk(seed, nlines=200):
    rng = np.random.default_rng(seed)
    words = [
        bytes(rng.integers(97, 102, size=int(l), dtype=np.uint8))
        for l in rng.integers(2, 6, size=30)
    ]
    body = b''.join(
        b' '.join(words[i] for i in rng.integers(0, 30, size=3)) + b'\n'
        for _ in range(nlines)
    )
    data = np.frombuffer(body, dtype=np.uint8)
    return data, suffix_array_numpy(data)


def test_batch_matches_per_query():
    data, sa = _make_chunk(7)
    table = LineTable(data)
    rng = np.random.default_rng(8)
    B = 64
    lo = rng.integers(0, data.size - 1, size=B).astype(np.int64)
    cnt = rng.integers(0, 50, size=B).astype(np.int64)
    cnt = np.minimum(cnt, data.size - lo)
    cnt[::7] = 0  # plenty of empty queries
    batch = table.extract_lines_batch(sa, lo, cnt)
    for b in range(B):
        expected = table.extract_unique_lines(sa[lo[b] : lo[b] + cnt[b]])
        got = batch.get(b, [])
        assert got == expected, b


def test_batch_empty():
    data, sa = _make_chunk(9)
    table = LineTable(data)
    assert table.extract_lines_batch(
        sa, np.zeros(5, np.int64), np.zeros(5, np.int64)
    ) == {}


def test_batch_full_range():
    data, sa = _make_chunk(10, nlines=20)
    table = LineTable(data)
    # Query 0 matches everything (empty-pattern shape), query 1 one hit.
    lo = np.array([0, 5], dtype=np.int64)
    cnt = np.array([data.size, 1], dtype=np.int64)
    batch = table.extract_lines_batch(sa, lo, cnt)
    assert len(batch[0]) == table.num_lines
    assert batch[1] == table.extract_unique_lines(sa[5:6])
