"""Merged-row derive geometry: container chunks concatenated into probe rows.

The container's chunking is a build/IO artifact; in derive mode the
DeviceIndex concatenates chunks into merged rows and derives the merged SA on
device (models/index.py).  These tests pin:

- grouping under a merge cap;
- exact counts via count_matches (merged probe minus boundary crossings),
  including patterns containing ``\\n`` that DO cross chunk boundaries;
- end-to-end Reader results (all three extraction routes) against a
  pure-python ground truth;
- the native host probe_batch against the python bisection oracle.
"""

import os
import tempfile

import numpy as np
import pytest

import pysubstringsearch_jax as pss
from pysubstringsearch_jax.container import Chunk
from pysubstringsearch_jax.models.index import DeviceIndex
from pysubstringsearch_jax.ops import native as native_ops
from pysubstringsearch_jax.ops import search as search_ops
from pysubstringsearch_jax.ops.search import pack_patterns
from pysubstringsearch_jax.ops.suffix_array import suffix_array_numpy


def _mk_chunks(bodies):
    out = []
    for body in bodies:
        data = np.frombuffer(body, dtype=np.uint8)
        out.append(Chunk(data=data, suffix_array=suffix_array_numpy(data)))
    return out


def _count_occurrences(haystack: bytes, needle: bytes) -> int:
    if not needle:
        # Matches the SA semantics: every one of the n suffixes matches the
        # empty pattern (reference lower/upper bounds: 0 / n).
        return len(haystack)
    n, i = 0, haystack.find(needle)
    while i != -1:
        n += 1
        i = haystack.find(needle, i + 1)
    return n


RNG = np.random.default_rng(77)
WORDS = [bytes(RNG.integers(97, 107, size=int(l)).astype(np.uint8))
         for l in RNG.integers(3, 8, size=30)]


def _body(nlines, seed):
    r = np.random.default_rng(seed)
    lines = [b' '.join(WORDS[i] for i in r.integers(0, 30, size=4))
             for _ in range(nlines)]
    return b'\n'.join(lines) + b'\n'


def test_grouping_respects_cap(monkeypatch):
    monkeypatch.setenv('PSS_MERGE_CAP', '9000')
    chunks = _mk_chunks([_body(40, i) for i in range(5)])
    idx = DeviceIndex(chunks, mode='derive')
    assert idx.merged
    assert sum(len(g) for g in idx.groups) == 5
    for r, g in enumerate(idx.groups):
        assert idx.row_data[r].size == sum(chunks[i].data.size for i in g)
        assert idx.row_data[r].size <= max(
            9000, max(chunks[i].data.size for i in g)
        )
    # row text is the exact concatenation
    flat = b''.join(c.data.tobytes() for c in chunks)
    rows = b''.join(d.tobytes() for d in idx.row_data)
    assert rows == flat


def test_merged_counts_match_per_chunk_truth():
    chunks = _mk_chunks([_body(60, 1), _body(60, 2), _body(60, 3)])
    idx = DeviceIndex(chunks, mode='derive', merge=True)
    assert idx.merged and idx.num_chunks == 1
    pats = [WORDS[0], WORDS[1][:2], b'zz', b'', WORDS[2] + b' ' + WORDS[3]]
    packed, lengths = pack_patterns(pats)
    cnt = idx.count_matches(packed, lengths)
    for b, p in enumerate(pats):
        want = sum(_count_occurrences(c.data.tobytes(), p) for c in chunks)
        assert cnt[:, b].sum() == want, p


def test_boundary_crossing_newline_patterns():
    """A pattern containing \\n that straddles a chunk boundary must not be
    counted (the reference never matches across chunks)."""
    a = b'alpha\nbravo\n'
    b_ = b'bravo\ncharlie\n'
    chunks = _mk_chunks([a, b_])
    idx = DeviceIndex(chunks, mode='derive', merge=True)
    assert idx.merged
    # 'bravo\nbravo' occurs ONLY across the boundary in the merged text.
    pats = [b'bravo\nbravo', b'alpha\nbravo', b'bravo\ncharlie', b'bravo']
    packed, lengths = pack_patterns(pats)
    lo, raw = idx.probe(packed, lengths)
    cnt = idx.count_matches(packed, lengths)
    merged = (a + b_)
    # raw merged counts see the crossing occurrence...
    assert raw[0, 0] == _count_occurrences(merged, pats[0]) == 1
    # ...exact counts do not; within-chunk newline patterns survive.
    want = [0, 1, 1, 2]
    for b2, p in enumerate(pats):
        assert cnt[0, b2] == want[b2], p


def test_multi_boundary_crossing_attributed_once():
    """An occurrence spanning several tiny chunks is subtracted exactly once."""
    chunks = _mk_chunks([b'x\n', b'y\n', b'z\n'])
    idx = DeviceIndex(chunks, mode='derive', merge=True)
    pats = [b'x\ny\nz', b'x\ny', b'y\nz', b'\n']
    packed, lengths = pack_patterns(pats)
    cnt = idx.count_matches(packed, lengths)
    assert list(cnt[0]) == [0, 0, 0, 3]


def _reader_for(tmp, bodies, index_mode='derive'):
    path = os.path.join(tmp, 'm.idx')
    with open(path, 'wb') as f:
        for body in bodies:
            data = np.frombuffer(body, dtype=np.uint8)
            from pysubstringsearch_jax import container as cont
            cont.write_chunk(f, data, suffix_array_numpy(data))
    return pss.Reader(path, index_mode=index_mode)


@pytest.mark.parametrize('route', ['device', 'host'])
def test_reader_merged_end_to_end(route, tmp_path, monkeypatch):
    """search()/search_multiple() over a merged derive index match ground
    truth through both extraction routes."""
    # Pin the extraction route: the per-hit cost of the device route's
    # line extraction decides it (Reader._host_route_cheaper).
    monkeypatch.setattr(pss.api.Reader, '_DEVICE_ROUTE_HIT_S',
                        1.0 if route == 'host' else 0.0)
    if route == 'host':
        if not native_ops.available():
            pytest.skip('native probe_batch unavailable')
    bodies = [_body(80, 11), _body(80, 12), _body(80, 13)]
    r = _reader_for(str(tmp_path), bodies)
    assert r._index.merged
    all_lines = []
    for body in bodies:
        all_lines.extend(l.decode() for l in body.split(b'\n')[:-1])
    pats = [WORDS[0].decode(), WORDS[5].decode()[:2], 'zz', '',
            (WORDS[2] + b' ' + WORDS[3]).decode()]
    for p in pats:
        got = sorted(r.search(p))
        want = sorted(l for l in all_lines if p in l)
        assert got == want, p
    multi = r.search_multiple(pats)
    assert len(multi) == sum(
        sum(p in l for l in all_lines) for p in [pats[0], pats[1]]
    ) + 0 + len(all_lines) + sum(pats[4] in l for l in all_lines)


@pytest.mark.parametrize('hit_s', [0.0, 1.0], ids=['device', 'host'])
def test_reader_merged_newline_pattern_routes(hit_s, tmp_path, monkeypatch):
    """Both extraction routes agree on \\n-containing patterns: the device
    flat-gather drops boundary-crossing occurrences by position, the host
    pipeline never sees them."""
    monkeypatch.setattr(pss.api.Reader, '_DEVICE_ROUTE_HIT_S', hit_s)
    r = _reader_for(str(tmp_path), [b'alpha\nbravo\n', b'bravo\ncharlie\n'])
    assert r._index.merged
    before = r.profiler.counts.get('x-dev-gather', 0)
    assert r.search('bravo\nbravo') == []
    assert sorted(r.search('alpha\nbravo')) == ['alpha']
    assert sorted(r.search_multiple(['a\nb', 'o\nc', 'o\nb'])) == [
        'alpha', 'bravo']
    used = r.profiler.counts.get('x-dev-gather', 0) > before
    assert used == (hit_s == 0.0)


def test_reader_merged_newline_pattern_end_to_end(tmp_path):
    """\\n-containing patterns return only within-chunk lines... the matched
    LINE for 'bravo\\nbravo' would be ambiguous; reference semantics: the
    pattern matches inside one chunk only."""
    r = _reader_for(str(tmp_path), [b'alpha\nbravo\n', b'bravo\ncharlie\n'])
    assert r._index.merged
    assert r.search('bravo\nbravo') == []
    got = r.search('alpha\nbravo')
    assert sorted(got) == ['alpha']  # line containing the match start


def test_oversized_pattern_does_not_poison_batch(tmp_path):
    """A pattern longer than PAD_MARGIN routes to the host path while the
    rest of the batch stays on the device path."""
    bodies = [_body(50, 21), _body(50, 22)]
    r = _reader_for(str(tmp_path), bodies)
    long_pat = 'q' * (search_ops.PAD_MARGIN + 10)
    pats = [WORDS[0].decode(), long_pat, WORDS[1].decode()]
    res = r.search_multiple(pats)
    all_lines = []
    for body in bodies:
        all_lines.extend(l.decode() for l in body.split(b'\n')[:-1])
    want = sum(sum(p in l for l in all_lines) for p in pats)
    assert len(res) == want


def test_native_probe_batch_matches_python_oracle():
    if not native_ops.available():
        pytest.skip('native probe_batch unavailable')
    body = _body(200, 31)
    data = np.frombuffer(body, dtype=np.uint8)
    sa = suffix_array_numpy(data)
    pats = [WORDS[0], WORDS[1], b'', b'zzz', WORDS[2][:1], body[10:40]]
    stride = max(len(p) for p in pats)
    packed = np.zeros((len(pats), stride), dtype=np.uint8)
    lens = np.zeros(len(pats), dtype=np.int32)
    for i, p in enumerate(pats):
        packed[i, :len(p)] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
    lo, cnt = native_ops.probe_batch_native(data, sa, packed, lens)
    for i, p in enumerate(pats):
        wlo, wcnt = search_ops.host_probe_bounds(body, sa, p)
        assert (lo[i], cnt[i]) == (wlo, wcnt), p


def test_table_from_pack_matches_raw_table():
    """derive_table_from_pack_jit (one gather from the packed rank stream)
    must equal derive_table_raw_jit (re-derived digit stream) — same seed
    table both ways."""
    import jax.numpy as jnp

    chunks = _mk_chunks([_body(60, 9)])
    idx = DeviceIndex.plan(chunks)
    if idx.kind != 'ranked':
        pytest.skip('corpus not ranked-eligible')
    d = chunks[0].data
    n_pad = idx.n_pad
    row = np.zeros((n_pad,), dtype=np.uint8)
    row[: d.size] = d
    text = jnp.asarray(row)
    n = jnp.int32(d.size)
    sa_full = np.zeros((n_pad,), dtype=np.int32)
    sa_full[: d.size] = chunks[0].suffix_array
    sa = jnp.asarray(sa_full)
    rank = jnp.asarray(idx._rank_host)
    tlen = idx._base ** idx._depth + 1
    raw = search_ops.derive_table_raw_jit(idx._base, idx._depth)(
        jnp.zeros((1, tlen), jnp.int32), jnp.int32(0), text, n, sa, rank
    )
    src = search_ops.ranked_pack_jit(idx._bits)(text, n, rank)
    fp = search_ops.derive_table_from_pack_jit(
        idx._base, idx._depth, idx._bits
    )(jnp.zeros((1, tlen), jnp.int32), jnp.int32(0), src, n, sa)
    np.testing.assert_array_equal(np.asarray(raw), np.asarray(fp))
