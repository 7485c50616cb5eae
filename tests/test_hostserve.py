"""Unit tests for the native host-serving pipeline (ops/hostserve.py).

The Reader-level conformance suite exercises HostServing end-to-end; these
pin the pipeline's own contract directly against a python oracle,
including the byte-level quirks the reference implies:

- dedup by line-start offset, a line once per chunk it matches in
  (reference src/lib.rs:271-277);
- a position ON a newline belongs to the line that terminator ends
  (forward-scan-from-self, src/lib.rs:265-267);
- a foreign container whose chunk text lacks a trailing newline truncates
  the final line's last byte (``None => data.len() - 1``,
  src/lib.rs:268-270);
- the empty pattern matches every line (lower bound 0, count n);
- miss fast path returns without touching extraction.
"""

import os

import numpy as np
import pytest

import pysubstringsearch_jax as pss
from pysubstringsearch_jax import container
from pysubstringsearch_jax.ops import native as native_ops
from pysubstringsearch_jax.ops.hostserve import HostServing
from pysubstringsearch_jax.ops.suffix_array import suffix_array_numpy

pytestmark = pytest.mark.skipif(
    not native_ops.available(),
    reason='native kernels unavailable',
)


def _container_from_bodies(tmp_path, bodies):
    """Write a container with one chunk per body (bypassing the Writer so
    bodies may omit the trailing newline — the foreign-container case)."""
    path = os.path.join(tmp_path, 'hs.idx')
    with open(path, 'wb') as f:
        for body in bodies:
            data = np.frombuffer(body, dtype=np.uint8)
            container.write_chunk(f, data, suffix_array_numpy(data))
    return container.read_container(path)


def _oracle(bodies, pat: bytes):
    """Expected result multiset: per chunk, each line containing pat once,
    with the reference's final-line truncation quirk."""
    out = []
    for body in bodies:
        lines = []
        if body.endswith(b'\n'):
            raw = body[:-1].split(b'\n') if body else []
        else:
            # virtual terminator at n-1: final line loses its last byte
            raw = body.split(b'\n')
            raw[-1] = raw[-1][:-1]
        start = 0
        for ln in raw:
            lines.append(ln)
        seen = []
        for ln in lines:
            hay = ln if pat else ln  # empty pattern: matches every line
            if (pat in ln) if pat else True:
                seen.append(ln.decode('utf-8', errors='surrogateescape'))
        out.extend(seen)
    return out


def _hs(cont):
    hs = HostServing.maybe(cont.chunks, cont.buf)
    assert hs is not None
    return hs


def test_basic_dedup_and_order(tmp_path):
    bodies = [b'one two\ntwo three\nthree one one\n', b'two one\nfour\n']
    cont = _container_from_bodies(tmp_path, bodies)
    hs = _hs(cont)
    got = hs.search([b'one'])[0]
    # dedup: 'three one one' appears once; per-chunk order ascending
    assert got == ['one two', 'three one one', 'two one']
    assert sorted(got) == sorted(_oracle(bodies, b'one'))


def test_position_on_newline_pattern(tmp_path):
    bodies = [b'alpha\nbeta\ngamma\n']
    cont = _container_from_bodies(tmp_path, bodies)
    hs = _hs(cont)
    # pattern containing '\n' spans two lines; the reference's forward scan
    # attributes the match to the line the first newline ENDS.
    got = hs.search([b'a\nbeta'])[0]
    assert got == ['alpha']


def test_foreign_container_truncates_final_line(tmp_path):
    bodies = [b'first\nsecond']  # no trailing newline
    cont = _container_from_bodies(tmp_path, bodies)
    hs = _hs(cont)
    got = hs.search([b'seco'])[0]
    assert got == ['secon']  # last byte truncated (reference quirk)
    # and the first line is unaffected
    assert hs.search([b'first'])[0] == ['first']


def test_empty_pattern_matches_every_line(tmp_path):
    bodies = [b'aa\nbb\n', b'cc\n']
    cont = _container_from_bodies(tmp_path, bodies)
    hs = _hs(cont)
    got = hs.search([b''])[0]
    assert sorted(got) == ['aa', 'bb', 'cc']


def test_miss_fast_path_and_mixed_batch(tmp_path):
    bodies = [b'needle here\nplain\n']
    cont = _container_from_bodies(tmp_path, bodies)
    hs = _hs(cont)
    res = hs.search([b'zzzz', b'needle', b'qqqq'])
    assert res[0] == [] and res[2] == []
    assert res[1] == ['needle here']
    assert hs.search([b'nothing at all']) == [[]]


def test_matches_reader_on_random_corpus(tmp_path):
    rng = np.random.default_rng(123)
    words = [
        bytes(rng.integers(97, 104, size=int(l)).astype(np.uint8))
        for l in rng.integers(2, 6, size=20)
    ]
    lines = [
        b' '.join(words[i] for i in rng.integers(0, 20, size=5))
        for _ in range(3000)
    ]
    path = os.path.join(tmp_path, 'r.idx')
    w = pss.Writer(path, max_chunk_len=16 * 1024)
    for ln in lines:
        w.add_entry(ln.decode())
    w.finalize()
    cont = container.read_container(path)
    hs = _hs(cont)
    r = pss.Reader(path)
    pats = [words[0], words[5], b'zzz', words[3] + b' ' + words[7]]
    res = hs.search(pats)
    for p, got in zip(pats, res):
        assert sorted(got) == sorted(r.search(p.decode()))


def test_materialize_dedup_fast_paths():
    """Round-5 fastext fast paths: the single-group route skips the dedup
    hash (object sharing is identity-only — result values must be
    unchanged), and the ASCII direct-copy decode must fall back to the
    full UTF-8 decoder for non-ASCII spans (native/fastext.c
    decode_line)."""
    from pysubstringsearch_jax.ops import native as native_ops

    fx = native_ops.fastext()
    if fx is None:
        import pytest

        pytest.skip('native fastext unavailable')
    text = 'héllo wörld\nplain ascii line\nمرحبا يا عالم\nx' + 'y' * 40
    buf = text.encode('utf-8')
    lines = []
    off = 0
    for part in text.split('\n'):
        b = part.encode('utf-8')
        lines.append((off, off + len(b)))
        off += len(b) + 1
    starts = np.array([s for s, _ in lines] * 2, dtype=np.int64)
    ends = np.array([e for _, e in lines] * 2, dtype=np.int64)
    # Single group (G == 1): hash skipped entirely.
    g1 = fx.materialize_dedup(
        buf, starts, ends, np.array([0], np.int64),
        np.array([len(starts)], np.int64), np.array([7], np.int64),
    )
    assert list(g1) == [7]
    assert g1[7] == text.split('\n') * 2
    # Two groups sharing lines: values identical, repeats share objects.
    half = len(starts) // 2
    g2 = fx.materialize_dedup(
        buf, starts, ends, np.array([0, half], np.int64),
        np.array([half, len(starts)], np.int64), np.array([0, 1], np.int64),
    )
    assert g2[0] == g2[1] == text.split('\n')
    assert all(a is b for a, b in zip(g2[0], g2[1]))  # hash-shared objects
