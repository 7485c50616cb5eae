"""Differential tests for the Writer's bulk file-lines ingest fast path.

The fast path (api.Writer._ingest_segment) must produce byte-identical
containers to the reference's per-line semantics (reference src/lib.rs:67-86:
strip the ``\\n`` terminator and a preceding ``\\r``, no too-big guard,
oversized lines grow the Vec capacity permanently).
"""

import os
import tempfile

import numpy as np
import pytest

import pysubstringsearch_jax as pss
from pysubstringsearch_jax import container


def _build_reference_semantics(path: str, raw: bytes, max_chunk_len):
    """The slow per-line loop, written exactly to the reference semantics."""
    out = path + '.ref'
    w = pss.Writer(out, max_chunk_len=max_chunk_len, build_workers=0)
    lines = raw.split(b'\n') if raw else []
    trailing = raw.endswith(b'\n')
    if trailing:
        lines = lines[:-1]
    for i, line in enumerate(lines):
        if i == len(lines) - 1 and not trailing:
            pass  # final unterminated line: no \r strip
        elif line.endswith(b'\r'):
            line = line[:-1]
        if w._buffer.would_overflow(len(line)):
            w.dump_data()
        w._buffer.append(line)
    w.finalize()
    w.close()
    with open(out, 'rb') as f:
        return f.read()


def _build_fast(path: str, raw: bytes, max_chunk_len):
    src = path + '.txt'
    with open(src, 'wb') as f:
        f.write(raw)
    w = pss.Writer(path, max_chunk_len=max_chunk_len, build_workers=0)
    w.add_entries_from_file_lines(src)
    w.finalize()
    w.close()
    with open(path, 'rb') as f:
        return f.read()


CASES = []
rng = np.random.default_rng(42)
words = [bytes(rng.integers(97, 123, size=int(l)).astype(np.uint8))
         for l in rng.integers(1, 9, size=64)]


def _corpus(nlines, seed, crlf_every=0, trailing=True):
    r = np.random.default_rng(seed)
    lines = []
    for i in range(nlines):
        line = b' '.join(words[j] for j in r.integers(0, 64, size=int(r.integers(1, 6))))
        if crlf_every and i % crlf_every == 0:
            line += b'\r'
        lines.append(line)
    raw = b'\n'.join(lines)
    if trailing:
        raw += b'\n'
    return raw


@pytest.mark.parametrize('case', [
    ('lf-multichunk', _corpus(4000, 0), 4096),
    ('lf-singlechunk', _corpus(100, 1), 1 << 20),
    ('crlf-mixed', _corpus(2000, 2, crlf_every=3), 4096),
    ('no-trailing-newline', _corpus(500, 3, trailing=False), 4096),
    ('no-trailing-cr', _corpus(10, 4, trailing=False) + b'\r', 4096),
    ('oversized-line', _corpus(50, 5) + b'x' * 9000 + b'\n' + _corpus(50, 6), 4096),
    ('oversized-first', b'y' * 9000 + b'\n' + _corpus(200, 7), 4096),
    ('exact-fit', b'a' * 4095 + b'\n' + b'b' * 4095 + b'\n', 4096),
    ('empty-lines', b'\n\n\n' + _corpus(20, 8) + b'\n\n', 4096),
    ('empty-file', b'', 4096),
], ids=lambda c: c[0])
def test_fast_ingest_matches_reference_semantics(case, tmp_path):
    name, raw, cap = case
    path = os.path.join(str(tmp_path), 'f.idx')
    fast = _build_fast(path, raw, cap)
    ref = _build_reference_semantics(path, raw, cap)
    assert fast == ref


def test_fast_ingest_spanning_read_blocks(tmp_path, monkeypatch):
    """Lines spanning the ingest read-block boundary reassemble exactly."""
    monkeypatch.setattr(pss.Writer, '_INGEST_BLOCK', 97)  # tiny blocks
    raw = _corpus(300, 9, crlf_every=7)
    path = os.path.join(str(tmp_path), 'g.idx')
    fast = _build_fast(path, raw, 1024)
    ref = _build_reference_semantics(path, raw, 1024)
    assert fast == ref


def test_fast_ingest_roundtrip_chunks(tmp_path):
    """Chunks parsed back match a straight re-join of the input lines."""
    raw = _corpus(1000, 10)
    path = os.path.join(str(tmp_path), 'h.idx')
    _build_fast(path, raw, 8192)
    chunks = container.read_chunks(path)
    joined = b''.join(c.data.tobytes() for c in chunks)
    assert joined == raw
    for c in chunks:
        assert c.data.size <= 8192
