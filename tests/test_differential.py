"""Differential conformance vs the reference semantics.

cargo/maturin are not available in this environment, so the reference wheel
cannot be built here; instead this harness checks the package against the
reference's OBSERVABLE contract (reference tests:
tests/test_pysubstringsearch.py:11-46 use order-insensitive multiset
equality) on a randomized multi-megabyte, multi-chunk corpus:

- result multisets == pure-python ``pattern in line`` ground truth, for a
  battery of pattern shapes (exact word, shared prefix, infix, miss,
  cross-entry non-match, unicode, punctuation, empty, duplicate lines);
- Writer container bytes == the byte format specified at src/lib.rs:105-124
  (u32 LE framing, entries joined by \n, int32 LE suffix array), with the
  suffix array cross-checked between independent constructions (the SA of a
  string is unique, so byte equality of the SA section is decidable without
  running the reference);
- the ShardedReader and MultiHostReader (1-process degenerate) agree with
  the plain Reader on the same index.

A golden index file generated by the actual reference wheel would close the
byte-identity question without the SA-uniqueness argument; producing one is
genuinely impossible in this environment (no cargo/rustc/maturin, no
prebuilt wheel on the image, zero network egress — verified).  The
byte-format goldens in tests/test_container.py (hand-assembled from the
format specified at src/lib.rs:105-124) plus the SA-uniqueness argument
above are the strongest offline substitute: any correct SA construction
over the same text yields the identical byte stream, so a container that
matches the framing spec with a correct SA is byte-identical to what the
reference would write.
"""

import collections
import struct

import numpy as np
import pytest

import pysubstringsearch_jax as pss
from pysubstringsearch_jax import container
from pysubstringsearch_jax.ops.suffix_array import suffix_array_numpy


def _corpus(seed: int, nlines: int):
    """Randomized mixed-content corpus: ascii words, unicode, digits,
    punctuation, repeated runs, duplicate lines."""
    rng = np.random.default_rng(seed)
    words = [
        bytes(rng.integers(97, 123, size=int(l), dtype=np.uint8)).decode()
        for l in rng.integers(2, 11, size=400)
    ]
    extras = ['مرحبا', 'שלום', '数据', 'x' * 40, '  spaced  ', '1234.56', '']
    lines = []
    for i in range(nlines):
        parts = [words[j] for j in rng.integers(0, 400, size=int(rng.integers(1, 9)))]
        if i % 37 == 0:
            parts.append(extras[i % len(extras)])
        lines.append(' '.join(parts))
    # exact duplicate lines (dedup is per line offset, not content)
    lines += lines[:25]
    return lines, words


@pytest.fixture(scope='module')
def built_index(tmp_path_factory):
    lines, words = _corpus(3, 60_000)
    d = tmp_path_factory.mktemp('diff')
    path = str(d / 'diff.idx')
    w = pss.Writer(path, max_chunk_len=512 * 1024)  # many chunks
    for ln in lines:
        w.add_entry(ln)
    w.finalize()
    return path, lines, words


def _patterns(lines, words):
    rng = np.random.default_rng(11)
    pats = [
        words[0],                      # exact word
        words[1][:1],                  # single byte, many hits
        words[2][:3],                  # shared prefix
        'qqqqzz',                      # miss
        words[3] + ' ' + words[4],     # cross-word infix
        'مرح',                         # unicode prefix
        '数据',
        '1234.56',
        ' spaced ',
        'x' * 20,                      # inside a run
        '',                            # empty: matches every line
    ]
    # random substrings sampled from real lines
    for _ in range(25):
        ln = lines[int(rng.integers(0, len(lines)))]
        if len(ln) < 4:
            continue
        i = int(rng.integers(0, len(ln) - 2))
        l = int(rng.integers(2, min(14, len(ln) - i) + 1))
        pats.append(ln[i : i + l])
    return pats


def test_result_multisets_match_ground_truth(built_index):
    path, lines, words = built_index
    r = pss.Reader(path)
    for p in _patterns(lines, words):
        got = collections.Counter(r.search(p))
        want = collections.Counter(ln for ln in lines if p in ln)
        assert got == want, (p, len(got), len(want))


def test_search_multiple_concatenates_with_duplicates(built_index):
    path, lines, words = built_index
    r = pss.Reader(path)
    # Two patterns matching overlapping line sets: duplicates preserved
    # (reference pysubstringsearch/__init__.py:61-73 concatenates).
    pats = [words[0], words[0][:2]]
    got = collections.Counter(r.search_multiple(pats))
    want = collections.Counter()
    for p in pats:
        want.update(ln for ln in lines if p in ln)
    assert got == want


def test_cross_entry_patterns_never_match(built_index):
    path, lines, words = built_index
    r = pss.Reader(path)
    # Suffixes cross the \n terminator in the concatenated chunk, but a
    # terminator-free pattern spanning an entry boundary must not match
    # through it (reference test 'onet', test_pysubstringsearch.py:105-149
    # — the byte compare sees the \n).  Ground-truth comparison, since the
    # concatenation could legitimately occur inside some other line.
    tail = lines[0][-3:]
    head = lines[1][:3]
    for p in (tail + head, tail + ' ' + head):
        got = collections.Counter(r.search(p))
        want = collections.Counter(ln for ln in lines if p in ln)
        assert got == want, p
    # A pattern that EXPLICITLY contains the terminator byte is matched
    # against the raw concatenated buffer, exactly like the reference's
    # byte compare (src/lib.rs:219-228): the line containing each hit START
    # is returned (deduped per line).  Ground truth from the joined text.
    p = lines[0][-3:] + '\n' + lines[1][:3]
    joined = ''.join(ln + '\n' for ln in lines)
    acc = 0
    line_starts = []
    for ln in lines:
        line_starts.append(acc)
        acc += len(ln.encode()) + 1
    import bisect
    pb = p.encode()
    jb = joined.encode()
    i = jb.find(pb)
    hit_lines = set()
    while i != -1:
        hit_lines.add(bisect.bisect_right(line_starts, i) - 1)
        i = jb.find(pb, i + 1)
    want = collections.Counter(lines[k] for k in hit_lines)
    assert collections.Counter(r.search(p)) == want


def test_container_bytes_match_reference_format(built_index):
    path, lines, _ = built_index
    blob = open(path, 'rb').read()
    # Reparse by the byte-format spec (src/lib.rs:105-124) with an
    # INDEPENDENT suffix-array construction per chunk.
    off = 0
    collected = []
    while off < len(blob):
        (dlen,) = struct.unpack_from('<I', blob, off)
        off += 4
        data = blob[off : off + dlen]
        off += dlen
        (salen,) = struct.unpack_from('<I', blob, off)
        off += 4
        sa = np.frombuffer(blob[off : off + salen], dtype='<i4')
        off += salen
        assert salen == 4 * dlen
        expected_sa = suffix_array_numpy(np.frombuffer(data, dtype=np.uint8))
        np.testing.assert_array_equal(sa, expected_sa)
        assert data.endswith(b'\n')
        collected.append(data)
    assert off == len(blob)
    joined = b''.join(collected).decode('utf-8')
    assert joined == ''.join(ln + '\n' for ln in lines)


def test_sharded_and_multihost_agree_with_reader(built_index, tmp_path):
    path, lines, words = built_index
    from pysubstringsearch_jax.parallel import manifest, multihost
    from pysubstringsearch_jax.parallel.reader import ShardedReader

    r = pss.Reader(path)
    sr = ShardedReader(path)
    d = str(tmp_path / 'sharded')
    manifest.convert_index(path, d, num_shards=3)
    mh = multihost.MultiHostReader(d)
    for p in [words[0], words[5][:2], 'zzzzzz', '数据']:
        want = collections.Counter(r.search(p))
        assert collections.Counter(sr.search(p)) == want
        assert collections.Counter(mh.search(p)) == want


def test_writer_capacity_growth_quirk_parity(tmp_path):
    """Capacity-growth quirk parity (src/lib.rs:75-79): an oversized line
    ingested via add_entries_from_file_lines permanently GROWS the reference
    Writer's Vec capacity under Rust's amortized rule
    ``max(2 * cap, required, 8)`` — two reserve steps, line bytes then the
    newline push — raising the flush threshold (and add_entry's "entry is
    too big" guard, src/lib.rs:92-94) for the rest of that Writer's life.
    ChunkBuffer emulates this exactly, so chunk boundaries (container
    bytes) match the reference even after oversized lines."""
    lines = [b'short one', b'x' * 5000, b'tail entry', b'short one']
    src = tmp_path / 'in.txt'
    src.write_bytes(b'\n'.join(lines) + b'\n')
    path = str(tmp_path / 'cap.idx')
    w = pss.Writer(path, max_chunk_len=64)
    w.add_entries_from_file_lines(str(src))
    # Vec trace: extend(5000 bytes) grows 64 -> max(128, 5000) = 5000;
    # push(b'\n') grows 5000 -> max(10000, 5001) = 10000.
    assert w._buffer.capacity == 10000
    # The grown threshold also governs add_entry's too-big guard.
    w.add_entry('y' * 6000)  # would raise against the configured 64
    with pytest.raises(ValueError):
        w.add_entry('z' * 10001)
    w.finalize()
    chunks = container.read_chunks(path)
    # Chunk 1 flushed before the oversized line; the oversized line plus the
    # two following short lines fit the grown 10000-byte capacity and land
    # in ONE chunk (5001 + 11 + 10 bytes) — under the configured 64-byte
    # threshold each would have flushed separately.  The 6001-byte entry
    # overflows the grown buffer's remaining space and flushes it first.
    assert [c.data.size for c in chunks] == [10, 5022, 6001]
    r = pss.Reader(path)
    assert collections.Counter(r.search('short one')) == collections.Counter(
        ['short one', 'short one']
    )
    assert r.search('x' * 4999) == ['x' * 5000]
    assert r.search('tail') == ['tail entry']
