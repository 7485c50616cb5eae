"""End-to-end Writer -> Reader round trips, mirroring the reference's test
strategy (tests/test_pysubstringsearch.py in the reference: build an index in
a tempdir, search it, compare result multisets order-insensitively) and
additionally covering the gaps its suite leaves open (multi-chunk indexes,
file-line ingestion, explicit dump_data, empty patterns, duplicate entries).
"""

import collections
import os

import pytest

import pysubstringsearch_jax as pss


def roundtrip(tmp_path, entries, max_chunk_len=None):
    path = str(tmp_path / 'index.pss')
    writer = pss.Writer(path, max_chunk_len=max_chunk_len)
    for entry in entries:
        writer.add_entry(entry)
    writer.finalize()
    return pss.Reader(path)


def assert_search(reader, pattern, expected):
    got = reader.search(pattern)
    assert collections.Counter(got) == collections.Counter(expected), (
        f'pattern {pattern!r}: got {got}, expected {expected}'
    )


NUMBER_WORDS = [
    'zero', 'one', 'two', 'three', 'four',
    'five', 'six', 'seven', 'eight', 'nine', 'ten',
]


class TestMissingIndex:
    def test_file_not_found(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            pss.Reader(str(tmp_path / 'nope.idx'))


class TestSanity:
    def test_exact_and_infix_hits(self, tmp_path):
        reader = roundtrip(tmp_path, NUMBER_WORDS)
        assert_search(reader, 'four', ['four'])
        assert_search(reader, 'f', ['four', 'five'])
        assert_search(reader, 'our', ['four'])
        assert_search(reader, 'aaa', [])
        assert_search(reader, 'zero', ['zero'])
        # 'nine' contains 'n' twice but is deduped to one hit per line.
        assert_search(reader, 'n', ['one', 'nine', 'seven', 'ten'])

    def test_shared_prefix_miss(self, tmp_path):
        reader = roundtrip(tmp_path, NUMBER_WORDS)
        # 'nin' prefixes 'nine'; 'ninea' must not match anything.
        assert_search(reader, 'nin', ['nine'])
        assert_search(reader, 'ninea', [])

    def test_entry_boundary_not_matched(self, tmp_path):
        # Suffixes cross the \n joining entries; a pattern spanning the
        # boundary must NOT match (reference test_edgecases: 'onet').
        reader = roundtrip(tmp_path, ['one', 'two', 'three'])
        assert_search(reader, 'onet', [])
        assert_search(reader, 'etw', [])
        assert_search(reader, 'one', ['one'])

    def test_multiple_occurrences_one_line_deduped(self, tmp_path):
        reader = roundtrip(tmp_path, ['ten', 'tenten', 'xtenx'])
        assert_search(reader, 'ten', ['ten', 'tenten', 'xtenx'])

    def test_duplicate_entries_both_returned(self, tmp_path):
        # Dedup is by line offset, not content (reference src/lib.rs:274).
        reader = roundtrip(tmp_path, ['same', 'same', 'other'])
        assert_search(reader, 'same', ['same', 'same'])

    def test_short_entries_and_single_char(self, tmp_path):
        reader = roundtrip(tmp_path, ['ab'])
        assert_search(reader, 'a', ['ab'])
        assert_search(reader, 'b', ['ab'])
        assert_search(reader, 'ab', ['ab'])
        assert_search(reader, 'ba', [])

    def test_substring_with_spaces(self, tmp_path):
        reader = roundtrip(
            tmp_path,
            ['the quick brown fox', 'jumped over the lazy dog'],
        )
        assert_search(reader, 'quick brown', ['the quick brown fox'])
        assert_search(reader, 'the', ['the quick brown fox', 'jumped over the lazy dog'])
        assert_search(reader, ' over ', ['jumped over the lazy dog'])


class TestUnicode:
    ARABIC = [
        'مرحبا بالعالم',
        'مرحبا بك',
        'هذا نص عربي',
        'نص اخر',
    ]

    def test_multibyte_patterns(self, tmp_path):
        reader = roundtrip(tmp_path, self.ARABIC)
        assert_search(reader, 'مرحبا', ['مرحبا بالعالم', 'مرحبا بك'])
        assert_search(reader, 'نص', ['هذا نص عربي', 'نص اخر'])
        assert_search(reader, 'غير موجود', [])

    def test_mixed_scripts(self, tmp_path):
        reader = roundtrip(tmp_path, ['héllo wörld', 'naïve café', '日本語テキスト'])
        assert_search(reader, 'wörld', ['héllo wörld'])
        assert_search(reader, 'café', ['naïve café'])
        assert_search(reader, '日本語', ['日本語テキスト'])
        assert_search(reader, 'テキ', ['日本語テキスト'])


class TestEdgeCases:
    def test_empty_pattern_matches_every_line(self, tmp_path):
        reader = roundtrip(tmp_path, ['alpha', 'beta'])
        assert_search(reader, '', ['alpha', 'beta'])

    def test_pattern_longer_than_any_entry(self, tmp_path):
        reader = roundtrip(tmp_path, ['abc', 'abcd'])
        assert_search(reader, 'abcdefghij', [])

    def test_empty_entry(self, tmp_path):
        reader = roundtrip(tmp_path, ['', 'x'])
        assert_search(reader, 'x', ['x'])
        assert_search(reader, '', ['', 'x'])

    def test_empty_index(self, tmp_path):
        path = str(tmp_path / 'empty.idx')
        writer = pss.Writer(path)
        writer.finalize()
        reader = pss.Reader(path)
        assert reader.search('anything') == []
        assert reader.search('') == []

    def test_pattern_matching_start_and_end_of_chunk(self, tmp_path):
        reader = roundtrip(tmp_path, ['aaa', 'zzz', 'mmm'])
        assert_search(reader, 'aaa', ['aaa'])
        assert_search(reader, 'zzz', ['zzz'])

    def test_binary_ish_bytes(self, tmp_path):
        # Low/high byte values inside entries (no newline, valid UTF-8).
        reader = roundtrip(tmp_path, ['a\tb', 'a b', '\x01ctrl'])
        assert_search(reader, 'a\tb', ['a\tb'])
        assert_search(reader, '\x01', ['\x01ctrl'])


class TestMultiChunk:
    def test_small_chunks_force_many_flushes(self, tmp_path):
        # max_chunk_len so small that every entry is its own chunk.
        entries = [f'entry number {i} payload' for i in range(20)]
        reader = roundtrip(tmp_path, entries, max_chunk_len=32)
        assert_search(reader, 'entry number 7 ', ['entry number 7 payload'])
        assert_search(reader, 'payload', entries)
        assert_search(reader, 'missing', [])

    def test_same_line_in_multiple_chunks(self, tmp_path):
        # A line duplicated across chunks is returned once per chunk.
        entries = ['dup'] * 5
        reader = roundtrip(tmp_path, entries, max_chunk_len=8)
        assert_search(reader, 'dup', ['dup'] * 5)

    def test_chunk_boundary_entry_too_big(self, tmp_path):
        path = str(tmp_path / 'index.idx')
        writer = pss.Writer(path, max_chunk_len=10)
        with pytest.raises(ValueError):
            writer.add_entry('x' * 100)

    def test_explicit_dump_data(self, tmp_path):
        path = str(tmp_path / 'index.idx')
        writer = pss.Writer(path)
        writer.add_entry('first')
        writer.dump_data()
        writer.add_entry('second')
        writer.dump_data()
        writer.dump_data()  # no-op on empty buffer
        writer.finalize()
        reader = pss.Reader(path)
        assert_search(reader, 'first', ['first'])
        assert_search(reader, 'second', ['second'])
        assert_search(reader, 's', ['first', 'second'])


class TestFileLines:
    def test_add_entries_from_file_lines(self, tmp_path):
        src = tmp_path / 'input.txt'
        src.write_bytes(b'alpha\nbeta\r\ngamma\nno-terminator')
        path = str(tmp_path / 'index.idx')
        writer = pss.Writer(path)
        writer.add_entries_from_file_lines(str(src))
        writer.finalize()
        reader = pss.Reader(path)
        assert_search(reader, 'alpha', ['alpha'])
        assert_search(reader, 'beta', ['beta'])  # \r\n stripped
        assert_search(reader, 'no-terminator', ['no-terminator'])
        assert_search(reader, '\r', [])

    def test_oversized_line_becomes_own_chunk(self, tmp_path):
        src = tmp_path / 'input.txt'
        big = 'b' * 100
        src.write_text(f'small\n{big}\ntail\n')
        path = str(tmp_path / 'index.idx')
        writer = pss.Writer(path, max_chunk_len=16)
        writer.add_entries_from_file_lines(str(src))
        writer.finalize()
        reader = pss.Reader(path)
        assert_search(reader, 'small', ['small'])
        assert_search(reader, 'bbbb', [big])
        assert_search(reader, 'tail', ['tail'])


class TestSearchMultiple:
    def test_concat_with_duplicates(self, tmp_path):
        reader = roundtrip(tmp_path, ['one', 'two', 'twelve'])
        got = reader.search_multiple(['tw', 'twelve'])
        # Reference semantics: concat of per-pattern results, duplicates kept.
        assert collections.Counter(got) == collections.Counter(
            ['two', 'twelve', 'twelve']
        )

    def test_empty_list(self, tmp_path):
        reader = roundtrip(tmp_path, ['one'])
        assert reader.search_multiple([]) == []

    def test_large_batch(self, tmp_path):
        entries = [f'line-{i:04d}' for i in range(100)]
        reader = roundtrip(tmp_path, entries)
        patterns = [f'line-{i:04d}' for i in range(100)]
        got = reader.search_multiple(patterns)
        assert collections.Counter(got) == collections.Counter(entries)

    def test_repeated_patterns_probed_once_results_duplicated(self, tmp_path):
        # Reference parity: a repeated pattern repeats its results verbatim
        # (pysubstringsearch/__init__.py:61-73); the batch path dedups the
        # probe internally but must fan results back out per occurrence.
        reader = roundtrip(tmp_path, ['alpha', 'beta', 'alphabet'])
        got = reader.search_multiple(['alpha', 'beta', 'alpha', 'alpha'])
        assert collections.Counter(got) == collections.Counter(
            ['alpha', 'alphabet'] * 3 + ['beta']
        )


class TestLongPatternHostRoute:
    def test_pattern_beyond_device_window_uses_host_path(self, tmp_path):
        """A pattern longer than the device probe window (PAD_MARGIN) must
        route through the exact host path (api.Reader._search_host — now a
        delegation to the unified per-chunk pipeline) and return the same
        multiset as ground truth, while the REST of a mixed batch still
        answers correctly (an oversized straggler must not poison the
        batch)."""
        import pysubstringsearch_jax as pss
        from pysubstringsearch_jax.ops.search import PAD_MARGIN

        long_body = 'ab' * (PAD_MARGIN // 2 + 40)
        lines = [f'{long_body} tail{i}' for i in range(3)]
        lines += ['short one', 'short two ab', long_body[: PAD_MARGIN + 10]]
        path = str(tmp_path / 'long.idx')
        w = pss.Writer(path, max_chunk_len=4096)  # multi-chunk
        for ln in lines:
            w.add_entry(ln)
        w.finalize()
        r = pss.Reader(path)
        long_pat = long_body[: PAD_MARGIN + 8]
        expected = sorted(ln for ln in lines if long_pat in ln)
        assert sorted(r.search(long_pat)) == expected
        # Mixed batch: long + short patterns in one search_multiple call.
        res = r.search_multiple([long_pat, 'short', 'zzz-none'])
        exp_multi = sorted(
            [ln for ln in lines if long_pat in ln]
            + [ln for ln in lines if 'short' in ln]
        )
        assert sorted(res) == exp_multi
