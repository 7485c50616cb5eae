"""Container format: golden-byte compatibility with the reference layout
(u32 LE text len | text | u32 LE 4n | int32 LE suffix array...; reference
src/lib.rs:105-124), plus malformed-container error surfaces."""

import struct

import numpy as np
import pytest

import pysubstringsearch_jax as pss
from pysubstringsearch_jax import container

# Index of entries ['abc', 'ab']: text b'abc\nab\n', SA computed by hand
# (bytewise order, prefix-before-extension): [6, 3, 4, 0, 5, 1, 2].
GOLDEN_HEX = (
    '070000006162630a61620a1c00000006000000030000000400000000000000'
    '050000000100000002000000'
)


def test_writer_produces_reference_bytes(tmp_path):
    path = str(tmp_path / 'golden.idx')
    w = pss.Writer(path)
    w.add_entry('abc')
    w.add_entry('ab')
    w.finalize()
    assert open(path, 'rb').read().hex() == GOLDEN_HEX


def test_reader_parses_reference_bytes(tmp_path):
    path = str(tmp_path / 'golden.idx')
    with open(path, 'wb') as f:
        f.write(bytes.fromhex(GOLDEN_HEX))
    r = pss.Reader(path)
    assert sorted(r.search('ab')) == ['ab', 'abc']
    assert r.search('abc') == ['abc']
    assert r.search('abcd') == []


def test_multi_chunk_roundtrip_bytes(tmp_path):
    path = str(tmp_path / 'two.idx')
    w = pss.Writer(path, max_chunk_len=8)
    w.add_entry('abc')
    w.add_entry('defg')  # 3+1+4+1 > 8 -> second chunk
    w.finalize()
    chunks = container.read_chunks(path)
    assert len(chunks) == 2
    assert chunks[0].data.tobytes() == b'abc\n'
    assert chunks[1].data.tobytes() == b'defg\n'
    for c in chunks:
        assert c.suffix_array.size == c.data.size


@pytest.mark.parametrize('cut', [1, 3, 9, 14])
def test_truncated_container_raises(tmp_path, cut):
    raw = bytes.fromhex(GOLDEN_HEX)
    path = str(tmp_path / 'trunc.idx')
    with open(path, 'wb') as f:
        f.write(raw[:-cut])
    with pytest.raises(ValueError):
        container.read_chunks(path)


def test_sa_length_not_multiple_of_four(tmp_path):
    bad = struct.pack('<I', 2) + b'a\n' + struct.pack('<I', 7) + b'x' * 7
    path = str(tmp_path / 'bad.idx')
    with open(path, 'wb') as f:
        f.write(bad)
    with pytest.raises(ValueError):
        container.read_chunks(path)


def test_chunk_too_large_guard(tmp_path):
    data = np.zeros(4, dtype=np.uint8)
    sa = np.zeros(4, dtype=np.int32)

    class FakeBig(np.ndarray):
        pass

    # write_chunk validates u32 framing limits without allocating 4GB.
    big = np.lib.stride_tricks.as_strided(
        np.zeros(1, dtype=np.uint8), shape=(0x1_0000_0001,), strides=(0,)
    )
    with open(str(tmp_path / 'x.idx'), 'wb') as f:
        with pytest.raises(ValueError):
            container.write_chunk(f, big, sa)
        container.write_chunk(f, data, sa)  # small one is fine
