"""ShardedReader parity: identical result multisets to the single-device
Reader on the same index, across the virtual 8-device mesh."""

import collections

import pytest

import jax

import pysubstringsearch_jax as pss
from pysubstringsearch_jax.parallel.reader import ShardedReader


@pytest.fixture(scope='module')
def index_path(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('sharded_reader')
    path = str(tmp / 'index.idx')
    writer = pss.Writer(path, max_chunk_len=64)  # many small chunks
    entries = [f'entry number {i} of the corpus' for i in range(50)]
    entries += ['shared token alpha'] * 3 + ['unique omega']
    for e in entries:
        writer.add_entry(e)
    writer.finalize()
    return path, entries


def test_parity_with_plain_reader(index_path):
    path, entries = index_path
    if len(jax.devices()) < 2:
        pytest.skip('needs multi-device backend')
    plain = pss.Reader(path)
    sharded = ShardedReader(path)
    for pat in ['entry', 'number 7 ', 'alpha', 'omega', 'missing', '', 'corpus']:
        a = plain.search(pat)
        b = sharded.search(pat)
        assert collections.Counter(a) == collections.Counter(b), pat


def test_search_multiple_parity(index_path):
    path, entries = index_path
    if len(jax.devices()) < 2:
        pytest.skip('needs multi-device backend')
    plain = pss.Reader(path)
    sharded = ShardedReader(path)
    pats = ['entry', 'alpha', 'alpha', 'nope']
    assert collections.Counter(plain.search_multiple(pats)) == (
        collections.Counter(sharded.search_multiple(pats))
    )


def test_chunk_padding_to_mesh_multiple(index_path):
    path, _ = index_path
    if len(jax.devices()) < 2:
        pytest.skip('needs multi-device backend')
    sharded = ShardedReader(path)
    assert sharded._C % sharded.mesh.devices.size == 0
    assert sharded._C >= sharded._num_real


def test_sharded_derive_parity(index_path):
    """Derive mode over the mesh: each row's SA/limbs/tables build on its
    owning device; results match the plain Reader."""
    path, entries = index_path
    if len(jax.devices()) < 2:
        pytest.skip('needs multi-device backend')
    plain = pss.Reader(path)
    sharded = ShardedReader(path, index_mode='derive')
    assert sharded._index.mode == 'derive'
    assert sharded._C % sharded.mesh.devices.size == 0
    for pat in ['entry', 'number 7 ', 'alpha', 'omega', 'missing', '']:
        a = plain.search(pat)
        b = sharded.search(pat)
        assert collections.Counter(a) == collections.Counter(b), pat


def test_sharded_derive_merged_parity(index_path):
    """Merged rows + mesh placement compose: container chunks concatenate
    into rows, rows shard across devices."""
    path, entries = index_path
    if len(jax.devices()) < 2:
        pytest.skip('needs multi-device backend')
    import os
    os.environ['PSS_MERGE_CAP'] = '512'
    try:
        plain = pss.Reader(path)
        sharded = ShardedReader(path, index_mode='derive')
        assert sharded._index.merged
        for pat in ['entry', 'alpha', 'omega', 'missing', 'the corpus']:
            a = plain.search(pat)
            b = sharded.search(pat)
            assert collections.Counter(a) == collections.Counter(b), pat
    finally:
        del os.environ['PSS_MERGE_CAP']


def test_sharded_probe_operands_stay_split(index_path, monkeypatch):
    """The derived index keeps each row on one device, and the compiled
    sharded probe reads only its own device's rows: its per-device operand
    bytes are a fraction of the whole index, and its only collectives
    reduce loop predicates (no row is gathered onto every device)."""
    import re

    from pysubstringsearch_jax.ops import search as search_ops

    path, _ = index_path
    if len(jax.devices()) < 2:
        pytest.skip('needs multi-device backend')
    monkeypatch.setenv('PSS_MERGE_CAP', '512')
    idx = ShardedReader(path, index_mode='derive')._index
    d = idx.sharding.mesh.devices.size
    total = 0
    for name in ('text', 'sa', 'limbs', 'tables'):
        arr = getattr(idx, name)
        shards = arr.addressable_shards
        assert len({s.device for s in shards}) == d
        assert all(s.data.shape[0] == idx.num_chunks // d for s in shards)
        total += arr.nbytes
    packed, lengths = search_ops.pack_patterns([b'entry', b'the corpus'])
    spec, flat = idx._group_batch(packed, lengths)
    for (_, width, deep), (_, sub, sub_len) in zip(spec, flat):
        probe = search_ops.phased_batch_jit(
            deep, idx.num_limbs, idx._bits, uniform_long=width > idx._depth)
        compiled = probe.lower(
            idx.text, idx.lengths, idx.sa, idx.tables, idx.limbs, idx.rank,
            idx.present, sub, sub_len).compile()
        assert compiled.memory_analysis().argument_size_in_bytes < total / 2
        collectives = re.findall(
            r'= (\S+) (all-gather|all-to-all|collective-permute|all-reduce)'
            r'(?:-start)?\(', compiled.as_text())
        assert all(shape == 'pred[]' for shape, _ in collectives), collectives
