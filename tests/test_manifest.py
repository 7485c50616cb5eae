"""Sharded-manifest container: the pod-scale variant of the index format
(SURVEY.md §5.4).  Each shard must remain a valid single-file container."""

import collections
import json
import os

import pytest

import pysubstringsearch_jax as pss
from pysubstringsearch_jax import container
from pysubstringsearch_jax.parallel import manifest


ENTRIES = [f'word-{i:03d} alpha' if i % 3 else f'word-{i:03d} beta'
           for i in range(60)]


def write_sharded(tmp_path, num_shards, max_chunk_len=64):
    d = str(tmp_path / 'sharded')
    with manifest.ShardedWriter(d, num_shards, max_chunk_len) as w:
        for e in ENTRIES:
            w.add_entry(e)
    return d


def test_roundtrip_matches_single_file(tmp_path):
    d = write_sharded(tmp_path, 3)
    single = str(tmp_path / 'single.idx')
    w = pss.Writer(single, max_chunk_len=64)
    for e in ENTRIES:
        w.add_entry(e)
    w.finalize()
    r_sharded = manifest.open_local_reader(d)
    r_single = pss.Reader(single)
    for pat in ['alpha', 'beta', 'word-05', 'nope', '']:
        assert collections.Counter(r_sharded.search(pat)) == \
            collections.Counter(r_single.search(pat)), pat


def test_each_shard_is_a_valid_container(tmp_path):
    d = write_sharded(tmp_path, 4)
    paths = manifest.read_manifest(d)
    assert len(paths) == 4
    total_chunks = 0
    all_lines = collections.Counter()
    for p in paths:
        r = pss.Reader(p)  # plain single-file Reader opens a shard directly
        total_chunks += len(container.read_chunks(p))
        all_lines.update(r.search(''))
    assert all_lines == collections.Counter(ENTRIES)
    meta = json.load(open(os.path.join(d, manifest.MANIFEST_NAME)))
    assert sum(s['chunks'] for s in meta['shards']) == total_chunks


def test_round_robin_balance(tmp_path):
    d = write_sharded(tmp_path, 2)
    meta = json.load(open(os.path.join(d, manifest.MANIFEST_NAME)))
    counts = [s['chunks'] for s in meta['shards']]
    assert abs(counts[0] - counts[1]) <= 1


def test_convert_existing_index(tmp_path):
    single = str(tmp_path / 'single.idx')
    w = pss.Writer(single, max_chunk_len=64)
    for e in ENTRIES:
        w.add_entry(e)
    w.finalize()
    d = str(tmp_path / 'converted')
    manifest.convert_index(single, d, 3)
    r = manifest.open_local_reader(d)
    assert collections.Counter(r.search('alpha')) == \
        collections.Counter(pss.Reader(single).search('alpha'))


def test_bad_manifest_format(tmp_path):
    d = str(tmp_path / 'bad')
    os.makedirs(d)
    with open(os.path.join(d, manifest.MANIFEST_NAME), 'w') as f:
        json.dump({'format': 'something-else', 'shards': []}, f)
    with pytest.raises(ValueError):
        manifest.read_manifest(d)


def test_writer_validation(tmp_path):
    with pytest.raises(ValueError):
        manifest.ShardedWriter(str(tmp_path / 'x'), 0)
    w = manifest.ShardedWriter(str(tmp_path / 'y'), 1, max_chunk_len=16)
    with pytest.raises(ValueError):
        w.add_entry('x' * 64)
    w.close()
