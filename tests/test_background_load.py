"""Background device load + host serving (the time-to-first-query design).

While the device index derives on a background thread, the Reader answers
queries from the container's per-chunk SAs via the native host bisection —
the analog of the reference Reader's serve-immediately behavior
(reference: src/lib.rs:161-199 parses and is ready in milliseconds).
Results must be identical on both paths, and the switchover must be safe.
"""

import os
import tempfile
import threading

import pytest

import pysubstringsearch_jax as pss
from pysubstringsearch_jax.api import Reader

WORDS = [
    'apple', 'apricot', 'banana', 'cherry', 'cherrypie',
    'grape', 'grapefruit', 'melon', 'watermelon', 'berry',
]


@pytest.fixture()
def index_path(tmp_path):
    path = str(tmp_path / 'bg.idx')
    with pss.Writer(path, max_chunk_len=32) as w:
        for word in WORDS * 3:
            w.add_entry(word)
    return path


def ground_truth(pattern: str):
    out = []
    for word in WORDS * 3:
        if pattern in word:
            out.append(word)
    return out


def test_host_chunks_path_matches_device_path(index_path):
    r = pss.Reader(index_path)
    for pat in ['ap', 'cherry', 'melon', 'zzz', 'e']:
        host = r._search_host_chunks([pat.encode()])[0]
        dev = r.search(pat)
        assert sorted(host) == sorted(dev)
        assert sorted(host) == sorted(ground_truth(pat))


def test_background_load_serves_before_and_after_ready(index_path, monkeypatch):
    monkeypatch.setenv('PSS_BG_LOAD', '1')
    release = threading.Event()
    orig = Reader._build_device_index

    def slow_build(self):
        release.wait(10.0)
        return orig(self)

    monkeypatch.setattr(Reader, '_build_device_index', slow_build)
    r = pss.Reader(index_path)
    assert r._bg_thread is not None
    assert not r.device_ready
    # Served by the host path while the "device" load is blocked.
    early = r.search('cherry')
    assert sorted(early) == sorted(ground_truth('cherry'))
    release.set()
    assert r.wait_device_ready(30.0)
    late = r.search('cherry')
    assert sorted(late) == sorted(early)
    # search_multiple across the switchover stays consistent too.
    multi = r.search_multiple(['ap', 'melon'])
    assert sorted(multi) == sorted(ground_truth('ap') + ground_truth('melon'))


def test_background_load_failure_degrades_to_host(index_path, monkeypatch):
    """A failed device load is not hidden behind the host path: once the
    load has ended, search and wait_device_ready raise its error."""
    monkeypatch.setenv('PSS_BG_LOAD', '1')

    def broken_build(self):
        raise RuntimeError('simulated device failure')

    monkeypatch.setattr(Reader, '_build_device_index', broken_build)
    r = pss.Reader(index_path)
    r._device_ready.wait(10.0)
    assert not r.device_ready
    with pytest.raises(RuntimeError, match='device index load failed') as e:
        r.search('grape')
    assert 'simulated device failure' in str(e.value.__cause__)
    with pytest.raises(RuntimeError, match='device index load failed'):
        r.wait_device_ready(1.0)
    with pytest.raises(RuntimeError):
        _ = r._index


def test_bg_load_disabled_by_env(index_path, monkeypatch):
    monkeypatch.setenv('PSS_BG_LOAD', '0')
    r = pss.Reader(index_path)
    assert r._bg_thread is None
    assert sorted(r.search('berry')) == sorted(ground_truth('berry'))
