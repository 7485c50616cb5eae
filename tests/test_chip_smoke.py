"""chip_smoke.py's phases at a tiny size on the CPU backend.

The script itself refuses to run without a GPU (that check lives only in
``main``); these tests drive each phase function directly, with the
background device load switched on as it is on a card.
"""

import json

import numpy as np
import pytest

import chip_smoke as cs
from pysubstringsearch_jax.ops import search as search_ops


@pytest.fixture(scope='module')
def corpus():
    return cs.make_corpus(0.2, seed=3)


@pytest.fixture(scope='module')
def queries(corpus):
    return cs.make_queries(corpus, 200, seed=3)


@pytest.fixture()
def bg_load(monkeypatch):
    monkeypatch.setenv('PSS_BG_LOAD', '1')


def test_make_corpus_shape(corpus):
    assert len(corpus) >= int(0.2 * cs.MiB) and corpus.endswith(b'\n')
    assert cs.make_corpus(0.2, seed=3) == corpus
    assert cs.make_corpus(0.2, seed=4) != corpus
    lines = corpus.split(b'\n')[:-1]
    assert all(len(line.split(b' ')) == 8 for line in lines)
    words = {w for line in lines[:2000] for w in line.split(b' ')}
    assert all(3 <= len(w) <= 11 and w.isalpha() and w.islower()
               for w in words)
    # Stops at the first line end past the target.
    assert len(corpus) - len(lines[-1]) - 1 < int(0.2 * cs.MiB)


def test_queries_and_brute_force(corpus, queries):
    hits, misses = queries
    assert len(hits) == 200 and len(misses) == 100
    assert all(4 <= len(p) <= 12 and b'\n' not in p for p in hits)
    for p in hits[:20]:
        want = [l.decode() for l in corpus.split(b'\n')[:-1] if p in l]
        assert cs.brute_force(corpus, p) == want
    assert cs.brute_force(corpus, misses[0]) == []


def test_phase_a(corpus, queries, tmp_path, bg_load):
    hits, misses = queries
    cs.phase_a(corpus, hits, misses, str(tmp_path), chunk_bytes=16 << 10,
               sample=8, index_mode='derive')


def test_phase_b_rotating(corpus, queries, tmp_path, bg_load, monkeypatch):
    hits, misses = queries
    (tmp_path / 'corpus.txt').write_bytes(corpus)
    # Push this tiny row past the segmented kernel's limit, as 500 MB is.
    monkeypatch.setattr(search_ops, 'SEGMENTED_MAX_PAD', 1024)
    kernel = cs.phase_b(corpus, hits, misses, str(tmp_path), sample=8,
                        index_mode='derive')
    assert kernel == 'rotating'


def test_phase_c_upload(corpus, queries, tmp_path, bg_load):
    cs.phase_c(corpus, queries[0], str(tmp_path), prefix_bytes=64 << 10,
               chunk_bytes=16 << 10)


def test_phase_four_on_virtual_devices(corpus, queries, tmp_path,
                                       monkeypatch):
    import jax

    monkeypatch.setenv('PSS_MERGE_CAP', str(48 << 10))
    cs.phase_four(corpus, queries[0], str(tmp_path), giant_bytes=32 << 10,
                  chunk_bytes=16 << 10, nq=100, devices=jax.devices()[:4])


def test_failed_check_raises():
    with pytest.raises(cs.SmokeFailure, match='boom'):
        cs.check(False, 'boom')


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main(['--mb', '0.1'])
    assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert 'nvidia-smi name, power.limit' in out
    assert '"ok"' not in out


@pytest.fixture()
def gpu():
    import jax

    if jax.devices()[0].platform != 'gpu':
        pytest.skip('needs an NVIDIA card (PSS_TEST_GPU=1 on one)')


@pytest.mark.gpu
def test_smoke_small_on_card(gpu, capsys):
    assert cs.main(['--mb', '48', '--queries', '2000']) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)['device']['platform'] == 'gpu'


def test_seed_map_timing_agrees(corpus, queries, bg_load, tmp_path):
    """time_seed_map checks the two maps agree on a real batch."""
    import pysubstringsearch_jax as pss
    from pysubstringsearch_jax.ops.search import pack_patterns

    (tmp_path / 'c.txt').write_bytes(corpus)
    path = str(tmp_path / 's.idx')
    cs.write_index(path, str(tmp_path / 'c.txt'), 16 << 10)
    r = pss.Reader(path, index_mode='derive')
    assert r.wait_device_ready()
    packed, lengths = pack_patterns(queries[0])
    cs.time_seed_map(r._index, packed, lengths)
    assert search_ops._tiny_map.__name__ == '_tiny_map'
    assert np.asarray(r._index.probe(packed, lengths)[1]).sum() > 0
