"""CLI smoke tests (build / search / shard round trip, in-process)."""

import io
import contextlib

from pysubstringsearch_jax.__main__ import main


def test_cli_roundtrip(tmp_path):
    corpus = tmp_path / 'corpus.txt'
    corpus.write_text('red apple\ngreen pear\nred rose\n')
    idx = str(tmp_path / 'c.idx')
    assert main(['build', str(corpus), idx, '--chunk-mb', '1']) == 0

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(['search', idx, 'red', '--count-only']) == 0
    assert out.getvalue().strip() == 'red\t2'

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(['search', idx, 'pear']) == 0
    assert out.getvalue().strip() == 'green pear'

    shard_dir = str(tmp_path / 'shards')
    assert main(['shard', idx, shard_dir, '--shards', '2']) == 0
    from pysubstringsearch_jax.parallel import manifest

    r = manifest.open_local_reader(shard_dir)
    assert sorted(r.search('red')) == ['red apple', 'red rose']
