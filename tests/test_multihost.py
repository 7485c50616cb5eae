"""N=2-process distributed smoke test on the CPU backend: both processes
join a TCP coordinator, probe their chunk shard, and allgather counts.

This is the harness the reference never had (SURVEY.md §4: no multi-node
testing exists there); it validates the multihost glue without a cluster of accelerators.
"""

import os
import subprocess
import sys

import pytest

WORKER = r'''
import os, sys
import numpy as np
import jax
jax.config.update('jax_platforms', 'cpu')

pid = int(sys.argv[1])
jax.distributed.initialize(
    coordinator_address='127.0.0.1:%PORT%',
    num_processes=2,
    process_id=pid,
)
from pysubstringsearch_jax.ops.search import pack_patterns, probe_bounds
from pysubstringsearch_jax.ops.suffix_array import suffix_array_numpy
from pysubstringsearch_jax.parallel import multihost
import jax.numpy as jnp

# 4 chunks round-robined over 2 processes
chunks = [b'alpha beta\ngamma\n', b'beta beta\n', b'delta alpha\n', b'omega\n']
mine = multihost.my_chunk_ids(len(chunks))
assert mine == [c for c in range(4) if c % 2 == pid], mine

patterns, lengths = pack_patterns([b'alpha', b'beta', b'zzz'])
local_counts = []
for c in mine:
    data = np.frombuffer(chunks[c], dtype=np.uint8)
    sa = suffix_array_numpy(data)
    n = data.size
    n_pad = 2048
    text_p = np.zeros(n_pad, np.uint8); text_p[:n] = data
    sa_p = np.zeros(n_pad, np.int32); sa_p[:n] = sa
    lo, cnt = probe_bounds(
        jnp.asarray(text_p), jnp.int32(n), jnp.asarray(sa_p),
        jnp.asarray(patterns), jnp.asarray(lengths),
    )
    local_counts.append(np.asarray(cnt))
gathered = multihost.allgather_counts(np.stack(local_counts))
total = gathered.sum(axis=(0, 1))
# alpha: 2 occurrences, beta: 3, zzz: 0 across the corpus
assert list(total) == [2, 3, 0], total
print(f'WORKER{pid}_OK', flush=True)
'''


def _run_workers(tmp_path, script: str, nproc: int, timeout: int = 200):
    import socket

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    script = script.replace('%PORT%', str(port)).replace('%NPROC%', str(nproc))
    script_path = tmp_path / 'worker.py'
    script_path.write_text(script)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)  # no forced device count in workers
    env['PYTHONPATH'] = repo_root + os.pathsep + env.get('PYTHONPATH', '')
    procs = [
        subprocess.Popen(
            [sys.executable, str(script_path), str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=repo_root,
        )
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail('distributed worker timed out')
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {pid} failed:\n{out}'
        assert f'WORKER{pid}_OK' in out
    return outs


def test_two_process_allgather(tmp_path):
    _run_workers(tmp_path, WORKER, 2)


# End-to-end multi-host search: build a real sharded-manifest index with
# ShardedWriter, open a MultiHostReader per process (each loads only its
# own shards), and compare the merged result multiset against a pure-python
# ground truth — the distributed form of the reference's mutex merge
# (src/lib.rs:205-284), which had no multi-process analogue at all.
E2E_WORKER = r'''
import collections, os, sys
import numpy as np
import jax
jax.config.update('jax_platforms', 'cpu')

pid = int(sys.argv[1])
jax.distributed.initialize(
    coordinator_address='127.0.0.1:%PORT%',
    num_processes=%NPROC%,
    process_id=pid,
)
from pysubstringsearch_jax.parallel import manifest, multihost

rng = np.random.default_rng(7)
words = [
    bytes(rng.integers(97, 105, size=int(l), dtype=np.uint8)).decode()
    for l in rng.integers(3, 8, size=60)
]
lines = [
    ' '.join(words[i] for i in rng.integers(0, 60, size=5))
    for _ in range(3000)
]
d = os.path.join('%TMP%', 'mh-index')
if pid == 0:
    w = manifest.ShardedWriter(d, num_shards=%NPROC%, max_chunk_len=16384)
    for ln in lines:
        w.add_entry(ln)
    w.close()
    open(os.path.join('%TMP%', 'ready'), 'w').write('1')
else:
    import time
    while not os.path.exists(os.path.join('%TMP%', 'ready')):
        time.sleep(0.2)

r = multihost.MultiHostReader(d)
pats = [words[0], words[1][:3], 'zzzz', words[2] + ' ' + words[3]]
for p in pats:
    got = collections.Counter(r.search(p))
    want = collections.Counter(ln for ln in lines if p in ln)
    assert got == want, (p, len(got), len(want))
sm = r.search_multiple(pats)
assert len(sm) == sum(sum(p in ln for ln in lines) for p in pats)
print(f'WORKER{pid}_OK', flush=True)
'''


@pytest.mark.parametrize('nproc', [2, 4])
def test_multihost_reader_end_to_end(tmp_path, nproc):
    script = E2E_WORKER.replace('%TMP%', str(tmp_path))
    _run_workers(tmp_path, script, nproc)
