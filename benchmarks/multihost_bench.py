"""Multi-host end-to-end search benchmark (N processes, CPU mesh).

Measures the full distributed read path: every process loads only its
manifest shards, probes its local chunks, and merges line results through
the two-collective DCN-style allgather (parallel/multihost.py) — the
distributed form of the reference's rayon fan-out + mutex merge
(reference: src/lib.rs:205-284), which has no multi-process analogue.

Run on one machine with N co-located processes over the jax.distributed
coordinator (the same code path a real N-host cluster uses; here the
"DCN" is loopback, so the numbers are indicative of protocol overhead,
not of real cross-host bandwidth):

    python benchmarks/multihost_bench.py [mb] [nproc] [nq]

Prints one JSON line per process; process 0's line is the result.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


WORKER = r'''
import json, os, sys, time
sys.path.insert(0, %(root)r)
import numpy as np
import jax
jax.config.update('jax_platforms', 'cpu')

pid = int(sys.argv[1])
jax.distributed.initialize(
    coordinator_address='127.0.0.1:%(port)d',
    num_processes=%(nproc)d,
    process_id=pid,
)
from bench import make_corpus
from pysubstringsearch_jax.parallel import manifest, multihost

# Touch the backend on EVERY process before any divergent work: multi-
# process backend init is a collective (local-topology exchange), so a
# process that defers its first jax use past a host-side barrier deadlocks
# the others.
jax.local_devices()
print(f'worker {pid}: up', file=sys.stderr, flush=True)
corpus, words = make_corpus(%(mb)d)
print(f'worker {pid}: corpus ready', file=sys.stderr, flush=True)
d = os.path.join(%(tmp)r, 'mh-index')
if pid == 0:
    t0 = time.time()
    # Chunk so every shard gets >= 2 chunks: balanced per-process load
    # keeps processes entering the collectives together (a process with no
    # chunks reaches the allgather minutes early and gloo's connect window
    # expires while the loaded ones are still building device state).
    w = manifest.ShardedWriter(
        d, num_shards=%(nproc)d,
        max_chunk_len=max(1, %(mb)d // (2 * %(nproc)d)) * 1024 * 1024,
    )
    for line in corpus.split(b'\n'):
        if line:
            w.add_entry(line.decode())
    w.close()
    print(f'build: {time.time()-t0:.1f}s', file=sys.stderr, flush=True)
    open(os.path.join(%(tmp)r, 'ready'), 'w').write('1')
else:
    while not os.path.exists(os.path.join(%(tmp)r, 'ready')):
        time.sleep(0.2)

print(f'worker {pid}: loading', file=sys.stderr, flush=True)
t0 = time.time()
r = multihost.MultiHostReader(d)
load_s = time.time() - t0
print(f'worker {pid}: loaded {load_s:.1f}s', file=sys.stderr, flush=True)

rng = np.random.default_rng(2)
nq = %(nq)d
offs = rng.integers(0, len(corpus) - 16, size=nq)
lens = rng.integers(4, 13, size=nq)
pats = [
    corpus[o:o+l].replace(b'\n', b'x').decode('utf-8', 'surrogateescape')
    for o, l in zip(offs, lens)
]
# warmup (compile)
r.search_multiple(pats[:8])
t0 = time.time()
out = r.search_multiple(pats)
batch_s = time.time() - t0
if pid == 0:
    print(json.dumps({
        'metric': f'{nq} queries end-to-end, {%(mb)d}MB index, '
                  f'{%(nproc)d}-process multihost (CPU mesh)',
        'value': round(batch_s * 1e3, 1),
        'unit': 'ms',
        'results': len(out),
        'load_s': round(load_s, 2),
    }), flush=True)
    open(os.path.join(%(tmp)r, 'done'), 'w').write('1')
# Exit barrier: a process leaving early starts jax's shutdown-barrier clock
# while slower ones are still computing; wait for process 0's signal.
while not os.path.exists(os.path.join(%(tmp)r, 'done')):
    time.sleep(0.2)
'''


def main():
    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    nproc = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    nq = int(sys.argv[3]) if len(sys.argv) > 3 else 1000
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(
        dir='/dev/shm' if os.path.isdir('/dev/shm') else None
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = WORKER % {
        'root': root, 'port': port, 'nproc': nproc, 'mb': mb,
        'tmp': tmp, 'nq': nq,
    }
    path = os.path.join(tmp, 'worker.py')
    with open(path, 'w') as f:
        f.write(script)
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    procs = [
        subprocess.Popen(
            [sys.executable, path, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=root,
        )
        for pid in range(nproc)
    ]
    t0 = time.time()
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=1200)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        sys.stderr.write(
            ''.join(f'[w{pid}] {l}\n' for l in out.splitlines()
                    if not l.startswith('{'))
        )
        for line in out.splitlines():
            if line.startswith('{'):
                print(line, flush=True)
    if any(p.returncode != 0 for p in procs):
        sys.exit(1)
    print(f'total wall: {time.time()-t0:.1f}s', file=sys.stderr)


if __name__ == '__main__':
    main()
