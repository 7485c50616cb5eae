"""Stage-by-stage timing of the host-route batch extraction (no device).

Reproduces Reader._extract_row's host route against the cached bench
container: per source chunk — native bisection probe, SA gather,
line-id resolution, per-query dedup, native str fan-out — each stage
timed separately, at bench scale (10k patterns, ~22M result lines).

Run: python benchmarks/extract_decomp.py IDX_PATH  (e.g. a container
written by bench.py with BENCH_IDX_CACHE set)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    idx_path = sys.argv[1]
    from pysubstringsearch_jax import container
    from pysubstringsearch_jax.ops import native as native_ops
    from pysubstringsearch_jax.ops.extract import LineTable
    from pysubstringsearch_jax.ops.search import pack_patterns

    t0 = time.time()
    chunks = container.read_chunks(idx_path)
    log(f'parse: {time.time() - t0:.1f}s, {len(chunks)} chunks')

    # Bench patterns (same generator as bench.py).
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    corpus, _ = bench.make_corpus(int(os.environ.get('BENCH_MB', '500')))
    rng = np.random.default_rng(1)
    nq = int(os.environ.get('BENCH_QUERIES', '10000'))
    offs = rng.integers(0, len(corpus) - 16, size=nq)
    lens = rng.integers(4, 13, size=nq)
    pats = [corpus[o: o + l].replace(b'\n', b'x') for o, l in zip(offs, lens)]
    packed, lengths = pack_patterns(pats)
    del corpus

    # Merged-row geometry: 4 chunks per row (matches PSS_MERGE_CAP 256MiB
    # over 64MiB chunks).
    per_row = int(os.environ.get('ROW_CHUNKS', '4'))
    groups = [list(range(i, min(i + per_row, len(chunks))))
              for i in range(0, len(chunks), per_row)]

    stage = {k: 0.0 for k in
             ('probe', 'sa-gather', 'table-build', 'line-ids', 'dedup',
              'fanout', 'row-concat')}
    tot_lines = 0
    t_all = time.time()
    for group in groups:
        t0 = time.time()
        row = np.concatenate([chunks[c].data for c in group])
        table = LineTable(row)
        stage['row-concat'] += time.time() - t0
        off = 0
        for c in group:
            chunk = chunks[c]
            t0 = time.time()
            lo_c, cnt_c = native_ops.probe_batch_native(
                chunk.data, chunk.suffix_array, packed, lengths
            )
            stage['probe'] += time.time() - t0
            t0 = time.time()
            cnt = np.maximum(cnt_c.astype(np.int64), 0)
            seg = np.repeat(np.arange(cnt.size, dtype=np.int64), cnt)
            firsts = np.cumsum(cnt) - cnt
            offs_f = (np.repeat(lo_c.astype(np.int64) - firsts, cnt)
                      + np.arange(int(cnt.sum()), dtype=np.int64))
            pos = chunk.suffix_array[offs_f].astype(np.int64) + off
            stage['sa-gather'] += time.time() - t0

            # lines_for_positions, staged
            t0 = time.time()
            ids = table.line_ids(pos)
            stage['line-ids'] += time.time() - t0
            t0 = time.time()
            key = seg * np.int64(table.num_lines + 1) + ids
            uniq = np.unique(key)
            useg = uniq // np.int64(table.num_lines + 1)
            uid = uniq - useg * np.int64(table.num_lines + 1)
            seen = np.zeros(table.num_lines + 1, dtype=bool)
            seen[uid] = True
            dist = np.flatnonzero(seen)
            remap = np.zeros(table.num_lines + 1, dtype=np.int64)
            remap[dist] = np.arange(dist.size, dtype=np.int64)
            inv = remap[uid]
            starts = np.where(dist > 0, table.nl[dist - 1] + 1, 0).astype(np.int64)
            ends = table.nl[dist].astype(np.int64)
            bounds = np.flatnonzero(np.diff(useg)) + 1
            gstart = np.concatenate(([0], bounds)).astype(np.int64)
            gstop = np.concatenate((bounds, [uniq.size])).astype(np.int64)
            qid = useg[gstart].astype(np.int64)
            stage['dedup'] += time.time() - t0
            t0 = time.time()
            fx = native_ops.fastext()
            res = fx.materialize(
                table._data_bytes,
                np.ascontiguousarray(starts), np.ascontiguousarray(ends),
                np.ascontiguousarray(inv), np.ascontiguousarray(gstart),
                np.ascontiguousarray(gstop), np.ascontiguousarray(qid),
            )
            stage['fanout'] += time.time() - t0
            tot_lines += sum(len(v) for v in res.values())
            off += chunk.data.size
    wall = time.time() - t_all
    log(f'serial wall {wall:.1f}s, {tot_lines} lines '
        f'({tot_lines / wall / 1e6:.2f} M lines/s)')
    for k, v in sorted(stage.items(), key=lambda kv: -kv[1]):
        log(f'  {k:12s} {v:7.2f}s')


if __name__ == '__main__':
    main()
