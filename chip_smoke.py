"""End-to-end smoke run on one NVIDIA GPU: Writer -> container -> Reader ->
search at the reference's headline size, every result checked exactly.

    python chip_smoke.py                 # phases A, B, C on one card
    python chip_smoke.py --four          # the sharded path on four cards

The corpus is the reference's published 500 MB configuration (reference
README.md:43-51): a synthetic word corpus, 10,000 words of 3-11 lowercase
letters, 8 words per line, generated from ``--seed``.  Queries are 10,000
patterns of 4-12 bytes sampled at random corpus offsets plus 100 misses.

- Phase A, the benchmark geometry: 8 MiB build chunks merged into device
  rows.  Derived SAs equal native SA-IS; device probe counts equal the
  native host counts; ``search_multiple`` equals the host path; sampled
  results equal a brute-force ``pattern in line`` scan.
- Phase B, the API default geometry: one ~500 MB chunk (``Writer(path)``),
  derived by the rotating doubler; the derived SA equals the container's.
- Phase C, ``index_mode='upload'`` on a 64 MB prefix.
- ``--four``: ``make_giant_chunk_build`` on a 64 MiB text against native
  SA-IS, then ``ShardedReader`` over a 2 GB corpus against a one-card
  ``Reader``, with each card's memory after the load.

Measurements go to standard output on lines that start with the card's
``nvidia-smi`` name and power limit.  Every check raises on failure; the last
line is one JSON object, printed only when every phase passed.  Without a
GPU the script exits non-zero before any phase.  One process drives the
card(s) throughout.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import typing

import numpy as np

MiB = 1 << 20
CARD = 'card not named'


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def report(msg: str) -> None:
    print(f'[{CARD}] {msg}', flush=True)


def note(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int = 1):
    """(best seconds, last result) of ``fn()`` over ``reps`` runs."""
    best, out = float('inf'), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def mem_stat(key: str, devices=None) -> typing.List[int]:
    """``memory_stats()[key]`` of each device (-1 where not reported)."""
    import jax

    return [
        int((d.memory_stats() or {}).get(key, -1))
        for d in (devices or jax.devices()[:1])
    ]


def peak_bytes(devices=None) -> typing.List[int]:
    return mem_stat('peak_bytes_in_use', devices)


# ---------------------------------------------------------------------------
# Corpus and queries
# ---------------------------------------------------------------------------

def make_corpus(mb: float, seed: int) -> bytes:
    """The bench corpus (bench.make_corpus's distribution), vectorised:
    10,000 words of 3-11 lowercase letters, 8 uniformly drawn words per
    ``\\n``-terminated line, lines until the size reaches ``mb`` MiB."""
    rng = np.random.default_rng(seed)
    nwords = 10_000
    wlen = rng.integers(3, 12, size=nwords)
    wstart = np.concatenate(([0], np.cumsum(wlen)[:-1]))
    letters = rng.integers(97, 123, size=int(wlen.sum()), dtype=np.uint8)
    # Row w of the word table: word w, its separator, then padding that
    # ``keep`` masks out.
    col = np.arange(12)
    keep = col[None, :] <= wlen[:, None]
    inword = col[None, :] < wlen[:, None]
    table = np.zeros((nwords, 12), dtype=np.uint8)
    table[inword] = letters[(wstart[:, None] + col[None, :])[inword]]
    table[np.arange(nwords), wlen] = ord(' ')
    target = int(mb * MiB)
    block_words = 8 * (1 << 18)
    parts, size = [], 0
    while size < target:
        widx = rng.integers(0, nwords, size=block_words)
        out = table[widx][keep[widx]]
        sep_at = np.cumsum(wlen[widx] + 1) - 1
        out[sep_at[7::8]] = ord('\n')
        ends = sep_at[7::8] + 1  # line ends within this block
        if size + out.size >= target:
            cut = int(ends[np.searchsorted(size + ends, target)])
            parts.append(out[:cut])
            break
        parts.append(out)
        size += out.size
    return np.concatenate(parts).tobytes()


def make_queries(corpus: bytes, nq: int, seed: int):
    """(hit patterns, miss patterns): ``nq`` random 4-12 byte corpus
    substrings (newlines replaced, as bench.py does) and 100 misses."""
    rng = np.random.default_rng(seed + 1)
    offs = rng.integers(0, len(corpus) - 16, size=nq)
    lens = rng.integers(4, 13, size=nq)
    hits = [corpus[o: o + n].replace(b'\n', b'x') for o, n in zip(offs, lens)]
    misses = [f'zzqqzzqqx{i}'.encode() for i in range(100)]
    return hits, misses


def make_rare(corpus: bytes, nq: int, seed: int) -> typing.List[bytes]:
    """``nq`` 20-byte corpus substrings: a low-hit batch (a window that
    spans two or more words occurs about once), the kind the merged-row
    device extraction serves."""
    rng = np.random.default_rng(seed + 2)
    offs = rng.integers(0, len(corpus) - 24, size=nq)
    return [corpus[o: o + 20].replace(b'\n', b'x') for o in offs]


def brute_force(corpus: bytes, pattern: bytes) -> typing.List[str]:
    """Lines containing ``pattern``, each once (``pattern`` holds no
    newline, so a line is matched at most once and never across lines)."""
    out, seen = [], set()
    pos = corpus.find(pattern)
    while pos != -1:
        start = corpus.rfind(b'\n', 0, pos) + 1
        if start not in seen:
            seen.add(start)
            out.append(corpus[start: corpus.index(b'\n', pos)].decode())
        pos = corpus.find(pattern, pos + 1)
    return out


def check_sample(reader, corpus: bytes, hits, misses, what: str) -> None:
    for p in list(hits) + list(misses):
        got = sorted(reader.search(p.decode()))
        check(got == sorted(brute_force(corpus, p)),
              f'{what}: search({p!r}) differs from brute force')
    for p in misses:
        check(corpus.find(p) == -1, f'{what}: miss pattern {p!r} occurs')


def write_index(path: str, corpus_path: str, max_chunk_len, backend='auto'):
    import pysubstringsearch_jax as pss

    w = pss.Writer(path, max_chunk_len=max_chunk_len, sa_backend=backend)
    w.add_entries_from_file_lines(corpus_path)
    w.close()
    return w


def route_counts(reader, before=None) -> typing.Dict[str, int]:
    keys = ('probe', 'x-dev-gather', 'extract', 'host-serve')
    now = {k: reader.profiler.counts.get(k, 0) for k in keys}
    if before is None:
        return now
    return {k: now[k] - before[k] for k in keys}


def ready_reader(path: str, **kwargs):
    """Reader(path) and its device-ready seconds; ``wait_device_ready``
    must return True (a failed background load raises from it)."""
    import pysubstringsearch_jax as pss

    t0 = time.perf_counter()
    r = pss.Reader(path, **kwargs)
    check(r._bg_thread is not None, 'Reader did not start a device load')
    check(r.wait_device_ready(), 'device index not ready')
    return r, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase A: bench geometry (8 MiB build chunks, merged device rows)
# ---------------------------------------------------------------------------

def onehot_map(values, table256):
    """The former one-hot contraction form of ``ops.search._tiny_map`` (an
    f32 einsum), kept to time and check its replacement against."""
    import jax.numpy as jnp
    from jax import lax

    oh = values[..., None] == lax.broadcasted_iota(
        jnp.int32, values.shape + (256,), values.ndim
    )
    return jnp.einsum(
        '...k,k->...', oh.astype(jnp.float32), table256.astype(jnp.float32)
    ).astype(jnp.int32)


def time_seed_map(idx, packed, lengths) -> None:
    """Seeding stage (bucket ids + limb targets of every duplex lane) of
    the 10k batch, timed with the gather map and with the one-hot map."""
    import jax
    import jax.numpy as jnp

    from pysubstringsearch_jax.ops import search as so

    base, depth = idx._base, idx._depth
    p = jnp.asarray(packed)
    ln = jnp.asarray(lengths)

    def stage(patterns, lens, rank, present):
        both, both_len, thr = so._duplex(patterns, lens)
        raw = jnp.concatenate([patterns, patterns]).astype(jnp.uint8)
        bucket, pp = so._pattern_buckets_ranked(
            raw, both_len, thr, rank, present, base, depth)
        tgt, k_lane, bad = so._ranked_targets(
            raw, both_len, thr, rank, present, idx.num_limbs, depth,
            idx._bits)
        return bucket, pp, tgt, k_lane, bad

    outs = {}
    for name, fn in (('gather', so._tiny_map), ('one-hot', onehot_map)):
        saved = so._tiny_map
        so._tiny_map = fn
        try:
            f = jax.jit(stage)
            jax.block_until_ready(f(p, ln, idx.rank, idx.present))
            secs, out = timed(
                lambda: jax.block_until_ready(
                    f(p, ln, idx.rank, idx.present)), reps=20)
        finally:
            so._tiny_map = saved
        outs[name] = [np.asarray(o) for o in out]
        report(f'seed stage ({name} map), {packed.shape[0]} patterns: '
               f'{secs * 1e6:.1f} us')
    check(all(np.array_equal(a, b)
              for a, b in zip(outs['gather'], outs['one-hot'])),
          'gather and one-hot seed maps disagree')


def time_probe_classes(idx, packed, lengths) -> None:
    """Per-class device probe time for the batch (best of 5, each class
    dispatched alone and waited for)."""
    import jax

    from pysubstringsearch_jax.ops import search as so

    spec, flat = idx._group_batch(packed, lengths)
    keys = idx.probe_class_keys(lengths)
    for key, (Bk, width, deep), (members, sub, sub_len) in zip(
            keys, spec, flat):
        exe = so.phased_class_exec(*key)

        def run():
            return jax.block_until_ready(exe(
                idx.text, idx.lengths, idx.sa, idx.tables, idx.limbs,
                idx.rank, idx.present, sub, sub_len))

        run()
        secs, _ = timed(run, reps=5)
        report(f'probe class width={width} lanes={Bk} deep={deep} '
               f'({members.size} patterns): {secs * 1e3:.3f} ms')


def time_derive(idx) -> typing.List[str]:
    """Warm re-derive of every row's SA (the device-ready critical path),
    with the init sort alone beside it; returns each row's kernel."""
    import jax
    import jax.numpy as jnp

    from pysubstringsearch_jax.ops import search as so
    from pysubstringsearch_jax.ops import suffix_array as sa_ops

    ranked = idx.kind == 'ranked'
    brank = idx.rank if ranked else None
    bits = idx._bits if ranked else None
    init = jax.jit(
        lambda t, n: sa_ops._init_round_anchored_ranked(t, n, brank, bits)
        if ranked else sa_ops._init_round_anchored(t, n))
    kernels = []
    for r, data in enumerate(idx.row_data):
        kernel = so.derive_kernel(idx.n_pad)
        kernels.append(kernel)
        n = jnp.int32(data.size)
        t = idx.text[r]

        def derive():
            return jax.block_until_ready(so.derive_sa(t, n, brank, bits))

        derive()
        secs, _ = timed(derive)
        jax.block_until_ready(init(t, n))
        isecs, _ = timed(lambda: jax.block_until_ready(init(t, n)))
        report(f'derive row {r} ({data.size / MiB:.1f} MiB, pad '
               f'{idx.n_pad / MiB:.0f} MiB, kernel {kernel}'
               f'{"-ranked" if ranked and kernel == "segmented" else ""}): '
               f'{secs:.3f} s warm; init sort {isecs:.3f} s')
    return kernels


def phase_a(corpus: bytes, hits, misses, workdir: str,
            chunk_bytes: int = 8 * MiB, sample: int = 32,
            index_mode: str = 'auto') -> None:
    import jax

    import pysubstringsearch_jax as pss
    from pysubstringsearch_jax import container
    from pysubstringsearch_jax.ops import native
    from pysubstringsearch_jax.ops.hostserve import HostServing
    from pysubstringsearch_jax.ops.search import pack_patterns
    from pysubstringsearch_jax.utils.link import host_device_link

    mb = len(corpus) / 1e6
    corpus_path = os.path.join(workdir, 'corpus.txt')
    with open(corpus_path, 'wb') as f:
        f.write(corpus)
    path = os.path.join(workdir, 'a.idx')
    secs, w = timed(lambda: write_index(path, corpus_path, chunk_bytes))
    report(f'A writer native SA-IS, {chunk_bytes / MiB:g} MiB chunks: '
           f'{mb / secs:.1f} MB/s ({secs:.2f} s for {mb:.1f} MB)')
    jpath = os.path.join(workdir, 'a-jax.idx')
    jsecs, _ = timed(lambda: write_index(jpath, corpus_path, chunk_bytes,
                                         backend='jax'))
    report(f'A writer device SA (jax), {chunk_bytes / MiB:g} MiB chunks: '
           f'{mb / jsecs:.1f} MB/s ({jsecs:.2f} s)')
    cont = container.read_container(path)
    a_chunks = cont.chunks
    j_chunks = container.read_container(jpath).chunks
    check(len(a_chunks) == len(j_chunks) and all(
        np.array_equal(x.suffix_array, y.suffix_array)
        for x, y in zip(a_chunks, j_chunks)),
        'A: device-built container SAs differ from native SA-IS')
    del j_chunks
    os.remove(jpath)

    r, ready_s = ready_reader(path, index_mode=index_mode)
    idx = r._index
    report(f'A device ready {ready_s:.2f} s after Reader(): mode {idx.mode}, '
           f'{idx.num_chunks} rows x pad {idx.n_pad / MiB:.0f} MiB from '
           f'{idx.num_source_chunks} chunks, {idx.num_limbs} {idx.kind} '
           f'limbs; phases (s): '
           f'{ {k: round(v, 3) for k, v in r.profiler.totals.items()} }')
    check(idx.mode == 'derive', f'A: index mode {idx.mode}, want derive')
    check(idx.merged, 'A: rows are not merged')
    kernels = time_derive(idx)
    check(set(kernels) == {'segmented'}, f'A: derive kernels {kernels}')

    # Derived SA of every row == native SA-IS of the row's text.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(8, idx.num_chunks)) as pool:
        want = list(pool.map(native.suffix_array_native, idx.row_data))
    for row, (data, sa) in enumerate(zip(idx.row_data, want)):
        got = np.asarray(idx.sa[row][: data.size])
        check(np.array_equal(got, sa), f'A: derived SA of row {row} differs')
    del want

    # Device probe counts == summed per-source-chunk native counts.
    packed, lengths = pack_patterns(hits)
    hs = HostServing.maybe(a_chunks, cont.buf)
    check(hs is not None, 'A: native host serving unavailable')
    hsecs, (_, host_cnt) = timed(lambda: hs.probe(packed, lengths), reps=3)
    unit = hsecs / (len(hits) * len(a_chunks))
    report(f'A HOST_PROBE_UNIT_S re-measured: {unit * 1e6:.3f} us per '
           f'(query, chunk) ({hsecs:.3f} s for {len(hits)} x '
           f'{len(a_chunks)})')
    per_chunk = [native.probe_batch_native(c.data, c.suffix_array, packed,
                                           lengths)[1] for c in a_chunks]
    check(np.array_equal(np.stack(per_chunk), host_cnt),
          'A: probe_batch_native and probe_multi counts differ')
    _, dev_cnt = idx.probe(packed, lengths)
    want_cnt = np.stack([host_cnt[g].sum(axis=0) for g in idx.groups])
    check(np.array_equal(dev_cnt, want_cnt),
          'A: device probe counts differ from native host counts')
    time_probe_classes(idx, packed, lengths)
    time_seed_map(idx, packed, lengths)

    # search_multiple: device route vs the host path, as multisets.
    strs = [p.decode() for p in hits]
    before = route_counts(r)
    cold, dev_res = timed(lambda: r.search_multiple(strs))
    routes = route_counts(r, before)
    del dev_res  # 21 M strings: freed before the warm run, not during it
    gc.collect()
    warm, dev_res = timed(lambda: r.search_multiple(strs))
    report(f'A search_multiple({len(strs)}): cold {cold:.3f} s, warm '
           f'{warm:.3f} s, {len(dev_res)} lines; routes {routes}')
    check(routes['probe'] > 0, f'A: batch not probed on the device {routes}')
    hsecs, host_res = timed(
        lambda: [x for per in r._search_host_chunks(hits) for x in per])
    report(f'A host path (native, same batch): {hsecs:.3f} s')
    check(collections.Counter(dev_res) == collections.Counter(host_res),
          'A: search_multiple differs from the host path')
    del dev_res, host_res

    # A low-hit batch: the merged-row device extraction's side of the
    # cost model (Reader._host_route_cheaper), timed against the host path.
    rare = make_rare(corpus, len(hits), 0)
    rstrs = [p.decode() for p in rare]
    before = route_counts(r)
    r.search_multiple(rstrs)
    routes = route_counts(r, before)
    rsecs, dev_res = timed(lambda: r.search_multiple(rstrs), reps=3)
    hsecs, host_res = timed(
        lambda: [x for per in r._search_host_chunks(rare) for x in per],
        reps=3)
    report(f'A low-hit search_multiple({len(rare)} x 20 B): {rsecs:.3f} s, '
           f'{len(dev_res)} lines, routes {routes}; host path {hsecs:.3f} s')
    check(collections.Counter(dev_res) == collections.Counter(host_res),
          'A: low-hit search_multiple differs from the host path')
    del dev_res, host_res

    before = route_counts(r)
    check_sample(r, corpus, hits[:sample], misses[:8], 'A')
    report(f'A brute-force sample ({sample} hits, 8 misses) routes '
           f'{route_counts(r, before)}')
    hit = hits[0].decode()
    b1_hit = statistics.median(timed(lambda: r.search(hit))[0]
                               for _ in range(50))
    b1_miss = statistics.median(timed(lambda m=m: r.search(m.decode()))[0]
                                for m in misses)
    idx.probe(packed[:1], lengths[:1])
    probe1 = statistics.median(
        timed(lambda: idx.probe(packed[:1], lengths[:1]))[0]
        for _ in range(20))
    link = host_device_link()
    report(f'A B=1 latency: hit {b1_hit * 1e6:.1f} us, miss '
           f'{b1_miss * 1e6:.1f} us; device probe B=1 {probe1 * 1e6:.1f} us')
    report(f'A link: {link.h2d_mbps:.0f} MB/s up, {link.d2h_mbps:.0f} MB/s '
           f'down, tiny round trip {link.rtt_s * 1e6:.1f} us')
    report(f'A peak_bytes_in_use {peak_bytes()} '
           f'(platform {jax.devices()[0].platform})')
    del r, idx, hs, a_chunks, cont
    gc.collect()
    # Device-ready again in this process: every program is compiled.
    r, ready_s = ready_reader(path, index_mode=index_mode)
    report(f'A device ready {ready_s:.2f} s after a second Reader() (programs '
           f'compiled): phases (s): '
           f'{ {k: round(v, 3) for k, v in r.profiler.totals.items()} }')
    del r
    gc.collect()


# ---------------------------------------------------------------------------
# Phase B: API default geometry (one ~500 MB chunk, rotating doubler)
# ---------------------------------------------------------------------------

def phase_b(corpus: bytes, hits, misses, workdir: str,
            max_chunk_len: typing.Optional[int] = None,
            sample: int = 16, index_mode: str = 'auto') -> str:
    """Returns the SA kernel the derive took (``main`` requires the
    rotating doubler at the reference's size)."""
    from pysubstringsearch_jax.ops import search as so

    corpus_path = os.path.join(workdir, 'corpus.txt')
    path = os.path.join(workdir, 'b.idx')
    mb = len(corpus) / 1e6
    secs, _ = timed(lambda: write_index(path, corpus_path, max_chunk_len))
    report(f'B writer native SA-IS, default chunking: {mb / secs:.1f} MB/s '
           f'({secs:.2f} s)')
    r, ready_s = ready_reader(path, index_mode=index_mode)
    idx = r._index
    kernel = so.derive_kernel(idx.n_pad)
    report(f'B device ready {ready_s:.2f} s after Reader(): {idx.num_chunks} '
           f'row x pad {idx.n_pad / MiB:.0f} MiB, kernel {kernel}, '
           f'{idx.num_limbs} {idx.kind} limbs')
    check(len(r._chunks) == 1 and not idx.merged,
          f'B: {len(r._chunks)} chunks, merged={idx.merged}; want one')
    data = r._chunks[0].data
    check(np.array_equal(np.asarray(idx.sa[0][: data.size]),
                         r._chunks[0].suffix_array),
          'B: derived SA differs from the container SA')
    before = route_counts(r)
    check_sample(r, corpus, hits[:sample], misses[:4], 'B')
    report(f'B brute-force sample routes {route_counts(r, before)}')
    # A batch big enough that the device probe beats host bisection of
    # the one chunk, with few lines each: device probe, then the
    # singleton extraction from the container's SA.
    rare = make_rare(corpus, len(hits), 0)
    strs = [p.decode() for p in rare]
    before = route_counts(r)
    secs, res = timed(lambda: r.search_multiple(strs))
    routes = route_counts(r, before)
    report(f'B low-hit search_multiple({len(strs)} x 20 B) {secs:.3f} s, '
           f'{len(res)} lines; routes {routes}; peak_bytes_in_use '
           f'{peak_bytes()}')
    check(routes['probe'] > 0 and routes['extract'] > 0,
          f'B: device probe and singleton extraction unused {routes}')
    check(collections.Counter(res) == collections.Counter(
        x for per in r._search_host_chunks(rare) for x in per),
        'B: search_multiple differs from the host path')
    del r, idx, res
    gc.collect()
    return kernel


# ---------------------------------------------------------------------------
# Phase C: upload mode on a prefix container
# ---------------------------------------------------------------------------

def phase_c(corpus: bytes, hits, workdir: str, prefix_bytes: int = 64 * MiB,
            chunk_bytes: int = 8 * MiB) -> None:
    from pysubstringsearch_jax.ops import native
    from pysubstringsearch_jax.ops.search import pack_patterns

    cut = corpus.rfind(b'\n', 0, prefix_bytes) + 1
    prefix = corpus[:cut]
    corpus_path = os.path.join(workdir, 'c.txt')
    with open(corpus_path, 'wb') as f:
        f.write(prefix)
    path = os.path.join(workdir, 'c.idx')
    write_index(path, corpus_path, chunk_bytes)
    r, ready_s = ready_reader(path, index_mode='upload')
    idx = r._index
    check(idx.mode == 'upload', f'C: index mode {idx.mode}')
    packed, lengths = pack_patterns(hits)
    _, dev_cnt = idx.probe(packed, lengths)
    want = np.stack([
        native.probe_batch_native(c.data, c.suffix_array, packed, lengths)[1]
        for c in r._chunks])
    check(np.array_equal(dev_cnt, want),
          'C: upload-mode probe counts differ from native host counts')
    strs = [p.decode() for p in hits[:1000]]
    before = route_counts(r)
    secs, res = timed(lambda: r.search_multiple(strs))
    report(f'C upload mode, {len(prefix) / 1e6:.1f} MB in {len(r._chunks)} '
           f'chunks: ready {ready_s:.2f} s; search_multiple({len(strs)}) '
           f'{secs:.3f} s; routes {route_counts(r, before)}')
    check(collections.Counter(res) == collections.Counter(
        x for per in r._search_host_chunks(hits[:1000]) for x in per),
        'C: search_multiple differs from the host path')
    del r, idx, res
    gc.collect()


# ---------------------------------------------------------------------------
# --four: the giant-chunk build and the sharded reader across four cards
# ---------------------------------------------------------------------------

def giant_chunk(corpus: bytes, mesh, giant_bytes: int) -> None:
    """One chunk's SA built across the whole mesh vs native SA-IS."""
    import jax

    from pysubstringsearch_jax.ops import native
    from pysubstringsearch_jax.ops.suffix_array import _pad_len
    from pysubstringsearch_jax.parallel.sharded import make_giant_chunk_build

    devices = list(mesh.devices.flat)
    cut = corpus.rfind(b'\n', 0, giant_bytes) + 1
    text = np.frombuffer(corpus[:cut], dtype=np.uint8)
    N = _pad_len(text.size)
    N = -(-N // len(devices)) * len(devices)
    padded = np.zeros(N, dtype=np.uint8)
    padded[: text.size] = text
    build = make_giant_chunk_build(mesh)
    n = np.int32(text.size)
    cold, sa_full = timed(lambda: jax.block_until_ready(build(padded, n)))
    got = np.asarray(sa_full)[N - text.size:]
    del sa_full
    check(np.array_equal(got, native.suffix_array_native(text)),
          '4: giant-chunk SA differs from native SA-IS')
    warm, _ = timed(lambda: jax.block_until_ready(build(padded, n)))
    report(f'4 giant-chunk SA, {text.size / MiB:.1f} MiB (pad '
           f'{N / MiB:.0f} MiB) over {len(devices)} devices: {cold:.2f} s '
           f'cold (compile included), {warm:.2f} s warm; equals native '
           f'SA-IS; peak_bytes_in_use per card {peak_bytes(devices)}')


def phase_four(corpus: bytes, hits, workdir: str, giant_bytes: int,
               chunk_bytes: int = 8 * MiB, nq: int = 1000,
               devices=None) -> None:
    import jax

    import pysubstringsearch_jax as pss
    from pysubstringsearch_jax.ops.search import pack_patterns
    from pysubstringsearch_jax.parallel.mesh import make_mesh
    from pysubstringsearch_jax.parallel.reader import ShardedReader

    devices = list(devices or jax.devices())
    mesh = make_mesh(devices)
    giant_chunk(corpus, mesh, giant_bytes)

    corpus_path = os.path.join(workdir, 'corpus.txt')
    with open(corpus_path, 'wb') as f:
        f.write(corpus)
    path = os.path.join(workdir, 'four.idx')
    secs, _ = timed(lambda: write_index(path, corpus_path, chunk_bytes))
    report(f'4 writer native SA-IS: {len(corpus) / 1e6 / secs:.1f} MB/s')

    t0 = time.perf_counter()
    sr = ShardedReader(path, mesh, index_mode='derive')
    sidx = sr._index
    report(f'4 ShardedReader ready {time.perf_counter() - t0:.2f} s: '
           f'{sr._num_real} real rows of {sidx.num_chunks} over '
           f'{len(devices)} devices, pad {sidx.n_pad / MiB:.0f} MiB, '
           f'{sidx.num_limbs} {sidx.kind} limbs')
    check(sr._num_real >= len(devices),
          f'4: {sr._num_real} rows cannot occupy {len(devices)} devices')
    rows_per_dev = sidx.num_chunks // len(devices)
    held = collections.Counter()
    total = 0
    for name in ('text', 'sa', 'limbs', 'tables'):
        arr = getattr(sidx, name)
        total += arr.nbytes
        shards = arr.addressable_shards
        check(len({s.device for s in shards}) == len(devices) and all(
            s.data.shape[0] == rows_per_dev for s in shards),
            f'4: {name} is not split by rows over the mesh')
        for s in shards:
            held[s.device] += s.data.nbytes
    in_use = mem_stat('bytes_in_use', devices)
    report(f'4 after load: index {total} bytes in all, shards per card '
           f'{[held[d] for d in devices]}; bytes_in_use per card {in_use}; '
           f'peak_bytes_in_use per card {peak_bytes(devices)}')
    # A card holding every row would use at least the whole index.
    check(all(u < total / 2 for u in in_use if u >= 0),
          f'4: a card holds over half the index ({in_use} of {total})')
    packed, lengths = pack_patterns(hits[:nq])
    _, s_cnt = sidx.probe(packed, lengths)
    strs = [p.decode() for p in hits[:nq]]
    ssecs, s_res = timed(lambda: sr.search_multiple(strs))
    report(f'4 sharded search_multiple({nq}) {ssecs:.3f} s, {len(s_res)} '
           f'lines; after it bytes_in_use per card '
           f'{mem_stat("bytes_in_use", devices)}, peak_bytes_in_use per card '
           f'{peak_bytes(devices)}')
    del sr, sidx
    gc.collect()

    t0 = time.perf_counter()
    r = pss.Reader(path, index_mode='derive')
    idx = r._index
    report(f'4 one-card Reader ready {time.perf_counter() - t0:.2f} s: '
           f'{idx.num_chunks} rows; bytes_in_use per card '
           f'{mem_stat("bytes_in_use", devices)}')
    _, cnt = idx.probe(packed, lengths)
    check(np.array_equal(s_cnt[: idx.num_chunks], cnt),
          '4: sharded probe counts differ from the one-card Reader')
    secs, res = timed(lambda: r.search_multiple(strs))
    report(f'4 one-card search_multiple({nq}) {secs:.3f} s')
    check(collections.Counter(s_res) == collections.Counter(res),
          '4: ShardedReader results differ from the one-card Reader')
    report(f'4 peak_bytes_in_use per card {peak_bytes(devices)}')
    del r, idx, s_res, res
    gc.collect()


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--mb', type=float, default=500.0,
                    help='corpus MiB for phases A-C (reference: 500 MB)')
    ap.add_argument('--queries', type=int, default=10_000)
    ap.add_argument('--four', action='store_true',
                    help='run only the four-card sharded phase')
    ap.add_argument('--four-mb', type=float, default=2048.0)
    ap.add_argument('--giant-mb', type=float, default=64.0)
    args = ap.parse_args(argv)

    from pysubstringsearch_jax.ops import native
    from pysubstringsearch_jax.ops.search import SEGMENTED_MAX_PAD
    from pysubstringsearch_jax.utils.compile_cache import enable_compile_cache
    from pysubstringsearch_jax.utils.device import nvidia_smi, require_gpu

    CARD = nvidia_smi().replace('\n', '; ')
    note(f'nvidia-smi name, power.limit: {CARD}')
    import jax

    dev = jax.devices()[0]
    note(f'jax {jax.__version__}: platform {dev.platform}, device_kind '
         f'{dev.device_kind}, {len(jax.devices())} device(s)')
    device = require_gpu()
    want = 4 if args.four else 1
    check(device['count'] >= want,
          f'{device["count"]} device(s), this run needs {want}')
    note(f'compile cache: {enable_compile_cache()}')
    native.require()

    workdir = tempfile.mkdtemp(prefix='chip_smoke-')
    try:
        t0 = time.perf_counter()
        corpus = make_corpus(args.four_mb if args.four else args.mb,
                             args.seed)
        hits, misses = make_queries(corpus, args.queries, args.seed)
        report(f'corpus {len(corpus) / 1e6:.1f} MB, {len(hits)} patterns + '
               f'{len(misses)} misses, made in '
               f'{time.perf_counter() - t0:.1f} s')
        if args.four:
            phase_four(corpus, hits, workdir, int(args.giant_mb * MiB))
        else:
            phase_a(corpus, hits, misses, workdir)
            kernel = phase_b(corpus, hits, misses, workdir)
            if len(corpus) > SEGMENTED_MAX_PAD:
                check(kernel == 'rotating',
                      f'B: derive kernel {kernel}, want rotating')
            phase_c(corpus, hits, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': device['platform'], 'kind': device['kind'],
        'count': len(jax.devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
