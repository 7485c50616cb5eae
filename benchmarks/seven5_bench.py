"""The reference's 7.5 GB ladder rung, measured (BASELINE.md row 3-4).

The reference publishes a second benchmark table at 7500 MB
(reference README.md:52-59): search('google') in 10.1 ms (62,834
results) and a 200 us miss.  This script builds the same-scale index with
this framework (default 512 MiB chunks — the reference's chunking), then
measures the serving ladder against it:

  - container open time (mmap parse),
  - frequent-word HIT latency + result count (the search('google') analog:
    vocabulary words appear ~M times across the corpus),
  - MISS latency (the search('text_two') analog),
  - a batched 10k-query end-to-end run.

Both run on the host only (native SA-IS build, native host serving); no
device is opened.  The corpus generator is the vectorized twin of
bench.py's: random 3-11 letter words, 8 per line, so word-frequency
structure matches the published configuration's spirit.  Results are
printed as JSON.

Env: BENCH75_MB (default 7500), BENCH75_DIR (cache; default
build/bench-7500mb-512chunk under the checkout), BENCH75_QUERIES (default
10000).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MB = int(os.environ.get('BENCH75_MB', '7500'))
CACHE = os.environ.get(
    'BENCH75_DIR', os.path.join(REPO, 'build', f'bench-{MB}mb-512chunk')
)
NQ = int(os.environ.get('BENCH75_QUERIES', '10000'))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_vocab(rng):
    nwords = 10_000
    lens = rng.integers(3, 12, size=nwords)
    return [
        bytes(rng.integers(97, 123, size=l, dtype=np.uint8)) for l in lens
    ]


def make_corpus_file(path: str, mb: int, seed: int = 0):
    """Vectorized word-corpus generator: ~256 MB blocks of random words
    (space-separated, 8 per line).  Returns the vocabulary."""
    rng = np.random.default_rng(seed)
    words = make_vocab(rng)
    blob = b''.join(w + b' ' for w in words)
    wb = np.frombuffer(blob, dtype=np.uint8)
    seg_lens = np.array([len(w) + 1 for w in words], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(seg_lens)[:-1]))
    target = mb << 20
    t0 = time.time()
    with open(path, 'wb') as f:
        written = 0
        block_words = int((256 << 20) / float(seg_lens.mean()))
        while written < target:
            idx = rng.integers(0, len(words), size=block_words)
            ls = seg_lens[idx]
            tot = int(ls.sum())
            firsts = np.cumsum(ls) - ls
            flat = np.repeat(starts[idx] - firsts, ls) + np.arange(
                tot, dtype=np.int64
            )
            out = wb[flat]
            sep = np.cumsum(ls) - 1
            nl = sep[7::8]
            out[nl] = 0x0A
            end = int(nl[-1]) + 1  # end the block on a line boundary
            f.write(out[:end].tobytes())
            written += end
    log(f'corpus: {written / (1 << 20):.0f} MiB in {time.time() - t0:.0f}s')
    return words


def build(corpus_path: str, idx_path: str) -> float:
    """Build in a subprocess; returns build seconds (Writer wall)."""
    code = (
        'import sys, time\n'
        f'sys.path.insert(0, {REPO!r})\n'
        'import pysubstringsearch_jax as pss\n'
        't0 = time.time()\n'
        f'w = pss.Writer({idx_path!r}, sa_backend="native")\n'
        f'w.add_entries_from_file_lines({corpus_path!r})\n'
        'w.finalize(); w.close()\n'
        'print(time.time() - t0)\n'
    )
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, '-c', code], capture_output=True, text=True
    )
    if r.returncode != 0:
        log(r.stderr[-2000:])
        raise RuntimeError('build subprocess failed')
    secs = float(r.stdout.strip().splitlines()[-1])
    log(f'build: {secs:.0f}s writer wall ({time.time() - t0:.0f}s subprocess)'
        f' -> {MB / secs:.1f} MB/s')
    return secs


def pick_patterns(words, hs, rng):
    """A frequent vocabulary word (the 'google' analog), a rare-ish one,
    and misses."""
    # Probe a sample of vocabulary words for their hit counts.
    sample = [words[i] for i in rng.choice(len(words), size=64, replace=False)]
    from pysubstringsearch_jax.ops.hostserve import pack_patterns_host

    packed, lens = pack_patterns_host(sample)
    _, cnt = hs.probe(packed, lens)
    tot = cnt.astype(np.int64).sum(axis=0)
    freq_i = int(np.argmax(tot))
    med_i = int(np.argsort(tot)[len(sample) // 2])
    return sample[freq_i], sample[med_i]


def serve(idx_path: str, words) -> dict:
    import jax

    jax.config.update('jax_platforms', 'cpu')  # host-serving measurement
    from pysubstringsearch_jax import container
    from pysubstringsearch_jax.ops.hostserve import HostServing

    res = {}
    t0 = time.perf_counter()
    cont = container.read_container(idx_path)
    res['open_s'] = time.perf_counter() - t0
    hs = HostServing.maybe(cont.chunks, cont.buf)
    assert hs is not None
    res['chunks'] = len(cont.chunks)
    rng = np.random.default_rng(7)
    freq, med = pick_patterns(words, hs, rng)

    def p50(fn, reps):
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return float(np.percentile(ts, 50))

    # Warm the page cache over the touched regions first.
    n_hit = len(hs.search([freq])[0])
    hs.search([med])
    res['hit_word'] = freq.decode()
    res['hit_results'] = n_hit
    res['hit_p50_ms'] = p50(lambda: hs.search([freq]), 20) * 1e3
    res['med_word'] = med.decode()
    res['med_results'] = len(hs.search([med])[0])
    res['med_p50_ms'] = p50(lambda: hs.search([med]), 20) * 1e3
    miss = [b'zzzzqqqqx%d' % i for i in range(50)]
    for m in miss[:10]:
        hs.search([m])
    it = iter(miss * 10)
    res['miss_p50_us'] = p50(lambda: hs.search([next(it)]), 200) * 1e6
    # Batched end-to-end: random corpus substrings like bench.py.
    datas = [c.data for c in cont.chunks]
    pats = []
    for _ in range(NQ):
        c = datas[int(rng.integers(0, len(datas)))]
        off = int(rng.integers(0, c.size - 16))
        pats.append(bytes(c[off: off + int(rng.integers(4, 13))]))
    t0 = time.perf_counter()
    out = hs.search(pats)
    res['batch_queries'] = NQ
    res['batch_s'] = time.perf_counter() - t0
    res['batch_lines'] = int(sum(len(x) for x in out))
    return res


def main():
    os.makedirs(CACHE, exist_ok=True)
    corpus = os.path.join(CACHE, 'corpus.txt')
    idx = os.path.join(CACHE, 'corpus.idx')
    meta_p = os.path.join(CACHE, 'meta.json')
    if os.path.exists(meta_p) and os.path.exists(idx):
        meta = json.load(open(meta_p))
        words = [bytes.fromhex(h) for h in meta['words']]
        build_s = meta['build_s']
        log('using cached 7.5 GB index')
    else:
        if (
            os.path.exists(corpus)
            and os.path.getsize(corpus) >= (MB << 20)
        ):
            log('using cached corpus')
            words = make_vocab(np.random.default_rng(0))
        else:
            words = make_corpus_file(corpus, MB)
        build_s = build(corpus, idx)
        json.dump(
            {'build_s': build_s, 'words': [w.hex() for w in words]},
            open(meta_p, 'w'),
        )
    res = serve(idx, words)
    res['corpus_mb'] = MB
    res['build_s'] = build_s
    res['build_mbps'] = MB / build_s
    res['reference'] = {
        'hit_ms': 10.1, 'hit_results': 62834, 'miss_us': 200.0,
        'source': 'reference README.md:52-59 (hardware unspecified)',
    }
    print(json.dumps(res, indent=1))


if __name__ == '__main__':
    main()
