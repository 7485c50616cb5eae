"""Host-side simulation of phased-probe step counts on the bench corpus.

Computes, for the exact corpus/pattern distribution bench.py uses, the
per-phase tie-range widths and the iteration counts a phased probe would
need under three midpoint policies: pure binary, alternating
binary/interpolated, and interpolation-with-binary-guard.  The probe's
device cost scales with iterations x 2B x C gathers, so this decides the
midpoint policy from host arithmetic alone.
"""

import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import make_corpus  # noqa: E402


def log(*a):
    print(*a, flush=True)


def main():
    mb = int(os.environ.get('SIM_MB', '64'))
    nq = 10000
    corpus, _ = make_corpus(mb)
    data = np.frombuffer(corpus, dtype=np.uint8)
    n = data.size
    log(f'corpus {n/1e6:.1f} MB')

    # 12-byte keys of every position: digits (byte+1, past-end 0), packed as
    # (u64 of digits 0..6, u64 of digits 7..11) both base 258.
    t0 = time.time()
    d = np.zeros(n + 16, dtype=np.uint64)
    d[:n] = data.astype(np.uint64) + 1
    k1 = np.zeros(n, dtype=np.uint64)
    for j in range(7):
        k1 = k1 * 258 + d[j : n + j]
    k2 = np.zeros(n, dtype=np.uint64)
    for j in range(7, 12):
        k2 = k2 * 258 + d[j : n + j]
    order = np.lexsort((k2, k1))
    k1s = k1[order]
    k2s = k2[order]
    del k1, k2, order
    log(f'key sort {time.time()-t0:.1f}s')

    rng = np.random.default_rng(1)
    offs = rng.integers(0, len(corpus) - 16, size=nq)
    lens = rng.integers(4, 13, size=nq)
    pats = [corpus[o : o + l].replace(b'\n', b'x') for o, l in zip(offs, lens)]

    def prefix_range(p, depth):
        """(lo, hi) slots whose first `depth` digits match p (depth <= 12)."""
        dd = np.zeros(12, dtype=np.uint64)
        for i, b in enumerate(p[:depth]):
            dd[i] = b + 1
        lo1 = hi1 = np.uint64(0)
        for j in range(7):
            lo1 = lo1 * 258 + (dd[j] if j < depth else 0)
            hi1 = hi1 * 258 + (dd[j] if j < depth else 257)
        lo = np.searchsorted(k1s, lo1, 'left')
        hi = np.searchsorted(k1s, hi1, 'right')
        if depth <= 7:
            return lo, hi
        lo2 = hi2 = np.uint64(0)
        for j in range(7, 12):
            lo2 = lo2 * 258 + (dd[j] if j < depth else 0)
            hi2 = hi2 * 258 + (dd[j] if j < depth else 257)
        lo = lo + np.searchsorted(k2s[lo:hi], lo2, 'left')
        hi = lo + np.searchsorted(k2s[lo:hi], hi2, 'right') - np.searchsorted(
            k2s[lo:hi], lo2, 'left')
        # recompute cleanly
        return lo, hi

    # Phase depths: bucket table depth 3 seeds; limbs cover (3,6], (6,9],
    # (9,12].
    DEPTHS = [3, 6, 9, 12]
    t0 = time.time()
    widths = np.zeros((nq, len(DEPTHS)), dtype=np.int64)
    ranges = []
    for i, p in enumerate(pats):
        row = []
        for j, dep in enumerate(DEPTHS):
            if len(p) >= dep or j == 0 or len(p) > DEPTHS[j - 1]:
                lo, hi = prefix_range(p, min(dep, len(p)))
                widths[i, j] = hi - lo
                row.append((lo, hi))
            else:
                widths[i, j] = -1
                row.append(None)
        ranges.append(row)
        if i % 2000 == 0:
            log(f'  pattern {i} ({time.time()-t0:.0f}s)')
    log(f'ranges {time.time()-t0:.1f}s')

    def binary_steps(w):
        return 0 if w <= 1 else int(math.ceil(math.log2(w))) + 1

    # Iteration counts per pattern: each phase bisects the PREVIOUS depth's
    # tie range; lower/upper lanes run concurrently so a phase costs the max
    # of the two searches ~ log2(prev width).
    def simulate(policy):
        iters = np.zeros(nq, dtype=np.int64)
        for i, p in enumerate(pats):
            total = 0
            prev = widths[i, 0]  # bucket width after table seed
            for j, dep in enumerate(DEPTHS[1:], start=1):
                if len(p) <= DEPTHS[j - 1]:
                    break
                w = prev
                if w <= 1:
                    prev = widths[i, j] if widths[i, j] >= 0 else 1
                    continue
                if policy == 'binary':
                    total += binary_steps(w)
                else:
                    # Simulate the value-space search on the sorted keys.
                    lo, hi = ranges[i][j - 1]
                    dep_lo = DEPTHS[j - 1]
                    # phase target digits: bytes dep_lo..dep-1
                    span = min(dep, len(p)) - dep_lo
                    tgt = 0
                    for b in p[dep_lo : dep_lo + span]:
                        tgt = tgt * 258 + (b + 1)
                    for _ in range(3 - span):
                        tgt = tgt * 258  # lower-bound pads (0)
                    # values: 3-digit pack at depth dep_lo per slot
                    def val(s):
                        if dep_lo < 7 and dep <= 7:
                            shift = 258 ** (7 - dep)
                            mod = 258 ** 3
                            return int(k1s[s] // shift % mod)
                        # spans the k1/k2 boundary or within k2
                        full = int(k1s[s]) * (258 ** 5) + int(k2s[s])
                        shift = 258 ** (12 - dep)
                        return full // shift % (258 ** 3)
                    a, b_ = int(lo), int(hi)
                    vlo, vhi = -1, 258 ** 3
                    steps = 0
                    toggle = policy == 'alternate'
                    use_interp = True
                    while a < b_ and steps < 80:
                        steps += 1
                        if use_interp and vhi > vlo + 1:
                            frac = (tgt - vlo) / (vhi - vlo)
                            mid = a + int(frac * (b_ - a))
                            mid = min(max(mid, a), b_ - 1)
                        else:
                            mid = (a + b_) // 2
                        if toggle:
                            use_interp = not use_interp
                        v = val(mid)
                        if v >= tgt:
                            b_ = mid
                            vhi = min(vhi, v)
                        else:
                            a = mid + 1
                            vlo = max(vlo, v)
                    total += steps
                prev = widths[i, j] if widths[i, j] >= 0 else 1
            iters[i] = total
        return iters

    report = {}
    for policy in ('binary', 'alternate', 'interp'):
        t0 = time.time()
        it = simulate(policy)
        report[policy] = it
        log(f'{policy}: mean {it.mean():.1f}  p90 {np.percentile(it, 90):.0f} '
            f' p99 {np.percentile(it, 99):.0f}  max {it.max()} '
            f'({time.time()-t0:.0f}s)')

    # Current-production comparison: one combined-key bisection over the
    # bucket range gathering k_used limbs per step.
    cur = np.array([binary_steps(w) for w in widths[:, 0]])
    k_used = 4
    log(f'current scheme: steps mean {cur.mean():.1f} max {cur.max()} '
        f'-> element-steps mean {k_used*cur.mean():.1f} (phased=1/step)')
    log(f'bucket widths: mean {widths[:,0].mean():.0f} '
        f'p99 {np.percentile(widths[:,0],99):.0f} max {widths[:,0].max()}')


if __name__ == '__main__':
    main()
