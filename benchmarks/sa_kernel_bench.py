"""Single-core native SA kernel benchmark on the bench corpus.

Builds one 64 MiB chunk of the canonical bench corpus and times
pss_build_sa_u8 (best of N reps), printing MB/s and, with
PSS_SA_PROFILE=1, the kernel's own phase table.  Used for A/B work on
native/sais.cpp.
"""
import ctypes
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import make_corpus  # noqa: E402

MB = int(os.environ.get('SA_BENCH_MB', '64'))
REPS = int(os.environ.get('SA_BENCH_REPS', '3'))

corpus, _ = make_corpus(max(MB, 64))
data = np.frombuffer(corpus[: MB * 1024 * 1024], dtype=np.uint8).copy()
n = data.shape[0]

lib = ctypes.CDLL(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native', 'libpss.so'))
lib.pss_build_sa_u8.restype = ctypes.c_int32
lib.pss_build_sa_u8.argtypes = [
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int32)]

sa = np.empty(n, dtype=np.int32)
dptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
sptr = sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

best = 1e9
for r in range(REPS):
    t0 = time.perf_counter()
    rc = lib.pss_build_sa_u8(dptr, n, sptr)
    dt = time.perf_counter() - t0
    assert rc == 0, rc
    best = min(best, dt)
    print(f'rep {r}: {dt:.3f}s  {n / 1e6 / dt:.2f} MB/s', file=sys.stderr)

print(f'best: {best:.3f}s  {n / 1e6 / best:.2f} MB/s  (n={n})')
# quick spot correctness: SA is a permutation and locally sorted at samples
assert np.unique(sa).shape[0] == n
rng = np.random.default_rng(0)
for i in rng.integers(1, n, size=200):
    a, b = sa[i - 1], sa[i]
    assert data.tobytes()[a:a + 64] <= data.tobytes()[b:b + 64], i
