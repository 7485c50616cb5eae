"""Multi-chip sharding tests on the virtual 8-device CPU mesh: sharded SA
build and sharded probe must agree with the single-device reference path."""

import numpy as np
import pytest

import jax

from pysubstringsearch_jax.ops.search import pack_patterns
from pysubstringsearch_jax.ops.suffix_array import suffix_array_numpy, _pad_len
from pysubstringsearch_jax.parallel import mesh as mesh_lib
from pysubstringsearch_jax.parallel import sharded


def make_corpus_chunks(num_chunks, seed=0):
    rng = np.random.default_rng(seed)
    words = [b'alpha', b'beta', b'gamma', b'delta', b'epsilon', b'zeta']
    chunks = []
    for _ in range(num_chunks):
        lines = []
        for _ in range(int(rng.integers(5, 30))):
            k = int(rng.integers(1, 5))
            lines.append(b' '.join(words[i] for i in rng.choice(len(words), size=k)))
        chunks.append(b'\n'.join(lines) + b'\n')
    return chunks


def stack_chunks(raw_chunks):
    from pysubstringsearch_jax.ops.search import PAD_MARGIN

    n_pad = _pad_len(max(len(c) for c in raw_chunks) + PAD_MARGIN)
    C = len(raw_chunks)
    text = np.zeros((C, n_pad), dtype=np.uint8)
    n = np.zeros((C,), dtype=np.int32)
    for i, c in enumerate(raw_chunks):
        text[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        n[i] = len(c)
    return text, n


@pytest.fixture(scope='module')
def eight_device_mesh():
    if len(jax.devices()) < 2:
        pytest.skip('needs multi-device backend')
    return mesh_lib.make_mesh()


def test_sharded_build_matches_host(eight_device_mesh):
    raw = make_corpus_chunks(8)
    text, n = stack_chunks(raw)
    build = sharded.make_sharded_build(eight_device_mesh)
    sa = np.asarray(build(text, n))
    for i, c in enumerate(raw):
        expected = suffix_array_numpy(np.frombuffer(c, dtype=np.uint8))
        np.testing.assert_array_equal(sa[i, : len(c)], expected)


def test_sharded_probe_matches_host(eight_device_mesh):
    raw = make_corpus_chunks(8, seed=1)
    text, n = stack_chunks(raw)
    build = sharded.make_sharded_build(eight_device_mesh)
    sa = build(text, n)
    patterns, lengths = pack_patterns([b'alpha', b'beta beta', b'zeta', b'nope'])
    probe = sharded.make_sharded_probe(eight_device_mesh)
    out = np.asarray(probe(text, n, sa, patterns, lengths))  # [C, B, 2]
    for i, c in enumerate(raw):
        for b, pat in enumerate([b'alpha', b'beta beta', b'zeta', b'nope']):
            # Count matching suffixes by brute force.
            expected = sum(
                1 for s in range(len(c)) if c[s : s + len(pat)] == pat
            )
            assert out[i, b, 1] == expected, (i, pat, out[i, b])


def _giant_text(kind, n):
    rng = np.random.default_rng(7)
    if kind == 'random':
        return rng.integers(97, 105, size=n, dtype=np.uint8)
    if kind == 'one-byte':  # every rank tied until k passes n
        return np.full(n, ord('a'), dtype=np.uint8)
    raw = b''.join(make_corpus_chunks(40, seed=3))
    return np.frombuffer(raw[:n], dtype=np.uint8)


@pytest.mark.parametrize('kind', ['random', 'one-byte', 'words'])
@pytest.mark.parametrize('num_devices', [8, 4, 1])
def test_giant_chunk_build_sharded(eight_device_mesh, kind, num_devices):
    # One chunk's SA built across the mesh (intra-chunk sharding: the text
    # is split into per-device blocks and the sorts run as block sorts).
    mesh = mesh_lib.make_mesh(jax.devices()[:num_devices])
    n, N = 3000, 4096
    data = _giant_text(kind, n)
    padded = np.zeros(N, np.uint8)
    padded[:n] = data
    build = sharded.make_giant_chunk_build(mesh)
    sa_full = np.asarray(build(padded, np.int32(n)))
    np.testing.assert_array_equal(sa_full[N - n :], suffix_array_numpy(data))


def test_giant_chunk_build_keeps_blocks_split(eight_device_mesh):
    """No device of the giant-chunk build holds the whole text's arrays:
    the only all-gathers carry one scalar per device, and the per-device
    scratch shrinks as the mesh grows."""
    import re

    N = 1 << 16
    temps = {}
    for d in (1, 4):
        build = sharded.make_giant_chunk_build(
            mesh_lib.make_mesh(jax.devices()[:d]))
        c = build.lower(np.zeros(N, np.uint8), np.int32(N // 2)).compile()
        temps[d] = c.memory_analysis().temp_size_in_bytes
        if d == 4:
            gathers = re.findall(r'= (\S+) all-gather\(', c.as_text())
            assert gathers and set(gathers) == {'s32[4]{0}'}, gathers
    assert temps[4] < temps[1] / 1.5, temps


def test_full_step_counts(eight_device_mesh):
    raw = make_corpus_chunks(16, seed=2)  # 2 chunks per device
    text, n = stack_chunks(raw)
    patterns, lengths = pack_patterns([b'alpha', b'qqq'])
    step = sharded.make_full_step(eight_device_mesh)
    bounds, totals = step(text, n, patterns, lengths)
    bounds, totals = np.asarray(bounds), np.asarray(totals)
    expected_alpha = sum(
        1 for c in raw for s in range(len(c)) if c[s : s + 5] == b'alpha'
    )
    assert totals[0] == expected_alpha
    assert totals[1] == 0
    assert bounds.shape == (16, 2, 2)
    assert bounds[:, 0, 1].sum() == expected_alpha


def test_sharded_probe_megachunk_loop_form(eight_device_mesh):
    """The sharded probe's loop-form bisection (probe_bounds_loop) on
    production-sized data: 8 chunks of >= 1 M chars each, probed through
    the shard_map path and checked against host ground truth.  The sharded
    kernels use the loop-form probe (one small program per geometry), not
    the unrolled compile-heavy one."""
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(97, 110, size=int(l), dtype=np.uint8))
             for l in rng.integers(3, 9, size=50)]
    raw = []
    for c in range(8):
        parts = []
        size = 0
        while size < 1_100_000:
            line = b' '.join(
                words[i] for i in rng.integers(0, len(words), size=8))
            parts.append(line)
            size += len(line) + 1
        raw.append(b'\n'.join(parts) + b'\n')
    text, n = stack_chunks(raw)
    # Host-built SAs (the numpy spec backend) probed on the mesh.
    n_pad = text.shape[1]
    sa = np.zeros((len(raw), n_pad), dtype=np.int32)
    for i, c in enumerate(raw):
        sa[i, : len(c)] = suffix_array_numpy(
            np.frombuffer(c, dtype=np.uint8))
    pats = [b'alpha-none', words[0], words[1][:2], b'zzzz', b' ']
    packed, lens = pack_patterns(pats)
    probe = sharded.make_sharded_probe(eight_device_mesh)
    out = np.asarray(probe(text, n, sa, packed, lens))  # [C, B, 2]
    for i, c in enumerate(raw):
        for b, p in enumerate(pats):
            exp = c.count(p) if p else len(c)
            # count occurrences at distinct SA positions == substring count
            got = int(out[i, b, 1])
            assert got == exp, (i, p, got, exp)
