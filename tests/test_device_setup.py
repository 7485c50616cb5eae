"""Device-facing plumbing that CPU runs can check: the seed-stage byte map,
the compile-cache location, the keyed native build, the device memory
budget, and the measured-link record."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysubstringsearch_jax.models.index import DeviceIndex
from pysubstringsearch_jax.ops import native
from pysubstringsearch_jax.ops import search as search_ops
from pysubstringsearch_jax.utils import compile_cache
from pysubstringsearch_jax.utils.link import Link, host_device_link


def test_tiny_map_equals_onehot_on_all_bytes():
    """The gather map replaces the former f32 one-hot contraction; both
    agree on every byte value, for alphabet-rank tables and for wide
    integer tables."""
    from chip_smoke import onehot_map

    rng = np.random.default_rng(0)
    present = rng.random(256) < 0.2
    rank, _ = search_ops.alphabet_rank(present)
    values = jnp.arange(256, dtype=jnp.int32).reshape(16, 16)
    for table in (rank, present.astype(np.int32),
                  rng.integers(0, 1 << 20, size=256).astype(np.int32)):
        t = jnp.asarray(table)
        got = np.asarray(search_ops._tiny_map(values, t))
        assert np.array_equal(got, np.asarray(onehot_map(values, t)))
        assert np.array_equal(got.reshape(-1), table)


@pytest.mark.parametrize('env', [None, 'custom'])
def test_compile_cache_dir(env, tmp_path, monkeypatch):
    if env is None:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        want = os.path.join(compile_cache._CHECKOUT, '.jax_cache')
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', want)
    assert compile_cache.cache_dir() == want
    assert os.path.isfile(
        os.path.join(compile_cache._CHECKOUT, 'pysubstringsearch_jax',
                     '__init__.py'))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update('jax_compilation_cache_dir', old)


def test_native_build_key_rebuilds_when_key_differs(tmp_path):
    """A library is found again only under its own key: another CPU, source
    or command builds (and loads) a fresh file beside it."""
    src = tmp_path / 'k.c'
    src.write_text('int answer(void) { return 42; }\n')
    cmd = ('gcc', '-O1', '-shared', '-fPIC')
    a = native.build_library(str(src), 'k', cmd, cpu_flags='avx512f')
    mtime = os.path.getmtime(a)
    assert native.build_library(str(src), 'k', cmd, cpu_flags='avx512f') == a
    assert os.path.getmtime(a) == mtime  # same key: not rebuilt
    b = native.build_library(str(src), 'k', cmd, cpu_flags='neon')
    src.write_text('int answer(void) { return 43; }\n')
    c = native.build_library(str(src), 'k', cmd, cpu_flags='neon')
    d = native.build_library(str(src), 'k', (*cmd, '-O2'), cpu_flags='neon')
    assert len({a, b, c, d}) == 4
    assert all(os.path.exists(p) for p in (a, b, c, d))
    assert os.path.dirname(a) == str(tmp_path / '.build')
    import ctypes

    assert ctypes.CDLL(c).answer() == 43


def test_native_build_failure_is_reported(tmp_path):
    src = tmp_path / 'bad.c'
    src.write_text('this is not C\n')
    with pytest.raises(RuntimeError, match='failed building'):
        native.build_library(str(src), 'bad', ('gcc', '-shared', '-fPIC'))


def test_native_require_passes_here():
    native.require()
    assert native.available() and native.fastext() is not None


def _fake_devices(stats):
    dev = types.SimpleNamespace(
        platform='gpu', device_kind='Fake accelerator',
        memory_stats=lambda: stats,
    )
    return lambda *a, **k: [dev]


def test_hbm_budget_raises_without_bytes_limit(monkeypatch):
    monkeypatch.setattr(jax, 'devices', _fake_devices({}))
    with pytest.raises(RuntimeError, match='bytes_limit'):
        DeviceIndex._device_hbm_budget()
    monkeypatch.setattr(jax, 'devices', _fake_devices(None))
    with pytest.raises(RuntimeError, match='Fake accelerator'):
        DeviceIndex._device_hbm_budget()


def test_hbm_budget_uses_reported_limit(monkeypatch):
    monkeypatch.setattr(jax, 'devices',
                        _fake_devices({'bytes_limit': 80 << 30}))
    assert DeviceIndex._device_hbm_budget() == int((80 << 30) * 0.85)


def test_link_on_cpu_is_free():
    link = host_device_link()
    assert isinstance(link, Link)
    assert link.rtt_s == 0.0 and link.d2h_mbps == float('inf')
