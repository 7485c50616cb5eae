"""ctypes loader for the native C++ host kernels (native/sais.cpp).

Both native modules are compiled from the committed sources on the machine
that loads them, the first time they are needed.  Each build lands in a
git-ignored ``.build/`` directory beside its source, under a file name
keyed by a hash of the source, the compile command and the host CPU's
feature flags (the kernels use ``-march=native``), so a library built on
another machine or from other sources is never loaded.  Without a compiler
the callers fall back to the numpy / JAX backends; :func:`require` turns
that fallback into an error for paths where the native kernels are part of
the contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import sysconfig
import threading
import typing

import numpy as np

_LOCK = threading.Lock()
_LIB: typing.Optional[ctypes.CDLL] = None
_TRIED = False
#: Why the last build or load failed (surfaced by :func:`require`).
_ERRORS: typing.Dict[str, str] = {}

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)


def _find_source(name: str) -> typing.Optional[str]:
    """Source-checkout layout first, then the copy a wheel ships."""
    for d in (os.path.join(_REPO_ROOT, 'native'),
              os.path.join(_PKG_ROOT, '_native')):
        path = os.path.join(d, name)
        if os.path.exists(path):
            return path
    return None


def _cpu_flags() -> str:
    """The host CPU's feature flags (what ``-march=native`` compiles for)."""
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('flags', 'Features')):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return platform.machine() + ' ' + platform.processor()


def build_key(src: str, cmd: typing.Sequence[str], cpu_flags: str) -> str:
    """Hash naming one build: source bytes, compile command, CPU flags."""
    h = hashlib.sha256()
    with open(src, 'rb') as f:
        h.update(f.read())
    for part in (*cmd, cpu_flags):
        h.update(part.encode() + b'\0')
    return h.hexdigest()[:16]


def build_library(
    src: str,
    stem: str,
    cmd: typing.Sequence[str],
    cpu_flags: typing.Optional[str] = None,
) -> str:
    """Compile ``src`` (``cmd`` + ``-o OUT SRC``) into its keyed path under
    ``<dir of src>/.build/`` unless that exact build exists; returns the
    path.  Concurrent processes serialise on a lock file and the output is
    renamed into place, so a half-written library is never visible."""
    import fcntl

    key = build_key(src, cmd, _cpu_flags() if cpu_flags is None else cpu_flags)
    out_dir = os.path.join(os.path.dirname(src), '.build')
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f'{stem}-{key}.so')
    if os.path.exists(out):
        return out
    with open(os.path.join(out_dir, f'{stem}.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f'{out}.{os.getpid()}.tmp'
            proc = subprocess.run(
                [*cmd, '-o', tmp, src], capture_output=True, text=True,
                timeout=600,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f'{cmd[0]} failed building {src}:\n{proc.stderr[-4000:]}'
                )
            os.replace(tmp, out)
    return out


_SAIS_CMD = ('g++', '-O3', '-std=c++17', '-shared', '-fPIC', '-march=native',
             '-pthread')


def _build(name: str, stem: str, cmd: typing.Sequence[str]):
    src = _find_source(name)
    if src is None:
        _ERRORS[stem] = f'source {name} not found'
        return None
    try:
        return build_library(src, stem, cmd)
    except (OSError, subprocess.SubprocessError, RuntimeError) as exc:
        _ERRORS[stem] = str(exc)
        return None


def _load() -> typing.Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _build('sais.cpp', 'libpss', _SAIS_CMD)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as exc:
            _ERRORS['libpss'] = str(exc)
            return None
        i32, u8 = ctypes.c_int32, ctypes.c_uint8
        i32p, i64p = ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_int64)
        u8p, voidpp = ctypes.POINTER(u8), ctypes.POINTER(ctypes.c_void_p)
        sigs = {
            'pss_build_sa_u8': [u8p, i32, i32p],
            'pss_find_newlines': [u8p, i32, i32p, i32],
            'pss_build_sa_i32': [i32p, i32, i32, i32p],
            'pss_unbwt': [u8p, i32, i32, u8p],
            'pss_probe_batch': [u8p, i32, i32p, u8p, i32p, i32, i32, i32p,
                                i32p],
            # nchunks, datas, ns, sas, pats, lens, stride, B, lo_out,
            # cnt_out, nthreads
            'pss_probe_multi': [i32, voidpp, i32p, voidpp, u8p, i32p, i32,
                                i32, i32p, i32p, i32],
            # nchunks, datas, ns, sas, text_offs, lo, cnt, B, out_base,
            # spans_out, out_cnt, nthreads
            'pss_extract_spans': [i32, voidpp, i32p, voidpp, i64p, i32p,
                                  i32p, i32, i64p, i64p, i32p, i32],
        }
        for fname, argtypes in sigs.items():
            fn = getattr(lib, fname)
            fn.restype = i32
            fn.argtypes = argtypes
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# CPython extension (native/fastext.c): batch line materialization.  Built
# on demand like the ctypes kernel; import failure degrades to the python
# fan-out in ops/extract.py.
# ---------------------------------------------------------------------------

_FASTEXT = None
_FASTEXT_TRIED = False


def fastext():
    """The native materialization module, or None when unavailable."""
    global _FASTEXT, _FASTEXT_TRIED
    with _LOCK:
        if _FASTEXT is not None or _FASTEXT_TRIED:
            return _FASTEXT
        _FASTEXT_TRIED = True
        # The interpreter's headers are part of the command, so they key
        # the build too.
        cmd = ('gcc', '-O2', '-shared', '-fPIC',
               f"-I{sysconfig.get_paths()['include']}")
        so = _build('fastext.c', '_fastext', cmd)
        if so is None:
            return None
        import importlib.util

        try:
            spec = importlib.util.spec_from_file_location(
                'pysubstringsearch_jax._fastext', so
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception as exc:  # noqa: BLE001 — recorded for require()
            _ERRORS['_fastext'] = repr(exc)
            return None
        _FASTEXT = mod
        return _FASTEXT


def require() -> None:
    """Raise unless both native modules built and loaded on this machine."""
    missing = []
    if not available():
        missing.append(f"libpss: {_ERRORS.get('libpss', 'unknown error')}")
    if fastext() is None:
        missing.append(
            f"_fastext: {_ERRORS.get('_fastext', 'unknown error')}"
        )
    if missing:
        raise RuntimeError(
            'native kernels unavailable on this machine (python '
            f'{sys.version.split()[0]}):\n' + '\n'.join(missing)
        )


def suffix_array_native(data: np.ndarray) -> np.ndarray:
    """SA via the C++ SA-IS kernel; raises if the library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native SA-IS library is not available')
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.size
    if n > 0x7FFFFFFF:
        raise ValueError('chunk exceeds int32 suffix-array limit')
    sa = np.empty(n, dtype=np.int32)
    if n == 0:
        return sa
    rc = lib.pss_build_sa_u8(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(n),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f'native SA-IS failed with code {rc}')
    return sa


def suffix_array_int_native(data: np.ndarray, k: int) -> np.ndarray:
    """SA over an int32 alphabet [0, k) — `libsais_int` parity
    (reference src/libsais/libsais.c:6612-6625)."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native int-alphabet SA-IS is not available')
    data = np.ascontiguousarray(data, dtype=np.int32)
    n = data.size
    sa = np.empty(n, dtype=np.int32)
    if n == 0:
        return sa
    rc = lib.pss_build_sa_i32(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(n),
        ctypes.c_int32(k),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f'native int SA-IS failed with code {rc}')
    return sa


def probe_batch_native(
    data: np.ndarray,
    sa: np.ndarray,
    packed: np.ndarray,  # uint8 [B, stride], zero padded
    lengths: np.ndarray,  # int32 [B]
) -> typing.Tuple[np.ndarray, np.ndarray]:
    """(lower, count) int32 [B] via the native host bisection (the host twin
    of the device probe; reference per-chunk searches: src/lib.rs:212-252).

    Releases the GIL for the whole batch, so callers can thread across
    (chunk, pattern-block) pairs.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError('native probe_batch is not available')
    data = np.ascontiguousarray(data, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int32)
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    B, stride = packed.shape
    lo = np.empty(B, dtype=np.int32)
    cnt = np.empty(B, dtype=np.int32)
    rc = lib.pss_probe_batch(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(data.size),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(stride),
        ctypes.c_int32(B),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f'native probe_batch failed with code {rc}')
    return lo, cnt


def unbwt_native(u: np.ndarray, primary_index: int) -> np.ndarray:
    """Inverse BWT via the native LF walk (libsais_unbwt parity)."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native unbwt is not available')
    u = np.ascontiguousarray(u, dtype=np.uint8)
    out = np.empty(u.size, dtype=np.uint8)
    rc = lib.pss_unbwt(
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(u.size),
        ctypes.c_int32(primary_index),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError(f'native unbwt failed with code {rc}')
    return out
