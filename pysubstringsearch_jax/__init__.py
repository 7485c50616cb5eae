"""Accelerator substring-search framework on JAX.

A from-scratch re-design of Intsights/PySubstringSearch for accelerators:
same public API and on-disk index format, but the reader re-derives suffix
arrays by a vectorized prefix-doubling sort on the device and queries run
as batched lower/upper-bound probes over device-resident (text, SA) rows,
sharded across a ``jax.sharding.Mesh`` at scale.
"""

def _disable_numpy_hugepage_madvise() -> None:
    """Turn off numpy's MADV_HUGEPAGE on large allocations.

    On kernels with ``transparent_hugepage/defrag = madvise`` (measured in
    this environment), numpy's hugepage madvise makes every first touch of a
    fresh large array go through synchronous page compaction: ~7-30 MB/s
    fault throughput vs ~2 GB/s without (a 340x penalty measured here).
    Index build and load both stream through multi-GB fresh buffers, so this
    single madvise dominates their wall time.  Set
    ``PSS_NUMPY_HUGEPAGE=1`` to keep numpy's default behavior.
    """
    import os

    if os.environ.get('PSS_NUMPY_HUGEPAGE') == '1':
        return
    try:
        import numpy as _np

        _np._core.multiarray._set_madvise_hugepage(False)
    except Exception:
        pass  # older numpy layouts; harmless to skip


_disable_numpy_hugepage_madvise()

from .api import Reader, Writer  # noqa: E402

__all__ = ['Reader', 'Writer']
__version__ = '0.1.0'
