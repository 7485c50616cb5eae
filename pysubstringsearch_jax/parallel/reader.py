"""ShardedReader — the Reader, scaled over a device mesh.

Same API and result-set semantics as ``api.Reader`` (the conformance tests
run against both); the only difference is index placement: probe rows are
split across a 1-D mesh with ``NamedSharding`` (the collective analog of the
reference's rayon fan-out + mutex merge, src/lib.rs:205-284), queries
replicate, and the probe runs as one sharded program.

All geometry, limb-kind selection, aux building, and extraction routing
live in :class:`~pysubstringsearch_jax.models.index.DeviceIndex` and
:class:`~pysubstringsearch_jax.api.Reader` — this class only injects the
mesh placement:

- ``upload`` mode: host-built arrays are ``device_put`` row-sharded.
- ``derive`` mode (slow host->device links): each row's SA/limbs/tables
  derive ON the device that owns the row (independent per-device programs),
  merged rows included — the sharded twin of the single-device derive load.

Single-host form: the process holds all chunk text for line extraction and
shards only the device arrays.  The multi-host recipe (each host feeding its
own chunk shard, DCN gather of hit ranges, host-0 merge) composes from the
same pieces — see parallel/multihost.py and ARCHITECTURE.md.
"""

from __future__ import annotations

import typing

import jax

from .. import container
from ..api import Reader
from ..models.index import DeviceIndex
from ..utils.profiling import PhaseProfiler
from .mesh import chunk_sharding, make_mesh


class ShardedReader(Reader):
    def __init__(
        self,
        index_file_path: str,
        mesh: typing.Optional[jax.sharding.Mesh] = None,
        *,
        index_mode: str = 'auto',
    ) -> None:
        self.mesh = mesh if mesh is not None else make_mesh()
        prof = PhaseProfiler()
        with prof.phase('load-container'):
            cont = container.read_container(index_file_path)
        # Keep the mmap handle: host-side serving/extraction uses the same
        # flat-buffer native pipeline as the plain Reader.
        self._container = cont
        self._init_from_chunks(cont.chunks, prof, index_mode)

    def _build_device_index(self) -> DeviceIndex:
        return DeviceIndex(
            self._chunks,
            mode=self._index_mode,
            sharding=chunk_sharding(self.mesh),
        )

    # Introspection kept for tools/tests: padded row count and real rows.
    @property
    def _C(self) -> int:
        return self._index.num_chunks

    @property
    def _num_real(self) -> int:
        return sum(1 for g in self._index.groups if g)
