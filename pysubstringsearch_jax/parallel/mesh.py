"""Device-mesh configuration and chunk placement.

The reference's parallel runtime is a rayon work-stealing thread pool over
512 MiB sub-indexes within one process (reference: src/lib.rs:207) — its
"concurrency increases as the index file grows".  The equivalent here is
pure data parallelism over the corpus-chunk axis: chunks are placed
round-robin across a flat 1-D ``jax.sharding.Mesh`` (every card of a host
reaches every other over NVLink, so the mesh follows the algorithm alone),
queries are replicated, and per-chunk hit ranges come back sharded (or
all-gathered through NCCL when a single replicated result buffer is
wanted).
"""

from __future__ import annotations

import typing

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHUNK_AXIS = 'chunks'


def make_mesh(
    devices: typing.Optional[typing.Sequence[jax.Device]] = None,
) -> Mesh:
    """1-D mesh over the corpus-chunk axis (the only parallel axis of this
    workload; see SURVEY.md §2.3 — per-chunk search is embarrassingly
    parallel, so a single data-parallel axis saturates the machine)."""
    devs = np.array(devices if devices is not None else jax.devices())
    return Mesh(devs, (CHUNK_AXIS,))


def chunk_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for [C, ...] chunk-major arrays: split axis 0 over devices."""
    return NamedSharding(mesh, P(CHUNK_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_chunk_count(c: int, mesh: Mesh) -> int:
    """Chunk count rounded up to a multiple of the mesh size (padding slots
    carry n=0 and never produce hits)."""
    d = mesh.devices.size
    return -(-c // d) * d
