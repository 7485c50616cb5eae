"""Multi-host (N>=2 process) runtime glue.

The reference has no distributed backend at all (SURVEY.md §5.8 — rayon
threads in one address space, a mutex as the only "collective").  Here the
multi-host story is the single-host one scaled up: every process owns the
corpus chunks assigned to its devices, the query batch is replicated, and
per-chunk hit ranges flow back over DCN via ``process_allgather``.

Search is stateless per batch, so failure recovery is re-dispatch
(SURVEY.md §5.3): a lost host means re-running the batch against its chunk
shard after reassignment; no in-flight state needs checkpointing beyond the
container file itself.
"""

from __future__ import annotations

import typing

import jax
import numpy as np


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
) -> None:
    """Join the distributed runtime (TCP coordinator; works for CPU test
    meshes and GPU hosts alike)."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def my_chunk_ids(num_chunks: int) -> typing.List[int]:
    """Round-robin chunk -> process assignment; each process loads only its
    own chunks' text and SA from the container."""
    pid = jax.process_index()
    nproc = jax.process_count()
    return [c for c in range(num_chunks) if c % nproc == pid]


def allgather_counts(local_counts: np.ndarray) -> np.ndarray:
    """Gather per-process [C_local, B] hit-count blocks to every host."""
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(local_counts, tiled=False)
    )


def allgather_bytes(payload: bytes) -> typing.List[bytes]:
    """Gather one variable-length bytes blob per process to every host.

    Two fixed-shape collectives over DCN: an allgather of lengths, then an
    allgather of the max-length-padded payload — the host-side counterpart
    of the reference's mutex merge (src/lib.rs:280) for data whose size is
    only known at runtime.
    """
    from jax.experimental import multihost_utils

    lengths = multihost_utils.process_allgather(
        np.array([len(payload)], dtype=np.int64), tiled=False
    ).reshape(-1)
    pad = int(lengths.max(initial=1))
    row = np.zeros(pad, dtype=np.uint8)
    row[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    rows = np.asarray(
        multihost_utils.process_allgather(row, tiled=False)
    ).reshape(len(lengths), pad)
    return [rows[p, : lengths[p]].tobytes() for p in range(len(lengths))]


class MultiHostReader:
    """End-to-end multi-host search over a sharded-manifest index.

    Every process loads ONLY its own shard files (round-robin assignment,
    parallel/manifest.py), holds its chunks' device state locally, probes the
    (replicated) query batch, extracts its chunks' matching lines on its own
    host, and the per-process result lists are merged everywhere via a DCN
    allgather — the distributed form of the reference's rayon fan-out +
    mutex merge (src/lib.rs:205-284).  All processes return the same result
    multiset, ordered by process then local chunk (result order is
    unspecified in the reference; its tests use multiset comparison).

    Call pattern is SPMD: every process must call ``search`` /
    ``search_multiple`` with the same arguments, like any jax.distributed
    program.  Requires jax.distributed to be initialized (see
    :func:`initialize`); also works single-process (trivial gather).
    """

    def __init__(self, manifest_dir: str) -> None:
        from ..api import Reader
        from . import manifest

        self._local = Reader.from_chunks(
            [
                c
                for path in manifest.local_shard_paths(manifest_dir)
                for c in _read_chunks(path)
            ]
        )

    def _search_batch(
        self, patterns: typing.List[bytes]
    ) -> typing.List[typing.List[str]]:
        import pickle

        local = self._local._search_batch(patterns)
        merged = [
            pickle.loads(blob)
            for blob in allgather_bytes(pickle.dumps(local))
        ]
        out: typing.List[typing.List[str]] = [[] for _ in patterns]
        for per_process in merged:
            for b, lines in enumerate(per_process):
                out[b].extend(lines)
        return out

    def search(self, substring: str) -> typing.List[str]:
        return self._search_batch([substring.encode('utf-8')])[0]

    def search_multiple(
        self, substrings: typing.List[str]
    ) -> typing.List[str]:
        per = self._search_batch([s.encode('utf-8') for s in substrings])
        results: typing.List[str] = []
        for r in per:
            results.extend(r)
        return results


def _read_chunks(path: str):
    from .. import container

    return container.read_chunks(path)
