"""Public API — exact signature parity with the reference facade.

Reference surface (pysubstringsearch/__init__.py:6-73 and
pysubstringsearch.pyi:4-44):

    Writer(index_file_path, max_chunk_len=None)
        .add_entry(text) / .add_entries_from_file_lines(path)
        .dump_data() / .finalize()
    Reader(index_file_path)
        .search(substring) -> list[str]
        .search_multiple(substrings) -> list[str]

Behavioral parity notes (each mirrors a cited reference behavior):

- ``add_entry`` raises ``ValueError('entry is too big')`` when a single entry
  exceeds the chunk capacity (src/lib.rs:92-94) and flushes the current chunk
  before an entry that would overflow it (src/lib.rs:96-98).
- ``add_entries_from_file_lines`` operates on raw bytes with the terminator
  stripped (``\\n``, and a preceding ``\\r``), has no too-big guard, and lets
  an oversized line form its own oversized chunk (src/lib.rs:67-86).
- ``Reader`` raises ``FileNotFoundError`` for a missing index
  (src/lib.rs:166 via PyO3) and parses chunks greedily until EOF.
- ``search`` returns each matching line once per chunk it matches in (dedup
  is by line-start offset within a chunk, src/lib.rs:274);
  ``search_multiple`` concatenates per-pattern results *with* duplicates
  across patterns (pysubstringsearch/__init__.py:61-73) — but runs all
  patterns as ONE batched device probe instead of a Python loop.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import typing
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from . import container
from .models.index import DeviceIndex
from .ops import native as native_ops
from .ops import search as search_ops
from .ops.extract import LineTable
from .ops.hostserve import HOST_PROBE_UNIT_S
from .ops.suffix_array import build_suffix_array
from .utils.link import host_device_link
from .utils.profiling import PhaseProfiler


class Writer:
    """Index writer with reference semantics plus a pipelined build stage.

    ``build_workers > 0`` overlaps suffix-array construction of flushed
    chunks with further ingestion: each ``dump_data`` submits the chunk to a
    thread pool (the native SA-IS kernel releases the GIL, so host builds
    run truly in parallel across chunks — the parallelism the reference
    compiled OUT of libsais by not passing -fopenmp, build.rs:1-11) and
    completed chunks are appended to the file in submission order.  The
    resulting container bytes are identical to a synchronous build.
    """

    def __init__(
        self,
        index_file_path: str,
        max_chunk_len: typing.Optional[int] = None,
        *,
        sa_backend: str = 'auto',
        build_workers: typing.Optional[int] = None,
        profiler: typing.Optional['PhaseProfiler'] = None,
    ) -> None:
        self._file: typing.Optional[typing.BinaryIO] = open(index_file_path, 'wb')
        self._buffer = container.ChunkBuffer(max_chunk_len)
        self._sa_backend = sa_backend
        self._prof = profiler if profiler is not None else PhaseProfiler()
        if build_workers is None:
            build_workers = min(8, os.cpu_count() or 1)
        self._build_workers = build_workers
        self._executor: typing.Optional[ThreadPoolExecutor] = None
        # (data, future) pairs in submission order; file writes drain the
        # head so the on-disk chunk order always matches flush order.
        self._pending: typing.Deque[
            typing.Tuple[np.ndarray, 'Future[np.ndarray]']
        ] = collections.deque()

    #: Fast-ingest read granularity (bytes).
    _INGEST_BLOCK = 32 << 20

    def add_entries_from_file_lines(self, input_file_path: str) -> None:
        """Bulk line ingest — behaviorally identical to the reference's
        per-line loop (src/lib.rs:67-86: strip ``\\n`` terminator and a
        preceding ``\\r``, no too-big guard, oversized lines grow the
        buffer), but LF-only input is ingested as whole multi-line blocks:
        for such input the buffer contents equal the raw file bytes, so the
        per-line Python loop (measured ~15 s for a 500 MB corpus) reduces to
        finding each chunk's last fitting newline and one bulk append.
        """
        with open(input_file_path, 'rb') as input_file:
            leftover = b''
            while True:
                block = input_file.read(self._INGEST_BLOCK)
                if not block:
                    break
                buf = leftover + block if leftover else block
                cut = buf.rfind(b'\n')
                if cut == -1:
                    leftover = buf
                    continue
                self._ingest_segment(buf[: cut + 1])
                leftover = buf[cut + 1:]
        if leftover:
            # Final unterminated line: appended as-is (the reference's line
            # reader yields it without a terminator and strips no \r).
            if self._buffer.would_overflow(len(leftover)):
                self.dump_data()
            self._buffer.append(leftover)

    def _ingest_segment(self, segment: bytes) -> None:
        """Ingest whole ``\\n``-terminated lines with reference flush
        semantics: a line is appended to the current chunk iff
        ``size + len(line) + 1 <= capacity``, else the chunk flushes first;
        a single line larger than the whole capacity becomes its own
        oversized chunk (with the Vec capacity-growth quirk, see
        container.ChunkBuffer)."""
        if b'\r\n' in segment:
            # CRLF present: the \r-strip changes bytes, so take the exact
            # per-line path.
            start = 0
            while start < len(segment):
                end = segment.index(b'\n', start)
                line = segment[start:end]
                if line.endswith(b'\r'):
                    line = line[:-1]
                if self._buffer.would_overflow(len(line)):
                    self.dump_data()
                self._buffer.append(line)
                start = end + 1
            return
        pos = 0
        n = len(segment)
        while pos < n:
            room = self._buffer.capacity - len(self._buffer)
            cut = segment.rfind(b'\n', pos, pos + room) if room > 0 else -1
            if cut == -1:
                if len(self._buffer) > 0:
                    self.dump_data()
                    continue
                # Empty buffer and the first line alone exceeds capacity:
                # reference quirk — it becomes an oversized chunk and grows
                # the Vec (append() emulates the growth rule).
                end = segment.index(b'\n', pos)
                self._buffer.append(segment[pos:end])
                pos = end + 1
                continue
            self._buffer.append_block(segment[pos: cut + 1])
            pos = cut + 1

    def add_entry(self, text: str) -> None:
        data = text.encode('utf-8')
        if len(data) > self._buffer.capacity:
            raise ValueError('entry is too big')
        if self._buffer.would_overflow(len(data)):
            self.dump_data()
        self._buffer.append(data)

    @property
    def profiler(self) -> PhaseProfiler:
        """Per-phase build timings (SURVEY.md §5.5 — the observability the
        reference never had).  Phases: ``sa-build`` (per chunk; summed
        across worker threads, so it can exceed wall time) and ``serialize``.
        """
        return self._prof

    def _drain(self, block: bool) -> None:
        """Write completed head-of-queue chunks; with ``block``, all of them."""
        assert self._file is not None
        while self._pending:
            head_data, head_future = self._pending[0]
            if not block and not head_future.done():
                # Backpressure: never hold more than 2x workers of chunks.
                if len(self._pending) <= 2 * max(1, self._build_workers):
                    return
            suffix_array = head_future.result()
            with self._prof.phase('serialize'):
                container.write_chunk(self._file, head_data, suffix_array)
            self._pending.popleft()

    def _build_sa(self, data: np.ndarray) -> np.ndarray:
        with self._prof.phase('sa-build'):
            return build_suffix_array(data, backend=self._sa_backend)

    def dump_data(self) -> None:
        if len(self._buffer) == 0:
            return
        assert self._file is not None, 'Writer is closed'
        data = self._buffer.take()
        if self._build_workers <= 0:
            suffix_array = self._build_sa(data)
            with self._prof.phase('serialize'):
                container.write_chunk(self._file, data, suffix_array)
            return
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=self._build_workers,
                thread_name_prefix='pss-sa-build',
            )
        future = self._executor.submit(self._build_sa, data)
        self._pending.append((data, future))
        self._drain(block=False)

    def finalize(self) -> None:
        if self._file is None:
            return
        if len(self._buffer) > 0:
            self.dump_data()
        self._drain(block=True)
        self._file.flush()

    def close(self) -> None:
        """Finalize and release the file handle (not part of the reference
        API — its Writer flushes on Drop, src/lib.rs:138-144 — but Python
        callers deserve a deterministic close)."""
        if self._file is not None:
            self.finalize()
            self._file.close()
            self._file = None
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def __enter__(self) -> 'Writer':
        return self

    def __exit__(self, *exc: typing.Any) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


class Reader:
    """Device-resident index reader.

    Signature parity with the reference (``Reader(index_file_path)``,
    src/lib.rs:161-199); keyword-only extras configure the device placement:
    ``index_mode`` forwards to :class:`DeviceIndex` (``'auto'`` = derive on
    accelerators / upload on CPU; env override ``PSS_INDEX_MODE``).
    """

    def __init__(self, index_file_path: str, *, index_mode: str = 'auto') -> None:
        prof = PhaseProfiler()
        with prof.phase('load-container'):
            cont = container.read_container(index_file_path)
        self._container: typing.Optional[container.MappedContainer] = cont
        self._init_from_chunks(cont.chunks, prof, index_mode)

    def _init_from_chunks(
        self,
        chunks: typing.List[container.Chunk],
        prof: typing.Optional[PhaseProfiler] = None,
        index_mode: str = 'auto',
    ) -> None:
        if not hasattr(self, '_container'):
            self._container = None  # from_chunks path: no backing mmap
        self._chunks = chunks
        self._hostserve_obj = None
        self._hostserve_tried = False
        self._prof = prof if prof is not None else PhaseProfiler()
        self._index_mode = os.environ.get('PSS_INDEX_MODE', index_mode)
        self._device_index: typing.Optional[DeviceIndex] = None
        self._row_tables: typing.Optional[typing.List[LineTable]] = None
        self._chunk_tables: typing.Dict[int, LineTable] = {}
        self._device_exc: typing.Optional[BaseException] = None
        self._device_ready = threading.Event()
        self._bg_thread: typing.Optional[threading.Thread] = None
        if self._background_load_default() and chunks:
            # Time to first query: the host path (native bisection over
            # the container's SAs) answers queries the moment the
            # container is parsed — the reference Reader's
            # ready-in-milliseconds behavior (src/lib.rs:161-199) — while
            # the device index derives and warms on this thread; queries
            # switch over when it is ready.
            self._bg_thread = threading.Thread(
                target=self._bg_load, name='pss-device-load', daemon=True
            )
            self._bg_thread.start()

    @staticmethod
    def _background_load_default() -> bool:
        flag = os.environ.get('PSS_BG_LOAD')
        if flag is not None:
            return flag not in ('0', 'false', 'no')
        try:
            import jax

            return jax.default_backend() != 'cpu'
        except Exception:
            return False

    def _build_device_index(self) -> DeviceIndex:
        """Device-index construction hook (subclasses inject placement)."""
        return DeviceIndex(self._chunks, mode=self._index_mode)

    def _bg_load(self) -> None:
        try:
            with self._prof.phase('device-load'):
                index = self._build_device_index()
            with self._prof.phase('device-warm'):
                # Wait out the queued derive programs with one tiny probe,
                # so "ready" means the next query runs at steady state.
                probe_pats = np.full((8, 4), ord('e'), dtype=np.uint8)
                probe_lens = np.full((8,), 4, dtype=np.int32)
                lo, cnt = index.probe(probe_pats, probe_lens)
                del lo, cnt
                # Measure the link now, with the device idle: it routes
                # extraction, and lazily it would tax the first real query.
                host_device_link()
            self._device_index = index
        except BaseException as exc:  # noqa: BLE001 — re-raised on access
            self._device_exc = exc
        finally:
            self._device_ready.set()

    def _raise_load_error(self) -> None:
        if self._device_exc is not None:
            raise RuntimeError(
                'background device index load failed'
            ) from self._device_exc

    @property
    def profiler(self) -> PhaseProfiler:
        """Per-phase query-side timings: ``load-container``, ``line-tables``,
        ``device-load`` (tables/limbs build + H2D), ``probe``, ``extract``."""
        return self._prof

    @classmethod
    def from_chunks(cls, chunks: typing.List[container.Chunk]) -> 'Reader':
        """Reader over already-parsed chunks (e.g. a sharded-manifest load,
        parallel/manifest.py)."""
        reader = cls.__new__(cls)
        reader._init_from_chunks(chunks)
        return reader

    @property
    def _index(self) -> DeviceIndex:
        if self._device_index is None:
            if self._bg_thread is not None:
                self._device_ready.wait()
                self._raise_load_error()
                return self._device_index  # type: ignore[return-value]
            with self._prof.phase('device-load'):
                self._device_index = self._build_device_index()
        return self._device_index

    @property
    def device_ready(self) -> bool:
        """True once queries are served by the device index (False while a
        background load is still deriving/warming — queries are answered by
        the native host path in the meantime)."""
        if self._bg_thread is None:
            return self._device_index is not None
        return self._device_ready.is_set() and self._device_exc is None

    def wait_device_ready(self, timeout: typing.Optional[float] = None) -> bool:
        """Block until the background device load finishes (returns
        ``device_ready``; immediately True for synchronous loads).  A
        failed load raises its error here instead of returning False."""
        if self._bg_thread is not None:
            self._device_ready.wait(timeout)
            self._raise_load_error()
        return self.device_ready

    @property
    def row_tables(self) -> typing.List[LineTable]:
        """One LineTable per probe ROW (merged rows: over the concatenated
        text — line spans never cross source-chunk boundaries because every
        chunk ends with ``\\n``, and offset-keyed dedup is then identical to
        the reference's per-chunk dedup, src/lib.rs:274)."""
        if self._row_tables is None:
            with self._prof.phase('line-tables'):
                self._row_tables = [
                    LineTable(d) for d in self._index.row_data
                ]
        return self._row_tables

    #: Extra host seconds per hit that the device flat-gather route's line
    #: extraction (LineTable) costs over the native host pipeline.
    #: Measured by chip_smoke.py phase A on the host of an NVIDIA H100
    #: 80GB HBM3 (700 W): 10k queries, 21.8 M lines, 35.9 s on the device
    #: route against 9.4 s on the host pipeline.
    _DEVICE_ROUTE_HIT_S = 1.2e-6

    @property
    def _host_serving(self):
        """Persistent native serving state (ops/hostserve.py) over the
        container mmap, or None when the native kernels / flat buffer are
        unavailable.  Built once; pointer tables live as long as the
        Reader (the reference's SubIndex registration,
        src/lib.rs:186-195)."""
        if not self._hostserve_tried:
            self._hostserve_tried = True
            if self._container is not None:
                from .ops.hostserve import HostServing

                self._hostserve_obj = HostServing.maybe(
                    self._chunks, self._container.buf, self._prof
                )
        return self._hostserve_obj

    def _search_batch(self, patterns: typing.List[bytes]) -> typing.List[typing.List[str]]:
        """Per-pattern result lists, each in row-major order.

        Duplicate patterns are probed once and their results fanned back out
        (the reference's ``search_multiple`` re-runs the full search per
        duplicate, pysubstringsearch/__init__.py:61-73 — results are
        identical either way since equal patterns yield equal result lists).
        """
        if not patterns or not self._chunks:
            return [[] for _ in patterns]
        uniq: typing.Dict[bytes, int] = {}
        for p in patterns:
            uniq.setdefault(p, len(uniq))
        if len(uniq) < len(patterns):
            uniq_list = list(uniq)
            uniq_results = self._search_batch(uniq_list)
            return [uniq_results[uniq[p]] for p in patterns]
        if self._bg_thread is not None and not self._device_ready.is_set():
            # Device index still deriving/warming: serve from the host path
            # over the container's per-chunk SAs.  (A load that failed
            # raises below, from self._index.)
            with self._prof.phase('host-serve'):
                return self._search_host_chunks(patterns)
        out: typing.List[typing.List[str]] = [[] for _ in patterns]
        long_idx = [
            i for i, p in enumerate(patterns)
            if len(p) > search_ops.PAD_MARGIN
        ]
        if long_idx:
            # Patterns beyond the device window margin take the exact host
            # path; the REST of the batch still runs on device (an oversized
            # straggler must not poison the whole batch).
            long_set = set(long_idx)
            short_idx = [
                i for i in range(len(patterns)) if i not in long_set
            ]
            if short_idx:
                for i, lines in zip(
                    short_idx,
                    self._search_batch([patterns[i] for i in short_idx]),
                ):
                    out[i] = lines
            for i, lines in zip(
                long_idx,
                self._search_host([patterns[i] for i in long_idx]),
            ):
                out[i] = lines
            return out
        idx = self._index
        if native_ops.available():
            # Tiny batches: the device probe's fixed dispatch+readback
            # round trip (measured, utils/link.py) can exceed the whole
            # native host bisection (~HOST_PROBE_UNIT_S per query-chunk).
            host_est = (
                len(patterns)
                * max(idx.num_source_chunks, 1)
                * HOST_PROBE_UNIT_S
            )
            if host_est < host_device_link().rtt_s:
                with self._prof.phase('host-serve'):
                    return self._search_host(patterns)
        packed, lengths = search_ops.pack_patterns(patterns)
        with self._prof.phase('probe'):
            lo, cnt = idx.probe(packed, lengths)
        hs = self._host_serving
        if hs is not None and not idx.merged and idx.num_chunks == len(
            self._chunks
        ):
            # Singleton geometry: probe rows ARE container chunks, so the
            # device bounds feed the native span extraction directly — no
            # re-probe, one materialize over the flat file buffer.
            with self._prof.phase('extract'):
                return hs.extract(lo, cnt)
        if hs is not None and idx.merged and self._host_extract_all(cnt):
            # Every merged row would take the host extraction route: the
            # whole batch is answered fastest by the fused native pipeline
            # over the container chunks, whose per-chunk search needs no
            # crossing filter.
            with self._prof.phase('extract'):
                return hs.search(patterns)
        with self._prof.phase('extract'):
            # One vectorized extraction per row; rows run serially — the
            # host route inside already parallelizes across source chunks,
            # and nesting pools oversubscribes the cores (measured ~1.7x
            # slower at bench scale).  Row-major concatenation preserves
            # the per-pattern result order.
            for r in range(idx.num_chunks):
                per = self._extract_row(r, packed, lengths, lo[r], cnt[r])
                for b, lines in per.items():
                    out[b].extend(lines)
        return out

    def _host_extract_all(self, cnt: np.ndarray) -> bool:
        """True when every probe row's extraction would route to the native
        host bisection (same cost model as :meth:`_extract_row`): readback
        over budget or host re-probe cheaper than the device flat-gather."""
        if not native_ops.available():
            return False
        idx = self._index
        B = cnt.shape[1]
        for r in range(idx.num_chunks):
            if len(idx.groups[r]) <= 1:
                continue  # singleton rows are cheap either way
            total = int(np.maximum(cnt[r], 0).sum())
            if not self._host_route_cheaper(B, len(idx.groups[r]), total):
                return False
        return True

    def _host_route_cheaper(self, B: int, nsrc: int, total: int) -> bool:
        """Extraction cost model for one merged row of ``nsrc`` source
        chunks and ``total`` hits: the device flat-gather pays a round trip
        and 4 bytes per hit of readback at the measured link rate
        (utils/link.py), then a slower line extraction per hit; the native
        host pipeline pays ~HOST_PROBE_UNIT_S per (query, source chunk) to
        probe again."""
        link = host_device_link()
        host_est = B * nsrc * HOST_PROBE_UNIT_S
        dev_est = link.rtt_s + total * (
            4 / max(link.d2h_mbps * 1e6, 1e-9) + self._DEVICE_ROUTE_HIT_S
        )
        return host_est < dev_est

    def _extract_row(
        self,
        r: int,
        packed: np.ndarray,
        lengths: np.ndarray,
        lo_r: np.ndarray,
        cnt_r: np.ndarray,
    ) -> typing.Dict[int, typing.List[str]]:
        """Materialize one probe row's lines.

        Three routes, cheapest applicable first:

        - singleton row: gather positions from the container's host SA
          (zero device traffic — how the non-merged/upload geometry works);
        - merged row, hit volume within the readback budget: compact device
          flat-gather of (position, query) pairs, read back, filter
          boundary-crossing occurrences by position;
        - merged row, huge batch: re-derive per-source-chunk bounds with the
          native host bisection (ops/native.py) — bounded by host CPU
          instead of the device link, inherently crossing-free.
        """
        import jax.numpy as jnp

        idx = self._index
        table = self.row_tables[r]
        group = idx.groups[r]
        if len(group) == 1:
            chunk = self._chunks[group[0]]
            return table.extract_lines_batch(
                chunk.suffix_array, lo_r, cnt_r
            )
        total = int(np.maximum(cnt_r, 0).sum())
        use_host = native_ops.available() and (
            self._host_route_cheaper(packed.shape[0], len(group), total)
        )
        if not use_host:
            with self._prof.phase('x-dev-gather'):
                pos_d, qid_d = search_ops.gather_hits_flat(
                    idx.sa[r], jnp.asarray(lo_r), jnp.asarray(cnt_r), total
                )
                pos = np.asarray(pos_d).astype(np.int64)
                qid = np.asarray(qid_d).astype(np.int64)
            valid = qid >= 0
            pos, qid = pos[valid], qid[valid]
            pos, qid = self._drop_crossings(r, packed, lengths, pos, qid)
            with self._prof.phase('x-dev-lines'):
                return table.lines_for_positions(qid, pos)
        # Host route: per source chunk, native bisection + host SA gather +
        # the WHOLE line pipeline (dedup, decode, materialize).  Lines are
        # chunk-local (every chunk ends with \n), so per-chunk dedup equals
        # global dedup and the distinct-line sets are disjoint — nothing
        # needs a row-global sort, and the numpy stages of all chunks run
        # concurrently (they release the GIL; only the final native str
        # fan-out serializes).
        def one(j_c):
            j, c = j_c
            chunk = self._chunks[c]
            t0 = time.perf_counter()
            lo_c, cnt_c = native_ops.probe_batch_native(
                chunk.data, chunk.suffix_array, packed, lengths
            )
            t1 = time.perf_counter()
            cnt_c = np.maximum(cnt_c.astype(np.int64), 0)
            seg = np.repeat(np.arange(cnt_c.size, dtype=np.int64), cnt_c)
            firsts = np.cumsum(cnt_c) - cnt_c
            offs = (
                np.repeat(lo_c.astype(np.int64) - firsts, cnt_c)
                + np.arange(int(cnt_c.sum()), dtype=np.int64)
            )
            pos = chunk.suffix_array[offs].astype(np.int64)
            t2 = time.perf_counter()
            spans = table.spans_for_positions(
                seg, pos + int(idx.group_offsets[r][j])
            )
            t3 = time.perf_counter()
            return spans, (t1 - t0, t2 - t1, t3 - t2)

        # Two-stage pipeline: the probe + numpy span stages release the GIL
        # and run pooled; str materialization is GIL-bound (object creation
        # cannot parallelize), so it runs serially on this thread in chunk
        # order, overlapping chunk j's materialize with chunk j+1's numpy.
        # The prior shape — whole pipeline per pooled thread — made the
        # GIL-bound half FIGHT the numpy threads for cycles: measured
        # 0.75 M lines/s aggregate vs 1.6 M single-thread at bench scale.
        per_chunk = []
        with ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1)
        ) as pool:
            futures = [pool.submit(one, jc) for jc in enumerate(group)]
            for f in futures:
                spans, (tp, tg, ts) = f.result()
                self._prof.add('x-host-probe', tp)
                self._prof.add('x-host-gather', tg)
                self._prof.add('x-host-spans', ts)
                t0 = time.perf_counter()
                per_chunk.append(table.materialize_spans(spans))
                self._prof.add('x-host-lines', time.perf_counter() - t0)
        merged: typing.Dict[int, typing.List[str]] = {}
        for per in per_chunk:
            for b, lines in per.items():
                if b in merged:
                    merged[b].extend(lines)
                else:
                    merged[b] = lines
        return merged

    def _drop_crossings(
        self,
        r: int,
        packed: np.ndarray,
        lengths: np.ndarray,
        pos: np.ndarray,
        qid: np.ndarray,
    ) -> typing.Tuple[np.ndarray, np.ndarray]:
        """Drop merged-row occurrences that span a source-chunk boundary
        (possible only for patterns containing ``\\n`` — every chunk ends
        with one; see DeviceIndex.boundary_crossings)."""
        ends = self._index.boundaries[r]
        if ends.size == 0 or pos.size == 0:
            return pos, qid
        jpos = np.arange(packed.shape[1])[None, :]
        has_nl = ((packed == 0x0A) & (jpos < lengths[:, None])).any(axis=1)
        if not has_nl.any():
            return pos, qid
        L = lengths.astype(np.int64)[qid]
        check = has_nl[qid] & (L >= 2)
        crosses = check & (
            np.searchsorted(ends, pos, side='right')
            != np.searchsorted(ends, pos + L - 1, side='right')
        )
        keep = ~crosses
        return pos[keep], qid[keep]

    def _chunk_table(self, c: int) -> LineTable:
        table = self._chunk_tables.get(c)
        if table is None:
            table = self._chunk_tables[c] = LineTable(self._chunks[c].data)
        return table

    def _search_host_chunks(
        self, patterns: typing.List[bytes]
    ) -> typing.List[typing.List[str]]:
        """Host-only search straight off the container: native (or python)
        bisection over each source chunk's on-disk SA plus per-chunk line
        extraction — no device index required.  This is the serving path
        while a background device load is in flight; semantics match the
        reference exactly (per-chunk search + line-offset dedup,
        src/lib.rs:201-287)."""
        out: typing.List[typing.List[str]] = [[] for _ in patterns]
        if not patterns:
            return out
        hs = self._host_serving
        if hs is not None:
            return hs.search(patterns)
        stride = max(1, max(len(p) for p in patterns))
        packed = np.zeros((len(patterns), stride), dtype=np.uint8)
        plens = np.zeros(len(patterns), dtype=np.int32)
        for i, p in enumerate(patterns):
            packed[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
            plens[i] = len(p)
        use_native = native_ops.available()

        def one(c: int) -> typing.Dict[int, typing.List[str]]:
            chunk = self._chunks[c]
            if use_native:
                lo_c, cnt_c = native_ops.probe_batch_native(
                    chunk.data, chunk.suffix_array, packed, plens
                )
            else:
                data = chunk.data.tobytes()
                lo_c = np.zeros(len(patterns), dtype=np.int64)
                cnt_c = np.zeros(len(patterns), dtype=np.int64)
                for b, pat in enumerate(patterns):
                    lo_c[b], cnt_c[b] = search_ops.host_probe_bounds(
                        data, chunk.suffix_array, pat
                    )
            return self._chunk_table(c).extract_lines_batch(
                chunk.suffix_array, lo_c, cnt_c
            )

        workers = min(len(self._chunks), max(os.cpu_count() or 1, 1))
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                per_chunk = list(pool.map(one, range(len(self._chunks))))
        else:
            per_chunk = [one(c) for c in range(len(self._chunks))]
        for per in per_chunk:
            for b, lines in per.items():
                out[b].extend(lines)
        return out

    def _search_host(
        self, patterns: typing.List[bytes]
    ) -> typing.List[typing.List[str]]:
        """Exact host-side search for any pattern length (patterns beyond
        the device window margin, and tiny batches).  One cost-routed
        implementation serves this, the background-load window, and the
        native HostServing pipeline: ``_search_host_chunks`` — per-chunk
        bisection + per-chunk line extraction, the reference's own shape
        (src/lib.rs:201-287).  Result multisets are identical to the former
        row-table variant (a line belongs to exactly one chunk; the
        reference's cross-chunk order is nondeterministic, src/lib.rs:280)."""
        return self._search_host_chunks(patterns)

    def search(self, substring: str) -> typing.List[str]:
        return self._search_batch([substring.encode('utf-8')])[0]

    def search_multiple(self, substrings: typing.List[str]) -> typing.List[str]:
        per_pattern = self._search_batch([s.encode('utf-8') for s in substrings])
        results: typing.List[str] = []
        for r in per_pattern:
            results.extend(r)
        return results
