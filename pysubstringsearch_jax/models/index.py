"""The flagship "model" of this framework: a device-resident substring index.

Where the reference keeps chunk text in host RAM and leaves suffix arrays on
disk behind per-probe file seeks (reference: src/lib.rs:146-199), this
design inverts the memory model: both text and SA for every chunk are
resident in device memory as stacked, padded, statically-shaped arrays —

    text [C, N_pad] uint8    sa [C, N_pad] int32    n [C] int32
    table [C, 66565] int32   (2-byte prefix bucket table, see ops/search.py)

so a batch of queries is answered by a single jitted program: a vmapped
bucket-seeded lower/upper-bound probe over the chunk axis (the analog of the
reference's rayon fan-out over sub-indexes, src/lib.rs:207).  The chunk axis
``C`` is also the sharding axis for multi-device / multi-host meshes (see
pysubstringsearch_jax.parallel).
"""

from __future__ import annotations

import os
import typing

import jax
import jax.numpy as jnp
import numpy as np

from ..container import Chunk
from ..ops import search as search_ops
from ..ops.suffix_array import _pad_len


class DeviceIndex:
    """Stacked padded chunks on one device (or replicated; sharding is
    layered on top by pysubstringsearch_jax.parallel)."""

    #: Chunks at least this large get the 3-byte bucket table (69 MB int32;
    #: ~8 fewer bisection steps) — below it the 2-byte table (260 KB) wins.
    DEEP_TABLE_MIN_CHUNK = 8 << 20

    #: Default merged-row text cap for derive mode (pads to 272 MiB rows;
    #: env PSS_MERGE_CAP).  chip_smoke.py runs it on one H100; re-tuning it
    #: for that card waits for a trace of the derive.
    MERGE_CAP_DEFAULT = 256 << 20

    def __init__(
        self,
        chunks: typing.Sequence[Chunk],
        *,
        num_limbs: typing.Optional[int] = None,
        mode: str = 'auto',
        merge: typing.Optional[bool] = None,
        sharding: typing.Optional[jax.sharding.NamedSharding] = None,
        _plan_only: bool = False,
    ) -> None:
        """``mode`` selects how the device-resident arrays come to exist:

        - ``'upload'``: host builds limbs + bucket tables from the container's
          SA and transfers everything (text, SA, limbs, tables) to the
          device.  Right when the backend IS the host (CPU), where
          "transfer" is free.
        - ``'derive'``: transfer the TEXT ONLY (1 byte/char vs ~4+4*num_limbs)
          and rebuild SA, limbs, and tables on device in two jitted programs
          per chunk (ops/search.py derive_sa / derive_aux_jit).  The SA of a
          string is unique, so the derived SA is byte-identical to the
          container's.  It also lets probe rows MERGE (below), which upload
          cannot: the container holds no SA for a merged row.
        - ``'auto'``: derive on accelerator backends, upload on CPU.

        ``merge`` (derive mode only; default on, ``PSS_MERGE=0`` disables):
        container chunks are CONCATENATED into merged probe rows of up to
        ``PSS_MERGE_CAP`` bytes and the SA of each merged text is derived
        on device.  The container's chunking is a build/IO artifact (the
        reference chunks at 512 MiB because its C kernel is int32-bound,
        src/lib.rs:57); probe cost scales with row count x lanes, so the
        device index re-derives its own geometry.  A probe over a merged
        row can additionally match occurrences that span a source-chunk
        boundary — only possible for patterns containing ``\\n`` (every
        chunk ends with one) — which callers filter by position
        (:meth:`boundary_crossings`; the Reader's extraction drops them).
        """
        self.num_source_chunks = len(chunks)
        self._batch_cache = None  # last grouped batch (see _group_batch)
        #: Optional [C, ...]-row placement over a 1-D device mesh (the
        #: parallel.ShardedReader path).  None = single default device.
        self.sharding = sharding
        if mode == 'auto':
            mode = 'upload' if jax.default_backend() == 'cpu' else 'derive'
        if mode not in ('upload', 'derive'):
            raise ValueError(f'unknown DeviceIndex mode: {mode!r}')
        self.mode = mode
        if merge is None:
            merge = os.environ.get('PSS_MERGE', '1') != '0'
        merge = merge and mode == 'derive' and len(chunks) > 1
        if merge:
            cap = int(
                os.environ.get('PSS_MERGE_CAP', str(self.MERGE_CAP_DEFAULT))
            )
            # Balanced split: rows are stacked as one padded [C, n_pad]
            # array, so a lopsided tail row wastes HBM for every row and a
            # plain greedy fill makes one.  Aim each row at total/ngroups
            # with the cap as a hard ceiling.
            sizes = [c.data.size for c in chunks]
            total = sum(sizes)
            ngroups = max(1, -(-total // cap))
            target = total / ngroups
            groups: typing.List[typing.List[int]] = []
            cur: typing.List[int] = []
            size = 0
            for i, s in enumerate(sizes):
                if cur and (size + s > cap or size >= target):
                    groups.append(cur)
                    cur, size = [], 0
                cur.append(i)
                size += s
            if cur:
                groups.append(cur)
        else:
            groups = [[i] for i in range(len(chunks))]
        if sharding is not None and groups:
            # Pad the row count to a mesh multiple; pad rows carry n = 0 and
            # can never produce hits.
            d = sharding.mesh.devices.size
            while len(groups) % d:
                groups.append([])
        #: groups[r] = container-chunk indices concatenated into probe row r.
        self.groups = groups
        self.merged = any(len(g) > 1 for g in groups)
        #: Host copy of each probe row's text (shared, not copied, for
        #: singleton rows) and the interior source-chunk end offsets.
        self.row_data: typing.List[np.ndarray] = []
        self.boundaries: typing.List[np.ndarray] = []
        for g in groups:
            if len(g) == 0:  # mesh-padding row
                self.row_data.append(np.zeros(0, dtype=np.uint8))
                self.boundaries.append(np.zeros(0, dtype=np.int64))
            elif len(g) == 1:
                self.row_data.append(chunks[g[0]].data)
                self.boundaries.append(np.zeros(0, dtype=np.int64))
            else:
                datas = [chunks[i].data for i in g]
                self.row_data.append(np.concatenate(datas))
                ends = np.cumsum([d.size for d in datas])[:-1]
                self.boundaries.append(ends.astype(np.int64))
        #: Start offset of each source chunk within its row (parallel to
        #: ``groups``) — extraction maps per-chunk positions into row space.
        self.group_offsets: typing.List[np.ndarray] = [
            np.concatenate(([0], b)).astype(np.int64) for b in self.boundaries
        ]
        self.num_chunks = len(groups)  # probe ROWS (historical name)
        # Limb encoding (ops/search.py): rank-packed digits when the
        # alphabet is small enough for them to beat raw bytes (5-6 bytes per
        # int32 gather, NUL-safe), raw 4-byte packing for big NUL-free
        # alphabets, base-258 digit limbs otherwise.
        pres = np.zeros(256, dtype=bool)
        for c in chunks:
            pres |= np.bincount(c.data, minlength=256)[:256] > 0
        sigma = int(pres.sum())
        bits = search_ops.ranked_bits(sigma)
        if bits is not None:
            self.kind = 'ranked'
        elif not pres[0]:
            self.kind = 'raw'
        else:
            self.kind = 'digit'
        self.raw = self.kind == 'raw'
        self._bits = bits
        self._limb_bytes = {
            'ranked': search_ops.ranked_limb_bytes(bits) if bits else 0,
            'raw': 4,
            'digit': 3,
        }[self.kind]
        if self.num_chunks == 0:
            self.num_limbs = (
                search_ops.RAW_LIMBS if num_limbs is None else num_limbs
            )
            self.n_pad = 8
            self._base, self._depth = search_ops._RADIX, 2
            self.text = jnp.zeros((0, 8), jnp.uint8)
            self.sa = jnp.zeros((0, 8), jnp.int32)
            self.lengths = jnp.zeros((0,), jnp.int32)
            self.tables = jnp.zeros(
                (0, search_ops.BUCKET_TABLE_SIZE), jnp.int32
            )
            self.limbs = jnp.zeros((0, 8), jnp.int32)
            rank, pres_i = search_ops.identity_rank()
            self.rank = jnp.asarray(rank)
            self.present = jnp.asarray(pres_i)
            return
        max_n = max(max(d.size for d in self.row_data), 1)
        # Margin so suffix windows up to PAD_MARGIN bytes never clamp.
        n_pad = _pad_len(max_n + search_ops.PAD_MARGIN)
        self.n_pad = n_pad
        n = np.array([d.size for d in self.row_data], dtype=np.int32)
        self.lengths = self._put_rows(n)
        if self.kind in ('ranked', 'raw'):
            # Alphabet-ranked seed table: rank bytes through the union
            # alphabet of all chunks; a small alphabet buys a much deeper
            # dense seed (each extra byte of depth removes ~log2(sigma)
            # probe iterations per query — see ops/search.py).
            rank, sigma = search_ops.alphabet_rank(pres)
            base, depth = search_ops.pick_table_params(sigma, max_n)
        else:
            rank, pres_i = search_ops.identity_rank()
            pres = pres_i > 0
            base = search_ops._RADIX
            depth = 3 if max_n >= self.DEEP_TABLE_MIN_CHUNK else 2
        self._base, self._depth = base, depth
        self._rank_host = rank
        self.rank = self._put_repl(rank)
        self.present = self._put_repl(pres.astype(np.int32))
        if num_limbs is None:
            num_limbs = self._auto_num_limbs(chunks)
        self.num_limbs = num_limbs
        if _plan_only:
            return
        if mode == 'derive':
            self._init_derive(chunks, n_pad, depth)
        else:
            self._init_upload(chunks, n_pad, depth)

    @classmethod
    def plan(cls, chunks, **kwargs) -> 'DeviceIndex':
        """Geometry-only instance — every planning attribute (groups,
        kind, num_limbs, n_pad, table params, probe_class_keys) without
        building any device array.  Lets callers AOT-compile the probe
        ladder (warm_probe / ops.search.warm_phased_classes) in parallel
        with, or before, the real index load."""
        return cls(chunks, _plan_only=True, **kwargs)

    def _put_rows(self, arr: np.ndarray):
        """Place a [C, ...] row-major host array (row-sharded if a mesh
        sharding was given, default device otherwise)."""
        if self.sharding is None:
            return jnp.asarray(arr)
        return jax.device_put(arr, self.sharding)

    def _put_repl(self, arr: np.ndarray):
        """Place a small replicated operand (rank/present/query arrays)."""
        if self.sharding is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.device_put(
            arr, NamedSharding(self.sharding.mesh, PartitionSpec())
        )

    @property
    def cover_bytes(self) -> int:
        """Pattern bytes resolved by seed table + packed limbs (beyond this
        the deep text-window refinement engages)."""
        if self.kind == 'ranked':
            return search_ops.ranked_cover_bytes(
                self.num_limbs, self._depth, self._bits
            )
        if self.kind == 'raw':
            return search_ops.raw_cover_bytes(self.num_limbs, self._depth)
        return search_ops.key_cover_bytes(self.num_limbs)

    @staticmethod
    def _device_hbm_budget() -> int:
        """Usable accelerator memory in bytes (CPU backends: effectively
        unbounded — host RAM is not ours to meter).  An accelerator that
        reports no ``bytes_limit`` is an error: a guessed size would pick
        the limb count for some other device."""
        dev = jax.devices()[0]
        if dev.platform == 'cpu':
            return 1 << 62
        limit = (dev.memory_stats() or {}).get('bytes_limit')
        if limit is None:
            raise RuntimeError(
                f'{dev.device_kind} reports no bytes_limit in memory_stats(); '
                'cannot size the device index'
            )
        # Leave headroom for probe scratch and the derive build's transients.
        return int(limit * 0.85)

    def _auto_num_limbs(self, chunks) -> int:
        """Largest limb count whose resident footprint fits the device
        budget (capped at RAW_LIMBS / KEY_LIMBS for raw / digit packing).

        Per chunk of n_pad chars the index holds text (1 B) + SA (4 B) +
        num_limbs limb planes (4 B each) + the seed table.  More limbs =
        longer pattern prefixes resolved in packed key space (fewer
        raw-text window gathers), so take as many as fit; at least 1 is kept
        — if even that overflows, the corpus needs more chips
        (parallel.ShardedReader), not a thinner index.

        In derive mode the binding constraint is the limb build's peak, not
        the final resident set: per chunk it materializes one limb-plane row
        (4 * num_limbs * n_pad) plus ~8 * n_pad of builder scratch alongside
        the full stacked buffers, so the fit divides by (C + 1) rows and
        reserves the scratch.
        """
        cap = (
            search_ops.KEY_LIMBS if self.kind == 'digit'
            else search_ops.RAW_LIMBS
        )
        if not self.row_data:
            return cap
        max_n = max(max(d.size for d in self.row_data), 1)
        n_pad = _pad_len(max_n + search_ops.PAD_MARGIN)
        C = len(self.row_data)
        if self.sharding is not None:
            # The budget meters EACH device's shard of the rows.
            C = max(1, C // self.sharding.mesh.devices.size)
        table_bytes = 4 * (self._base ** self._depth + 1)
        base = C * (5 * n_pad + table_bytes)
        budget = self._device_hbm_budget()
        if self.mode == 'derive':
            fit = (budget - base - 8 * n_pad) // (4 * n_pad * (C + 1))
        else:
            fit = (budget - base) // (4 * C * n_pad)
        return int(max(1, min(cap, fit)))

    def _init_upload(self, chunks, n_pad, depth):
        text = np.zeros((self.num_chunks, n_pad), dtype=np.uint8)
        sa = np.zeros((self.num_chunks, n_pad), dtype=np.int32)
        for i, c in enumerate(chunks):
            text[i, : c.data.size] = c.data
            sa[i, : c.suffix_array.size] = c.suffix_array
        self.text = self._put_rows(text)
        self.sa = self._put_rows(sa)
        host_tables = np.zeros(
            (self.num_chunks, self._base ** depth + 1), dtype=np.int32
        )
        for i, c in enumerate(chunks):
            host_tables[i] = search_ops.build_seed_table_host(
                c.data, c.suffix_array, self._rank_host, self._base, depth
            )
        self.tables = self._put_rows(host_tables)
        # Plane-major limb layout (limb j of slot i at j*n_pad + i) — see
        # ops/search.py:_limb_cmp3.
        limbs = np.zeros(
            (self.num_chunks, n_pad * self.num_limbs), dtype=np.int32
        )
        for i, c in enumerate(chunks):
            if self.kind == 'ranked':
                k = search_ops.build_ranked_limbs_host(
                    c.data, c.suffix_array, self._rank_host,
                    self.num_limbs, depth, self._bits,
                )
            elif self.kind == 'raw':
                k = search_ops.build_raw_limbs_host(
                    c.data, c.suffix_array, self.num_limbs, depth
                )
            else:
                k = search_ops.build_limbs_host(
                    c.data, c.suffix_array, self.num_limbs
                )
            limbs[i] = search_ops.pad_limbs_host(k, n_pad)
        self.limbs = self._put_rows(limbs)

    def _init_derive(self, chunks, n_pad, depth):
        del chunks  # derive builds from self.row_data (merged rows)
        if self.sharding is not None:
            self._init_derive_sharded(n_pad, depth)
            return
        # Two dispatches per chunk, not one fused program: SA-build scratch
        # and the [N, num_limbs] limb matrix must not be live simultaneously.
        # Memory discipline: stacked buffers are preallocated and filled
        # with DONATED row writes (a jnp.stack at the end would transiently
        # double the largest array), and the limb planes are not allocated
        # until every chunk's SA-build scratch (the other big transient)
        # has been and gone.
        derive_sa = search_ops.derive_sa
        set_row = search_ops.set_row_jit()
        C = self.num_chunks
        # Pass 1 — text upload + device SA per row (a row is the merged
        # concatenation of its group's source chunks; the SA of the merged
        # text is derived directly — no host SA for it ever exists).
        # Poison flags are checked only AFTER every row has dispatched:
        # for segmented rows (<= 384 Mi) the flag is a host constant and
        # for rotating rows a device scalar, so deferring the bool() keeps
        # the whole pass async — row i+1's upload streams while row i's
        # derive executes instead of serializing on a readback.
        texts = jnp.zeros((C, n_pad), jnp.uint8)
        sas = jnp.zeros((C, n_pad), jnp.int32)
        # Ranked alphabets hand the doubler their byte->rank map: the init
        # then covers 2x(30//bits) chars in one sort instead of 6, one
        # fewer doubling round per row.
        brank = self.rank if self.kind == 'ranked' else None
        bbits = self._bits if self.kind == 'ranked' else None
        pois = []
        for i, d in enumerate(self.row_data):
            row = np.zeros((n_pad,), dtype=np.uint8)
            row[: d.size] = d
            t = jnp.asarray(row)
            texts = set_row(texts, jnp.int32(i), t)
            sa, poisoned = derive_sa(t, jnp.int32(d.size), brank, bbits)
            sas = set_row(sas, jnp.int32(i), sa)
            pois.append(poisoned)
            del t, sa
        for i, poisoned in enumerate(pois):
            if bool(poisoned):  # adversarial input: full-sort fallback
                d = self.row_data[i]
                row = np.zeros((n_pad,), dtype=np.uint8)
                row[: d.size] = d
                sa = search_ops.derive_sa_full_jit()(
                    jnp.asarray(row), jnp.int32(d.size)
                )
                sas = set_row(sas, jnp.int32(i), sa)
                del sa
        # Pass 2 — seed tables + limb planes.  Each row's digit stream is
        # packed ONCE and feeds both the table (ranked kinds: one gather +
        # scatter-min, derive_table_from_pack_jit) and every limb plane (a
        # dynamic-offset gather per plane, one compiled program total).
        tables = jnp.zeros((C, self._base ** self._depth + 1), jnp.int32)
        if self.kind in ('ranked', 'raw'):
            limbs = jnp.zeros((C, n_pad * self.num_limbs), jnp.int32)
            if self.kind == 'ranked':
                pack = search_ops.ranked_pack_jit(self._bits)
                plane_into = search_ops.derive_limb_ranked_jit(
                    depth, self._bits
                )
                table_from_pack = search_ops.derive_table_from_pack_jit(
                    self._base, depth, self._bits
                )
            else:
                pack = search_ops.raw_pack_jit(depth)
                plane_into = search_ops.derive_limb_raw_jit(depth)
                table_into = search_ops.derive_table_raw_jit(
                    self._base, depth
                )
            for i, d in enumerate(self.row_data):
                n_i = jnp.int32(d.size)
                t_i, sa_i = texts[i], sas[i]
                if self.kind == 'ranked':
                    src = pack(t_i, n_i, self.rank)
                    tables = table_from_pack(
                        tables, jnp.int32(i), src, n_i, sa_i
                    )
                else:
                    src = pack(t_i, n_i)
                    tables = table_into(
                        tables, jnp.int32(i), t_i, n_i, sa_i, self.rank
                    )
                for j in range(self.num_limbs):
                    limbs = plane_into(
                        limbs, jnp.int32(i), jnp.int32(j), src, n_i, sa_i
                    )
                del t_i, sa_i, src
        else:
            limbs = jnp.zeros((C, n_pad * self.num_limbs), jnp.int32)
            derive_aux = search_ops.derive_aux_jit(self.num_limbs, depth)
            for i, d in enumerate(self.row_data):
                lb, tb = derive_aux(
                    texts[i], jnp.int32(d.size), sas[i]
                )
                limbs = set_row(limbs, jnp.int32(i), lb)
                tables = set_row(tables, jnp.int32(i), tb)
                del lb, tb
        self.text = texts
        self.sa = sas
        self.limbs = limbs
        self.tables = tables

    def _init_derive_sharded(self, n_pad, depth):
        """Derive with mesh placement: each row's SA/limbs/tables build on
        the device that owns the row (independent per-device dispatches — no
        collectives; the probe later runs as one sharded program) and are
        written into that device's preallocated row block with donated row
        writes, as in the single-device load: a trailing ``jnp.stack``
        would hold every row twice.  The blocks then assemble into global
        row-sharded arrays without a copy."""
        mesh = self.sharding.mesh
        devs = list(mesh.devices.flat)
        C = self.num_chunks
        rpd = C // len(devs)
        derive_sa = search_ops.derive_sa
        set_row = search_ops.set_row_jit()
        aux_row = search_ops.derive_aux_row_jit(
            self.kind, self.num_limbs, self._base, self._depth, self._bits
        )
        table_len = self._base ** self._depth + 1
        t_shards, s_shards, l_shards, tb_shards = [], [], [], []
        for k, dev in enumerate(devs):
            rank_d = jax.device_put(self._rank_host, dev)
            texts = jnp.zeros((rpd, n_pad), jnp.uint8, device=dev)
            sas = jnp.zeros((rpd, n_pad), jnp.int32, device=dev)
            limbs = jnp.zeros((rpd, n_pad * self.num_limbs), jnp.int32,
                              device=dev)
            tables = jnp.zeros((rpd, table_len), jnp.int32, device=dev)
            for j in range(rpd):
                d = self.row_data[k * rpd + j]
                if d.size == 0:  # mesh-padding row: stays zero
                    continue
                row = np.zeros((n_pad,), dtype=np.uint8)
                row[: d.size] = d
                t = jax.device_put(row, dev)
                n_i = jnp.int32(d.size)
                sa, poisoned = derive_sa(
                    t, n_i,
                    rank_d if self.kind == 'ranked' else None,
                    self._bits if self.kind == 'ranked' else None,
                )
                if bool(poisoned):  # adversarial: full-sort fallback
                    del sa
                    sa = search_ops.derive_sa_full_jit()(t, n_i)
                lb, tb = aux_row(t, n_i, sa, rank_d)
                slot = jnp.int32(j)
                texts = set_row(texts, slot, t)
                sas = set_row(sas, slot, sa)
                limbs = set_row(limbs, slot, lb)
                tables = set_row(tables, slot, tb)
                del t, sa, lb, tb
            t_shards.append(texts)
            s_shards.append(sas)
            l_shards.append(limbs)
            tb_shards.append(tables)
        mk = jax.make_array_from_single_device_arrays
        self.text = mk((C, n_pad), self.sharding, t_shards)
        self.sa = mk((C, n_pad), self.sharding, s_shards)
        self.limbs = mk((C, n_pad * self.num_limbs), self.sharding, l_shards)
        self.tables = mk((C, table_len), self.sharding, tb_shards)

    def _group_batch(self, patterns: np.ndarray, lengths: np.ndarray):
        """(spec, flat device operands) for the grouped phased probe.

        Splits the batch by phase class — ``ceil((L - depth) / limb_bytes)``
        limb phases, plus a separate class for patterns past the packed coverage
        (deep text refinement) — packing each class to its natural width
        and padding its size to a power of two (min 8, pad lanes scatter to
        index B: dropped) so the number of compiled programs stays bounded.
        Memoized on the batch arrays (``_batch_cache``): repeat probes of
        the same batch (the benchmark's dispatch-slope loop, retry paths)
        reuse the uploaded operands instead of re-crossing the link.
        """
        # Memo check: object identity first (the repeat-probe case — e.g.
        # the benchmark's dispatch-slope loop reuses one array), then a
        # no-copy array compare.  Unlike hashing the bytes, equality cannot
        # silently alias two different batches, and unlike ``tobytes()`` it
        # allocates nothing.
        cached = self._batch_cache
        if cached is not None:
            cp, cl, cspec, cflat = cached
            if cp is patterns or (
                cp.shape == patterns.shape
                and np.array_equal(cp, patterns)
                and np.array_equal(cl, lengths)
            ):
                return cspec, cflat
        spec = []
        flat = []
        for Bk, width, deep, idx in search_ops.class_spec(
            lengths, self._depth, self._limb_bytes, self.cover_bytes,
            self.num_limbs,
        ):
            sub = np.zeros((Bk, width), dtype=np.uint8)
            sub_len = np.zeros((Bk,), dtype=np.int32)
            sub[: idx.size, : min(width, patterns.shape[1])] = (
                patterns[idx, :width]
            )
            sub_len[: idx.size] = lengths[idx]
            spec.append((Bk, width, deep))
            flat.append(
                (idx, self._put_repl(sub), self._put_repl(sub_len))
            )
        spec = tuple(spec)
        self._batch_cache = (patterns, lengths, spec, flat)
        return spec, flat

    def probe_device_parts(
        self,
        patterns: np.ndarray,  # uint8 [B, L]
        lengths: np.ndarray,  # int32 [B]
    ) -> typing.List[typing.Tuple[np.ndarray, jnp.ndarray, jnp.ndarray]]:
        """Per-class device probe: list of (member indices [Bk'] host,
        lower [C, Bk] device, count [C, Bk] device) — no host readback.

        Phased-mode batches (ranked/raw limbs) dispatch one compiled
        executable per phase class (ops/search.py:phased_class_exec — a
        canonical shape ladder, AOT-compilable before the index exists):
        the while_loop bills every lane for the slowest lane's iteration
        count, and that count is set by the lane's phase class — a
        host-known function of pattern length — so seed-only patterns cost
        two table lookups, one-phase patterns ~log2(seed bucket width)
        iterations, and only the longest class pays its extra
        re-localization phases.  All dispatches are async on one stream:
        forcing the LAST part waits for the whole batch.
        """
        if self.kind == 'digit':
            cover = search_ops.key_cover_bytes(self.num_limbs)
            probe = search_ops.limbs_loop_batch_jit(
                patterns.shape[1] > cover, self.num_limbs
            )
            lo, cnt = probe(
                self.text, self.lengths, self.sa, self.tables, self.limbs,
                jnp.asarray(patterns), jnp.asarray(lengths),
            )
            return [(np.arange(patterns.shape[0]), lo, cnt)]
        patterns = np.asarray(patterns)
        lengths = np.asarray(lengths)
        spec, flat = self._group_batch(patterns, lengths)
        if self.sharding is not None:
            # Sharded operands: let jit propagate the mesh placement (AOT
            # executables are lowered without shardings).
            parts = []
            for (Bk, width, deep), (idx, sub, sub_len) in zip(spec, flat):
                probe = search_ops.phased_batch_jit(
                    deep, self.num_limbs, self._bits,
                    uniform_long=width > self._depth,
                )
                lo_k, cnt_k = probe(
                    self.text, self.lengths, self.sa, self.tables,
                    self.limbs, self.rank, self.present, sub, sub_len
                )
                parts.append((idx, lo_k, cnt_k))
            return parts
        # Compile any cold classes in parallel before dispatching (the
        # persistent cache then serves them to future processes).
        table_len = self._base ** self._depth + 1
        keys = [
            (self.num_limbs, self._bits, deep, self.num_chunks, self.n_pad,
             table_len, Bk, width)
            for (Bk, width, deep) in spec
        ]
        search_ops.warm_phased_classes(keys)
        parts = []
        for key, (idx, sub, sub_len) in zip(keys, flat):
            exe = search_ops.phased_class_exec(*key)
            lo_k, cnt_k = exe(
                self.text, self.lengths, self.sa, self.tables, self.limbs,
                self.rank, self.present, sub, sub_len
            )
            parts.append((idx, lo_k, cnt_k))
        return parts

    def probe_class_keys(self, lengths: np.ndarray):
        """Executable-cache keys the given batch lengths will dispatch —
        feed to ops.search.warm_phased_classes to pre-compile (possible
        from a geometry-only plan(), before any device array exists)."""
        if self.kind == 'digit' or self.num_chunks == 0:
            return []
        table_len = self._base ** self._depth + 1
        return [
            (self.num_limbs, self._bits, deep, self.num_chunks, self.n_pad,
             table_len, Bk, width)
            for (Bk, width, deep, _) in search_ops.class_spec(
                np.asarray(lengths), self._depth, self._limb_bytes,
                self.cover_bytes, self.num_limbs,
            )
        ]

    def warm_probe(self, lengths: np.ndarray, parallel: bool = True) -> None:
        """Pre-compile the probe programs a batch with these pattern lengths
        will need (no-op when already cached, persistent across processes)."""
        search_ops.warm_phased_classes(
            self.probe_class_keys(lengths), parallel
        )

    def boundary_crossings(
        self,
        patterns: np.ndarray,  # uint8 [B, L]
        lengths: np.ndarray,  # int32 [B]
    ) -> np.ndarray:
        """int32 [C, B]: occurrences counted by a merged-row probe that span
        a source-chunk boundary (not matches under reference semantics —
        the reference never matches across chunks, src/lib.rs:201-287).

        Every source chunk ends with ``\\n`` (Writer invariant), so a
        crossing occurrence necessarily contains a newline — patterns
        without one are exact for free.  For the rare rest, occurrences are
        counted in the 2L-2 byte window around each boundary with an
        overlapping-find loop; an occurrence spanning several boundaries is
        attributed to the first one it crosses (counted once).
        """
        patterns = np.asarray(patterns)
        lengths = np.asarray(lengths)
        B = patterns.shape[0]
        out = np.zeros((self.num_chunks, B), dtype=np.int32)
        if not self.merged or B == 0:
            return out
        jpos = np.arange(patterns.shape[1])[None, :]
        has_nl = ((patterns == 0x0A) & (jpos < lengths[:, None])).any(axis=1)
        for bi in np.flatnonzero(has_nl):
            L = int(lengths[bi])
            if L < 2:
                continue
            pat = patterns[bi, :L].tobytes()
            for r, ends in enumerate(self.boundaries):
                if ends.size == 0:
                    continue
                data = self.row_data[r].tobytes()
                total = 0
                prev = 0
                for e in ends.tolist():
                    start = max(prev, e - L + 1)
                    window = data[start: e + L - 1]
                    o = window.find(pat)
                    while o != -1:
                        if start + o <= e - 1:  # starts before the boundary
                            total += 1
                        o = window.find(pat, o + 1)
                    prev = e
                out[r, bi] = total
        return out

    def count_matches(
        self,
        patterns: np.ndarray,  # uint8 [B, L]
        lengths: np.ndarray,  # int32 [B]
    ) -> np.ndarray:
        """int32 [C, B] exact per-row match counts under reference semantics
        (merged-row probe counts minus boundary crossings)."""
        _, cnt = self.probe(patterns, lengths)
        return cnt - self.boundary_crossings(patterns, lengths)

    def probe(
        self,
        patterns: np.ndarray,  # uint8 [B, L]
        lengths: np.ndarray,  # int32 [B]
    ) -> typing.Tuple[np.ndarray, np.ndarray]:
        """(lower, count) int32 [C, B]: SA range of matches per (row, query).

        On a MERGED row (see ``merge`` in the constructor) the count is the
        raw merged-text occurrence count: for patterns containing ``\\n`` it
        can include occurrences spanning source-chunk boundaries, which are
        not matches under reference semantics.  Gather-and-filter consumers
        need the raw contiguous range (spurious entries are interspersed);
        count consumers subtract :meth:`boundary_crossings` (or call
        :meth:`count_matches`)."""
        B = patterns.shape[0]
        if (
            self.num_chunks == 0
            or B == 0
            or patterns.shape[1] > self.n_pad  # longer than any text: no hits
        ):
            zeros = np.zeros((self.num_chunks, B), dtype=np.int32)
            return zeros, zeros.copy()
        lo = np.zeros((self.num_chunks, B), dtype=np.int32)
        cnt = np.zeros((self.num_chunks, B), dtype=np.int32)
        for idx, lo_k, cnt_k in self.probe_device_parts(patterns, lengths):
            lo[:, idx] = np.asarray(lo_k)[:, : idx.size]
            cnt[:, idx] = np.asarray(cnt_k)[:, : idx.size]
        if self.raw:
            # NUL-free text cannot contain a pattern with a 0x00 byte, and
            # the raw packing cannot represent one — resolve on the host.
            jpos = np.arange(patterns.shape[1])[None, :]
            has_nul = np.any(
                (patterns == 0) & (jpos < np.asarray(lengths)[:, None]),
                axis=1,
            )
            if has_nul.any():
                lo = np.where(has_nul[None, :], 0, lo)
                cnt = np.where(has_nul[None, :], 0, cnt)
        return lo, cnt
