"""Public engine API: instance + index lifecycle and operations.

Mirrors the reference's public C API surface (src/core/nxs.h:26-101,
src/core/nxs.c): ``Nxs`` is the nxs_t instance (basedir resolution,
filter registry, open-index map); ``Index`` is nxs_index_t
(add/remove/search over the journals + device snapshot).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

import jax

from .errors import ErrorCode, NxsError
from .index.device import DeviceIndex
from .index.hostindex import HostIndex
from .ops.scoring import ALGO_BM25, ALGO_TFIDF
from .params import (DEFAULT_FILTERS, DEFAULT_LANGUAGE, DEFAULT_RANKING_ALGO,
                     Params)
from .resp import Response
from .search import get_search_params, search, search_many
from .text.filters import FilterPipeline, FilterRegistry
from .text.tokenizer import TOKENSET_STAGE, tokenize
from .utils.rwlock import RWLock
from .utils.validate import str_isalnumdu

_ALGO_IDS = {"BM25": ALGO_BM25, "TF-IDF": ALGO_TFIDF}


def _parallel_compile(fn, jobs, workers: int = 6) -> None:
    """Run AOT lower+compile jobs through a small thread pool: XLA
    compiles release the GIL, so independent executables build
    concurrently on the host's cores.  The pool size is unmeasured on
    the H100's host.  A failing compile raises: on the serving device
    every job must build."""
    if not jobs:
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(workers, len(jobs))) as ex:
        list(ex.map(fn, jobs))


class Index:
    """One open index (nxs_index_t equivalent)."""

    def __init__(self, nxs: "Nxs", name: str, params: Params,
                 device: Optional[jax.Device] = None,
                 mesh=None):
        self.nxs = nxs
        self.name = name
        self.params = params
        algo_name = params.get_str("algo") or DEFAULT_RANKING_ALGO
        if algo_name not in _ALGO_IDS:
            raise NxsError(ErrorCode.INVALID,
                           f"invalid algorithm `{algo_name}'")
        self.algo = _ALGO_IDS[algo_name]
        self.pipeline = FilterPipeline(nxs.filters, params)
        try:
            self.host = HostIndex(os.path.join(nxs.basedir, "data", name))
        except Exception:
            self.pipeline.close()
            raise
        if mesh is not None:
            from .parallel.sharded import ShardedDeviceIndex
            self.dev = ShardedDeviceIndex(self.host, mesh)
        else:
            self.dev = DeviceIndex(self.host, device=device)
        self._fuzzy = None  # lazily-built fuzzy matcher
        # Reader-writer semantics across threads sharing this handle
        # (the service shares one Index per name across request
        # threads): journal-tail consumption, snapshot refresh, and
        # mutation are exclusive -- two concurrent sync()s could
        # double-apply the same tail -- while query EXECUTION is
        # shared, so concurrent readers proceed in parallel like the
        # reference's mmap + flock SH readers (src/index/*.c).
        self._rw = RWLock()
        # Fuzzy resolution mutates shared memo/snapshot state; guard
        # it separately so concurrent readers only serialize there.
        self._fuzzy_guard = threading.RLock()

    # -- operations (nxs.c:490-566) ---------------------------------------

    def add(self, doc_id: int, text: str,
            params: Optional[Params] = None) -> None:
        """Index a document (nxs_index_add)."""
        if doc_id == 0:
            raise NxsError(ErrorCode.INVALID,
                           "document ID must be non-zero")
        with self._rw.writing():
            if self.host.doc_lookup(doc_id) is not None:
                raise NxsError(ErrorCode.EXISTS,
                               f"document {doc_id} is already indexed")
            tokens = tokenize(self.pipeline, text)
            if tokens.count == 0:
                raise NxsError(
                    ErrorCode.MISSING,
                    "the text is empty or no meaningful tokens found")
            tokens.resolve(self.host.term_lookup, TOKENSET_STAGE)
            self.host.terms_add(tokens)
            self.host.dtmap_add(doc_id, tokens)

    def add_many(self, docs: list[tuple[int, str]],
                 params: Optional[Params] = None) -> None:
        """Bulk document add: one journal lock round-trip per batch.

        Same per-document semantics as add() (non-zero unique IDs,
        non-empty token sets), but the batch is atomic and the journal
        appends are amortized -- the high-throughput ingest path (no
        reference equivalent; the C engine locks per document).

        With the native pipeline, the whole batch tokenizes in one C++
        call and flows to the journals as numpy arrays; non-ASCII
        documents detour through the Python pipeline and are merged
        back so the batch stays atomic.
        """
        import numpy as np

        # Accept any iterable: the ID validation below would otherwise
        # silently exhaust a generator before the locked add.
        if not isinstance(docs, (list, tuple)):
            docs = list(docs)
        if not docs:
            return
        for doc_id, _ in docs:
            if doc_id == 0:
                raise NxsError(ErrorCode.INVALID,
                               "document ID must be non-zero")

        self._rw.write_acquire()
        try:
            return self._add_many_locked(docs)
        finally:
            self._rw.write_release()

    def _add_many_locked(self, docs):
        import numpy as np

        native = self.pipeline.native
        result = native.process_batch([t for _, t in docs]) \
            if native is not None else None
        if result is None:
            items = []
            for doc_id, text in docs:
                tokens = tokenize(self.pipeline, text)
                if tokens.count == 0:
                    raise NxsError(
                        ErrorCode.MISSING,
                        f"document {doc_id}: the text is empty or no "
                        "meaningful tokens found")
                items.append((doc_id, tokens))
            self.host.add_bulk(items)
            return

        values, pairs, doc_ptr, seen = result
        bad = np.nonzero(seen == 0xFFFFFFFF)[0]
        if len(bad):
            # Non-ASCII documents: Python pipeline, splice into the
            # batch table/pairs.
            table_index = {v: i for i, v in enumerate(values)}
            segments = [pairs[doc_ptr[d]: doc_ptr[d + 1]]
                        for d in range(len(docs))]
            for d in bad:
                tokens = tokenize(self.pipeline, docs[d][1])
                rows = np.zeros((len(tokens.tokens), 2), dtype=np.uint32)
                for r, token in enumerate(tokens.tokens):
                    ix = table_index.get(token.value)
                    if ix is None:
                        ix = len(values)
                        values.append(token.value)
                        table_index[token.value] = ix
                    rows[r] = (ix, token.count)
                segments[d] = rows
                seen[d] = tokens.seen
            pairs = np.concatenate(segments) if segments else pairs
            doc_ptr = np.zeros(len(docs) + 1, dtype=np.int64)
            np.cumsum([len(s) for s in segments], out=doc_ptr[1:])

        empty = np.nonzero(seen == 0)[0]
        if len(empty):
            raise NxsError(
                ErrorCode.MISSING,
                f"document {docs[int(empty[0])][0]}: the text is empty "
                "or no meaningful tokens found")
        self.host.add_bulk_arrays(
            np.asarray([d for d, _ in docs], dtype=np.int64),
            values, pairs, doc_ptr, seen)

    def remove(self, doc_id: int) -> None:
        """Remove a document (nxs_index_remove -> tombstone)."""
        with self._rw.writing():
            self.host.dtmap_remove(doc_id)

    def _read_synced(self):
        """Acquire the read lock with the index up to date.

        Fast path: nothing pending in the journals and the snapshot is
        current -- take the shared lock directly, so concurrent
        readers execute in parallel.  Otherwise upgrade to exclusive,
        consume the journal tails (search.c:309-310) and refresh the
        device snapshot, then downgrade atomically."""
        while True:
            self._rw.read_acquire()
            if (not self.host.has_pending()
                    and self.dev.generation == self.host.generation):
                return
            self._rw.read_release()
            self._rw.write_acquire()
            try:
                self.host.sync()
                self.dev.refresh()
            except BaseException:
                self._rw.write_release()
                raise
            self._rw.downgrade()
            return

    def search(self, query: str, params: Optional[Params] = None) -> Response:
        """Search the index (nxs_index_search)."""
        sp = get_search_params(self.algo, params)
        self._read_synced()
        try:
            fuzzy = self._fuzzy_lookup if sp.fuzzymatch else None
            return search(self.dev, self.pipeline, query, sp,
                          fuzzy_lookup=fuzzy)
        finally:
            self._rw.read_release()

    def search_many(self, queries: list[str],
                    params: Optional[Params] = None) -> list[Response]:
        """Batched search: many queries, one device dispatch per
        signature group.  Same results as per-query search; this is
        the high-QPS serving path (no reference equivalent -- the C
        engine is one-query-per-call)."""
        sp = get_search_params(self.algo, params)
        self._read_synced()
        try:
            fuzzy = self._fuzzy_lookup if sp.fuzzymatch else None
            prefetch = self._fuzzy_prefetch if sp.fuzzymatch else None
            return search_many(self.dev, self.pipeline, queries, sp,
                               fuzzy_lookup=fuzzy,
                               fuzzy_prefetch=prefetch)
        finally:
            self._rw.read_release()

    def search_pipelined(self, batches: list[list[str]],
                         params: Optional[Params] = None
                         ) -> list[list[Response]]:
        """Streaming batched search: each batch's host prep and
        dispatch overlap the previous batch's device execution
        (search.search_many_pipelined).  The steady-state serving
        shape: a continuous query stream in fixed-size batches."""
        from .search import search_many_pipelined
        sp = get_search_params(self.algo, params)
        self._read_synced()
        try:
            fuzzy = self._fuzzy_lookup if sp.fuzzymatch else None
            prefetch = self._fuzzy_prefetch if sp.fuzzymatch else None
            return search_many_pipelined(self.dev, self.pipeline,
                                         batches, sp,
                                         fuzzy_lookup=fuzzy,
                                         fuzzy_prefetch=prefetch)
        finally:
            self._rw.read_release()

    def prewarm(self, params: Optional[Params] = None, *,
                rows: tuple = (1, 64, 512), seed: int = 0) -> int:
        """Compile-warm this index's serving signatures.

        Synthesizes a representative query mix from the index's OWN
        term distribution -- df-stratified 1-4 term OR queries across
        every log2 document-frequency tier, boolean (AND / AND NOT)
        forms, and guaranteed-miss typo terms for the fuzzy sweep --
        and runs it through the sequential and batched search paths,
        discarding results.  Each distinct plan signature compiles
        once; with the persistent XLA compilation cache enabled the
        executables also survive process restarts, so no production
        query ever pays a first-of-its-shape multi-second compile
        inside a latency percentile.  ``rows`` picks the batch row
        counts to warm (1 covers the sequential path; serving batch
        shapes re-pad onto the pow2 grid, so one mid and one large
        count cover the steady-state groups).

        Returns the number of warmup queries executed.  No reference
        analogue: the C engine has no compile step (this is the
        device counterpart of its page-cache warmup at mmap
        time).
        """
        import numpy as np
        df = np.asarray(self.host.term_df.a[: len(self.host.term_values)])
        live = np.nonzero(df > 0)[0]
        if live.size == 0:
            return 0
        rng = np.random.default_rng(seed)
        # Up to 8 terms per log2-df tier: enough to fill multi-term
        # queries without repeating one term (repeats would dedupe).
        tier_of = np.frexp(df[live].astype(np.float64))[1]
        pool: list[list[str]] = []
        pool_df: list[list[int]] = []
        for t in np.unique(tier_of):
            members = live[tier_of == t][:8]
            pool.append([self.host.term_values[i] for i in members])
            pool_df.append([int(df[i]) for i in members])
        # Cap a synthesized query's total window count: real damped-
        # Zipf traffic essentially never unions several monster terms,
        # and a 3-4-monster query is a multi-GB sort plane -- prewarm
        # must cover the signatures serving hits, not manufacture
        # pathological ones.
        max_windows = 8192
        queries: list[str] = []
        for ti, tier in enumerate(pool):
            queries.append(tier[0])
            for n in (2, 3, 4):
                # Mix this tier with rng-drawn other tiers: covers the
                # cross-tier plan shapes (wide head + narrow tail).
                toks = [tier[0]]
                wsum = -(-pool_df[ti][0] // 1024)
                tries = 0
                while len(toks) < n and tries < 32:
                    tries += 1
                    oi = int(rng.integers(len(pool)))
                    other = pool[oi]
                    j = int(rng.integers(len(other)))
                    w = -(-pool_df[oi][j] // 1024)
                    if wsum + w > max_windows:
                        continue
                    wsum += w
                    toks.append(other[j])
                queries.append(" ".join(toks))
            if len(tier) >= 2:
                queries.append(f"{tier[0]} AND {tier[1]}")
                queries.append(f"{tier[0]} AND NOT {tier[1]}")
        # Fuzzy sweep signatures: misses that resolve through the
        # Levenshtein path (tolerance 2 finds no vocab word for a
        # 3-char suffix mutation of a real term; either way the sweep
        # itself compiles, which is the point).
        sp = get_search_params(self.algo, params)
        if sp.fuzzymatch:
            for tier in pool[:8]:
                queries.append(tier[0] + "0qz")
        n_run = 0
        for r in sorted(set(rows)):
            if r <= 1:
                for q in queries[: min(len(queries), 16)]:
                    self.search(q, params)
                    n_run += 1
                continue
            batch = [queries[int(i)] for i in
                     rng.integers(len(queries), size=r)]
            self.search_many(batch, params)
            n_run += r
        # The classic no-prefix ladder: wide-term rows plan through it
        # with full window columns, so a serving batch can hit these
        # signatures at any time (which typo mix appears varies per
        # batch); the group shapes are ladder-pinned, so one pass per
        # rung covers them.
        from .search import (_prepare_many, collect_query_batch,
                            submit_query_batch)
        self._read_synced()
        try:
            for r in sorted({min(max(x, 2), 64) for x in rows}):
                batch = [queries[int(i)] for i in
                         rng.integers(len(queries), size=r)]
                prepared = _prepare_many(
                    self.dev, self.pipeline, batch, sp,
                    self._fuzzy_lookup if sp.fuzzymatch else None,
                    self._fuzzy_prefetch if sp.fuzzymatch else None)
                st = submit_query_batch(self.dev, prepared, sp,
                                        no_prefix=True)
                collect_query_batch(self.dev, st, sp)
                n_run += r
        finally:
            self._rw.read_release()
        self._prewarm_wide_signatures(sp)
        self._prewarm_prefix_signatures(sp)
        return n_run

    def _prewarm_prefix_signatures(self, sp) -> None:
        """AOT-compile the impact-prefix R = 0 dispatch product: with
        variable-width windows a batch splits over (column tier) x
        (window width) cells whose member counts track the query mix,
        so the laddered row pads {8, 64, 512, 2048} x tier {8, 64} x
        width rungs must all be warm or a fresh mix pays a
        first-of-its-shape compile mid-serving.  Lowering + compile
        only; results land in the in-process and persistent caches."""
        import jax.numpy as jnp

        from .ops.executor import device_search_prefix_packed
        from .ops.scoring import ALGO_BM25
        from .search import (_MIN_K, _PF_TIERS, _PREFIX_M, _bucket,
                             _t_ladder, _window_t0)

        dev = self.dev
        if (getattr(dev, "postings_pack", None) is None
                or dev.doc_count == 0
                or not getattr(dev, "prefix_ready", False)
                or sp.algo != ALGO_BM25):
            return
        k = _bucket(min(sp.limit, dev.n_slots), _MIN_K)
        ladder = _t_ladder(_window_t0(dev.slice_t_cap))
        tiers = [t for t in _PF_TIERS if t <= 64] or [8]
        jobs = [(qs, T, rows)
                for qs in tiers for T in ladder
                for rows in (8, 64, 128, 256, 512, 1024, 2048)]

        def compile_one(job):
            qs, T, rows = job
            # n_run 4 covers the serving ladder's dominant rung (2-4
            # term queries); rarer rungs compile lazily on first hit.
            buf = jnp.zeros(rows * 4 * qs, jnp.int32)
            device_search_prefix_packed.lower(
                dev.postings_pack, dev.alive_mask,
                buf, dev.adl_dev, qs=qs, R=0, T=T,
                k=k, M=_PREFIX_M, algo=sp.algo,
                n_slots=dev.n_slots,
                alive_all=dev.alive_all, n_run=4,
                k_ret=min(sp.limit, k)).compile()

        _parallel_compile(compile_one, jobs)

    def _prewarm_wide_signatures(self, sp) -> None:
        """AOT-compile the pinned wide-plane (qs > 64) sliced
        signatures: the full (qs rung) x (row rung) product, so a
        serving batch whose monster-term mix lands on a rung never
        pays a first-of-its-shape compile mid-serving.  Lowering +
        compile only -- nothing
        executes; results land in the in-process and persistent XLA
        caches."""
        import jax.numpy as jnp

        from .ops.executor import device_search_sliced_packed
        from .search import _MIN_K, _WINDOW_MAX_COLS, _bucket

        dev = self.dev
        if getattr(dev, "postings_pack", None) is None \
                or dev.doc_count == 0:
            return
        k = _bucket(min(sp.limit, dev.n_slots), _MIN_K)
        adl = jnp.float32(max(dev.adl, 1.0))
        from .search import _row_pad, _window_t0
        # The dispatcher's actual window width (shrinks below the
        # module default when the pack's guard caps are small) and the
        # n_run rungs its wide-plane ladder emits (search.py
        # _submit_plans: _ladder(n_run, (4, 16, 128))) -- compiling
        # only one rung leaves the other rungs' first-of-shape
        # compiles in the serving path.
        T0 = _window_t0(dev.slice_t_cap)
        jobs = []
        qs_rung = 128
        while qs_rung <= _WINDOW_MAX_COLS:
            # Only the row rungs the dispatcher can actually emit:
            # the {1,8,64} ladder clamped FIRST by the chunker's lane
            # cap (the dispatcher never hands _row_pad more members
            # than a chunk holds, so prewarm must not either -- an
            # unclamped rows=64 at qs=32768 is a 2G-lane graph), then
            # padded like _row_pad.
            chunk_cap = max(1, (1 << 24) // (qs_rung * T0))
            for rows in sorted({_row_pad(min(r, chunk_cap),
                                         qs_rung, T0)
                                for r in (1, 2, 4, 8, 64)}):
                for n_run in (4, 16, 128):
                    if n_run > qs_rung:
                        break
                    jobs.append((qs_rung, rows, n_run))
            qs_rung <<= 1

        def compile_one(job):
            qs_rung, rows, n_run = job
            buf = jnp.zeros(rows * 3 * qs_rung, jnp.int32)
            device_search_sliced_packed.lower(
                dev.postings_pack, dev.alive_mask,
                dev.doc_len, buf, adl, None,
                qs=qs_rung, L=1, D=4, T=T0, k=k,
                algo=sp.algo, n_slots=dev.n_slots,
                use_mask=False, single=False,
                alive_all=dev.alive_all, use_rows=False,
                depth=4, T_head=0, n_run=n_run).compile()

        _parallel_compile(compile_one, jobs)

    def stats(self) -> dict:
        """Live index statistics (observability; counts mirror the
        reference's idx_get_doc_count/token_count internals)."""
        with self._rw.writing():
            self.host.sync()
        return {
            "name": self.name,
            "doc_count": self.host.doc_count,
            "term_count": self.host.term_count,
            "token_count": self.host.token_count,
            "generation": self.host.generation,
            "algo": self.params.get_str("algo"),
            "filters": list(self.pipeline.names),
        }

    def _fuzzy_lookup(self, value: str) -> Optional[int]:
        with self._fuzzy_guard:
            return self._fuzzy_matcher().lookup(value)

    def _fuzzy_prefetch(self, values) -> None:
        with self._fuzzy_guard:
            self._fuzzy_matcher().prefetch(values)

    def _fuzzy_matcher(self):
        from .fuzzy import FuzzyMatcher
        if self._fuzzy is None:
            self._fuzzy = FuzzyMatcher(self.host)
        return self._fuzzy

    def checkpoint(self) -> bool:
        """Write the fast-open snapshot cache (derived-state only; the
        journals remain the source of truth).  Also written on close."""
        return self.host.save_snapshot()

    def close(self) -> None:
        try:
            self.host.save_snapshot()
        except OSError:  # pragma: no cover - best-effort cache
            pass
        self.pipeline.close()
        self.host.close()


class Nxs:
    """Engine instance (nxs_t equivalent, nxs_open/nxs_close).

    ``basedir`` defaults to the NXS_BASEDIR environment variable
    (nxs.c:95-105); a ``data/`` subdirectory holds the indexes.
    """

    def __init__(self, basedir: Optional[str] = None, mesh=None):
        basedir = basedir or os.environ.get("NXS_BASEDIR")
        if not basedir:
            raise NxsError(ErrorCode.INVALID,
                           "base directory not specified")
        self.basedir = basedir
        self.mesh = mesh  # optional: shard all indexes over this mesh
        os.makedirs(os.path.join(basedir, "data"), exist_ok=True)
        self.filters = FilterRegistry(basedir)
        self._indexes: dict[str, Index] = {}

    # -- index lifecycle (nxs.c:219-487) ----------------------------------

    def _index_dir(self, name: str) -> str:
        if not name or not str_isalnumdu(name):
            raise NxsError(ErrorCode.INVALID, f"invalid index name `{name}'")
        return os.path.join(self.basedir, "data", name)

    def index_create(self, name: str,
                     params: Optional[Params] = None) -> Index:
        """Create a new index with params.db defaults (nxs.c:219-300)."""
        idxdir = self._index_dir(name)
        if os.path.exists(idxdir):
            raise NxsError(ErrorCode.EXISTS, f"index `{name}' already exists")
        p = params.copy() if params else Params()
        if p.get_strlist("filters") is None:
            p.set_strlist("filters", DEFAULT_FILTERS)
        if p.get_str("lang") is None:
            p.set_str("lang", DEFAULT_LANGUAGE)
        if p.get_str("algo") is None:
            p.set_str("algo", DEFAULT_RANKING_ALGO)
        os.makedirs(idxdir)
        p.serialize(os.path.join(idxdir, "params.db"))
        return self.index_open(name)

    def index_open(self, name: str) -> Index:
        """Open an existing index (nxs.c:374-467)."""
        idxdir = self._index_dir(name)
        if name in self._indexes:
            raise NxsError(ErrorCode.EXISTS, f"index `{name}' is already open")
        params_path = os.path.join(idxdir, "params.db")
        if not os.path.isfile(params_path):
            raise NxsError(ErrorCode.MISSING, f"index `{name}' does not exist")
        params = Params.fromfile(params_path)
        idx = Index(self, name, params, mesh=self.mesh)
        self._indexes[name] = idx
        return idx

    def index_get(self, name: str) -> Index:
        """Open-or-get, the service layer's LRU-miss path."""
        idx = self._indexes.get(name)
        return idx if idx is not None else self.index_open(name)

    def index_close(self, idx: Index) -> None:
        self._indexes.pop(idx.name, None)
        idx.close()

    def index_destroy(self, name: str) -> None:
        """Destroy an index and its files (nxs_index_destroy)."""
        idxdir = self._index_dir(name)
        idx = self._indexes.pop(name, None)
        if idx is not None:
            idx.close()
        if not os.path.isdir(idxdir):
            raise NxsError(ErrorCode.MISSING, f"index `{name}' does not exist")
        shutil.rmtree(idxdir)

    def close(self) -> None:
        for idx in list(self._indexes.values()):
            idx.close()
        self._indexes.clear()
        self.filters.close()
