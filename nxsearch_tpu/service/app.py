"""REST search service over the engine API.

Endpoint shapes mirror the reference's OpenResty service exactly
(svc-src/nxsearch_svc.lua):

    POST   /{index}                  create index (JSON body = params)
    DELETE /{index}                  destroy index (+ stored blobs)
    POST   /{index}/add/{doc_id}     body = document text; ?store keeps
                                     the raw text in the blob store
    DELETE /{index}/remove/{doc_id}  tombstone removal
    POST   /{index}/search           body = query; query-string args map
                                     to params (limit coerced to number,
                                     nxsearch_svc.lua:85-104); ?fetch
                                     joins raw content into results
    POST   /filters/{name}/py        load a Python filter plugin, gated
                                     by NXS_ENABLE_PY_POST (the analogue
                                     of NXS_ENABLE_LUA_POST); ?store
                                     persists it under filters/

Errors return HTTP 400 with ``{"error": {"code": ..., "msg": ...}}``
(nxsearch_svc.lua:55-65).  Open indexes are cached in a 32-entry LRU
with a 24 h TTL (nxsearch_svc.lua:17-18).  Filter plugins under
``$NXS_BASEDIR/filters/*.py`` are loaded at startup (worker-init
equivalent, nxsearch_svc.lua:24-34).

The server is stdlib ThreadingHTTPServer; one process, many request
threads -- the engine's flock + commit-pointer journal protocol makes
multiple service processes over one basedir safe, exactly like the
reference's N nginx workers.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..errors import ErrorCode, NxsError
from ..nxs import Index, Nxs
from ..params import Params
from ..text.plugins import autoload_filters, load_filter, store_filter
from .storage import BlobStore

# Query-string fields coerced to numbers (PARAMS_NUMFIELDS).
_NUM_FIELDS = ("limit",)
_BOOL_FIELDS = ("fuzzymatch",)

_INDEX_TTL = 86400.0
_INDEX_CACHE_SIZE = 32


class _IndexCache:
    """32-entry LRU of open indexes with TTL (resty.lrucache analogue).

    Unlike the reference (whose N worker processes each hold a private
    handle and let GC reclaim evicted ones), one service process shares
    engine handles across request threads, so eviction must actually
    close the engine handle -- otherwise journal fds, device snapshots
    and fuzzy-vocab arrays accumulate without bound.  Handles are
    refcounted via ``lease()``: an evicted handle still leased by an
    in-flight request is closed when its last lease is released.
    """

    def __init__(self, nxs: Nxs, size: int = _INDEX_CACHE_SIZE,
                 ttl: float = _INDEX_TTL):
        self.nxs = nxs
        self.size = size
        self.ttl = ttl
        self._map: OrderedDict[str, tuple[Index, float]] = OrderedDict()
        self._refs: dict[int, int] = {}     # id(idx) -> live leases
        self._doomed: dict[int, Index] = {}  # evicted but still leased
        self._lock = threading.Lock()

    def _get_locked(self, name: str) -> Index:
        hit = self._map.get(name)
        if hit is not None:
            idx, expires = hit
            if time.monotonic() < expires:
                self._map.move_to_end(name)
                return idx
            # Expired: the handle self-syncs on every operation, so
            # just renew it (the reference's TTL re-opens because
            # its cached C handles do not).
            self._map.pop(name, None)
        idx = self.nxs.index_get(name)
        # Resurrected before its last lease drained: un-doom it.
        self._doomed.pop(id(idx), None)
        self._map[name] = (idx, time.monotonic() + self.ttl)
        while len(self._map) > self.size:
            _, (old, _) = self._map.popitem(last=False)
            self._retire_locked(old)
        return idx

    def _retire_locked(self, idx: Index) -> None:
        if self._refs.get(id(idx), 0) > 0:
            self._doomed[id(idx)] = idx
        else:
            self.nxs.index_close(idx)

    def get(self, name: str) -> Index:
        with self._lock:
            return self._get_locked(name)

    @contextmanager
    def lease(self, name: str):
        """Borrow a handle for one request; keeps it open across
        eviction until released."""
        with self._lock:
            idx = self._get_locked(name)
            self._refs[id(idx)] = self._refs.get(id(idx), 0) + 1
        try:
            yield idx
        finally:
            with self._lock:
                n = self._refs.get(id(idx), 1) - 1
                if n:
                    self._refs[id(idx)] = n
                else:
                    self._refs.pop(id(idx), None)
                    doomed = self._doomed.pop(id(idx), None)
                    if doomed is not None:
                        self.nxs.index_close(doomed)

    def put(self, name: str, idx: Index) -> None:
        with self._lock:
            self._map[name] = (idx, time.monotonic() + self.ttl)
            while len(self._map) > self.size:
                _, (old, _) = self._map.popitem(last=False)
                self._retire_locked(old)

    def _drop_locked(self, name: str) -> None:
        self._map.pop(name, None)
        idx = self.nxs._indexes.get(name)
        if idx is not None:
            self.nxs.index_close(idx)

    def drop(self, name: str) -> None:
        with self._lock:
            self._drop_locked(name)


class SearchService:
    """Route dispatch decoupled from the HTTP plumbing (testable)."""

    def __init__(self, basedir: str, mesh=None):
        self.nxs = Nxs(basedir, mesh=mesh)
        self.cache = _IndexCache(self.nxs)
        self.blobs = BlobStore(basedir)
        self.enable_py_post = bool(os.environ.get("NXS_ENABLE_PY_POST"))
        autoload_filters(self.nxs.filters, basedir)
        # One engine-level lock around mutations; searches are
        # journal-synced and can run concurrently per index.
        self._mutate_lock = threading.Lock()

    # -- request handling -------------------------------------------------
    # Each handler returns (status, body_obj | bytes | None).

    def handle(self, method: str, path: str, query: dict,
               body: bytes) -> tuple[int, Optional[object]]:
        parts = [p for p in path.split("/") if p]
        try:
            return self._dispatch(method, parts, query, body)
        except NxsError as e:
            return 400, e.tojson_obj()
        except Exception as e:  # pragma: no cover - defensive
            return 500, {"error": {"code": int(ErrorCode.SYSTEM),
                                   "msg": f"{type(e).__name__}: {e}"}}

    def _dispatch(self, method, parts, query, body):
        if method == "GET" and parts[:1] == ["docs"]:
            from .openapi import DOCS_HTML, OPENAPI
            if len(parts) == 1:
                return 200, DOCS_HTML
            if parts[1:] == ["openapi.json"]:
                return 200, OPENAPI
        if len(parts) == 3 and method == "POST" and parts[0] == "filters" \
                and parts[2] == "py":
            return self._post_filter(parts[1], query, body)
        if len(parts) == 1:
            if method == "POST":
                return self._create_index(parts[0], body)
            if method == "DELETE":
                return self._destroy_index(parts[0])
        if len(parts) == 2 and parts[1] == "search" and method == "POST":
            return self._search(parts[0], query, body)
        if len(parts) == 2 and parts[1] == "search_batch" \
                and method == "POST":
            return self._search_batch(parts[0], query, body)
        if len(parts) == 3 and parts[1] == "add" and method == "POST":
            return self._add(parts[0], parts[2], query, body)
        if len(parts) == 3 and parts[1] == "remove" and method == "DELETE":
            return self._remove(parts[0], parts[2])
        if len(parts) == 2 and parts[1] == "stats" and method == "GET":
            return self._stats(parts[0])
        return 404, {"error": {"code": int(ErrorCode.MISSING),
                               "msg": "no such endpoint"}}

    @staticmethod
    def _doc_id(raw: str) -> int:
        if not re.fullmatch(r"[0-9]+", raw):
            raise NxsError(ErrorCode.INVALID, "document ID must be a number")
        return int(raw)

    @staticmethod
    def _query_params(query: dict) -> Optional[Params]:
        """Query-string -> params JSON (query_string_to_params)."""
        args = {k: v[-1] for k, v in query.items()}
        args.pop("fetch", None)
        args.pop("store", None)
        if not args:
            return None
        for field in _NUM_FIELDS:
            if field in args:
                try:
                    args[field] = int(args[field])
                except ValueError:
                    try:
                        args[field] = float(args[field])
                    except ValueError:
                        raise NxsError(ErrorCode.INVALID,
                                       f"invalid {field}")
        for field in _BOOL_FIELDS:
            if field in args:
                args[field] = args[field].lower() not in (
                    "false", "0", "no", "off")
        return Params(args)

    def _create_index(self, name, body):
        params = Params.fromjson(body) if body else None
        with self._mutate_lock:
            idx = self.nxs.index_create(name, params)
        self.cache.put(name, idx)
        return 201, None

    def _destroy_index(self, name):
        # Validate BEFORE any deletion: the reference validates via
        # str_isalnumdu first (nxs.c:310); without this, a name like
        # ".." would rmtree paths outside the managed data/ tree.
        from ..utils.validate import str_isalnumdu
        if not name or not str_isalnumdu(name):
            raise NxsError(ErrorCode.INVALID, "invalid index name")
        self.cache.drop(name)
        self.blobs.destroy_index(name)
        with self._mutate_lock:
            self.nxs.index_destroy(name)
        return 200, None

    def _add(self, name, raw_id, query, body):
        doc_id = self._doc_id(raw_id)
        if body is None or not body:
            raise NxsError(ErrorCode.INVALID,
                           "no data or the data is too large")
        with self.cache.lease(name) as idx:
            if "store" in query:
                self.blobs.store(name, doc_id, body)
            params = self._query_params(query)
            with self._mutate_lock:
                idx.add(doc_id, body.decode("utf-8"), params)
        return 201, None

    def _remove(self, name, raw_id):
        with self.cache.lease(name) as idx:
            with self._mutate_lock:
                idx.remove(self._doc_id(raw_id))
        return 200, None

    def _search(self, name, query, body):
        if body is None or not body:
            raise NxsError(ErrorCode.INVALID,
                           "no data or the data is too large")
        params = self._query_params(query)
        with self.cache.lease(name) as idx:
            resp = idx.search(body.decode("utf-8"), params)
            if "fetch" in query:
                # Join the stored raw content (nxsearch_svc.lua:106-122).
                results = [
                    {"doc_id": doc_id, "score": score,
                     "content": self.blobs.fetch(name, doc_id)}
                    for doc_id, score in resp
                ]
                return 200, {"results": results, "count": len(results)}
        return 200, resp.tojson_obj()

    def _search_batch(self, name, query, body):
        """Batched extension endpoint (no reference equivalent):
        body = {"queries": ["...", ...]} -> {"responses": [...]}.
        Query-string params apply to every query in the batch."""
        try:
            payload = json.loads(body or b"")
        except ValueError:
            raise NxsError(ErrorCode.INVALID, "invalid JSON body")
        queries = payload.get("queries") if isinstance(payload, dict) else None
        if not isinstance(queries, list) or \
                not all(isinstance(q, str) for q in queries):
            raise NxsError(ErrorCode.INVALID,
                           'body must be {"queries": [<string>, ...]}')
        params = self._query_params(query)
        with self.cache.lease(name) as idx:
            responses = idx.search_many(queries, params)
        return 200, {"responses": [r.tojson_obj() for r in responses]}

    def _stats(self, name):
        """GET /{index}/stats -- live index statistics (observability
        extension; counts mirror idx_get_doc_count/token_count)."""
        with self.cache.lease(name) as idx:
            return 200, idx.stats()

    def _post_filter(self, name, query, body):
        if not self.enable_py_post:
            raise NxsError(ErrorCode.SYSTEM,
                           "Python code posting is not enabled")
        if not re.fullmatch(r"[A-Za-z0-9_]+", name):
            raise NxsError(ErrorCode.SYSTEM,
                           "filter name must be alphanumeric")
        source = (body or b"").decode("utf-8")
        load_filter(self.nxs.filters, name, source)
        if "store" in query:
            store_filter(self.nxs.basedir, name, source)
        return 201, None

    def close(self):
        self.nxs.close()


def make_handler(svc: SearchService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _run(self, method: str):
            parsed = urlparse(self.path)
            query = parse_qs(parsed.query, keep_blank_values=True)
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            status, payload = svc.handle(method, parsed.path, query, body)
            data = b""
            ctype = "application/json"
            if isinstance(payload, str):   # pre-rendered (e.g. /docs)
                data = payload.encode("utf-8")
                ctype = "text/html; charset=utf-8"
            elif payload is not None:
                data = json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            if data:
                self.wfile.write(data)

        def do_POST(self):
            self._run("POST")

        def do_DELETE(self):
            self._run("DELETE")

        def do_GET(self):
            self._run("GET")

        def log_message(self, fmt, *args):  # access log to stdout
            print(f"{self.address_string()} {fmt % args}")

    return Handler


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="nxsearch-tpu REST service")
    ap.add_argument("--basedir",
                    default=os.environ.get("NXS_BASEDIR"),
                    help="index base directory (default: $NXS_BASEDIR)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--prewarm", action="append", default=[],
                    metavar="INDEX",
                    help="open INDEX and compile-warm its serving "
                         "signatures before accepting traffic "
                         "(repeatable); with the persistent compile "
                         "cache, restarts reload executables instead "
                         "of recompiling")
    ap.add_argument("--no-jax-cache", action="store_true",
                    help="disable the persistent XLA compilation cache "
                         "(default: $JAX_COMPILATION_CACHE_DIR, else "
                         "<checkout>/.jax_cache)")
    args = ap.parse_args(argv)
    if not args.basedir:
        raise SystemExit("--basedir or NXS_BASEDIR required")

    from ..utils.malloc import tune_host_allocator
    tune_host_allocator()

    if not args.no_jax_cache:
        # Persistent compile cache: a first-of-its-shape query pays a
        # multi-second XLA compile exactly once per deployment, not
        # once per process (the device analogue of the reference's
        # mmap page-cache persistence).
        from ..utils.compile_cache import enable_compile_cache
        enable_compile_cache()

    svc = SearchService(args.basedir)
    for name in args.prewarm:
        t0 = time.monotonic()
        with svc.cache.lease(name) as idx:
            n = idx.prewarm()
        print(f"prewarmed '{name}': {n} signatures-covering queries "
              f"in {time.monotonic() - t0:.1f}s", flush=True)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(svc))
    print(f"nxsearch-tpu service on {args.host}:{args.port} "
          f"(basedir={args.basedir})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        svc.close()


if __name__ == "__main__":
    main()
