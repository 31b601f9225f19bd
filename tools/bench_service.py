"""Service-level benchmark: drive the REST layer end-to-end over HTTP.

The library QPS number bypasses the HTTP stack; this measures what a client actually sees.  Starts the stdlib
ThreadingHTTPServer service (`nxsearch_tpu.service`) over the cached
bench index, then drives it with concurrent keep-alive clients:

  - batch endpoint: N client threads, each POSTing
    /bench/search_batch with `--req-batch` queries per request
    (the serving shape -- mirrors the reference's nginx upstream
    fan-in, /root/reference/compose/nginx.conf:33-63);
  - single-query endpoint: sequential POST /bench/search latency.

Prints one JSON line with service QPS + request/query latencies.

Usage: python tools/bench_service.py [--docs N --vocab N --mean-len N]
       [--queries N] [--req-batch N] [--clients N] [--port P]
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def wait_ready(port: int, deadline_s: float) -> None:
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            c.request("GET", "/bench/stats")
            r = c.getresponse()
            r.read()
            c.close()
            if r.status == 200:
                return
        except OSError:
            time.sleep(2.0)
    raise SystemExit("service did not become ready")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=8_800_000)
    ap.add_argument("--vocab", type=int, default=1_000_000)
    ap.add_argument("--mean-len", type=int, default=60)
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--req-batch", type=int, default=256,
                    help="queries per search_batch request")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64,
                    help="sequential single-query latency samples")
    ap.add_argument("--port", type=int, default=8645)
    ap.add_argument("--open-timeout", type=float, default=900.0)
    args = ap.parse_args()

    import bench as benchmod
    rng = np.random.default_rng(42)
    ranks = np.arange(args.vocab, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    words = np.array([f"w{i:05d}" for i in range(args.vocab)])
    queries = benchmod.make_queries(args.queries, words, probs, rng)

    basedir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_cache", f"d{args.docs}-v{args.vocab}-l{args.mean_len}-s42")
    if not os.path.isdir(os.path.join(basedir, "data", "bench")):
        raise SystemExit(f"no cached bench index at {basedir}; "
                         f"run bench.py first")

    # The service child is this run's only JAX process (this parent
    # never imports JAX), and it shares bench.py's persistent compile
    # cache (utils/compile_cache.py), loading executables instead of
    # recompiling the serving signatures.
    proc = subprocess.Popen(
        [sys.executable, "-m", "nxsearch_tpu.service",
         "--basedir", basedir, "--host", "127.0.0.1",
         "--port", str(args.port)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        print(f"[svc] waiting for snapshot open on :{args.port} ...",
              file=sys.stderr, flush=True)
        wait_ready(args.port, args.open_timeout)

        reqs = [queries[i: i + args.req_batch]
                for i in range(0, len(queries), args.req_batch)]

        def run_clients(tag: str) -> tuple[float, list[float]]:
            lock = threading.Lock()
            it = iter(reqs)
            lats: list[float] = []

            def worker():
                conn = http.client.HTTPConnection(
                    "127.0.0.1", args.port, timeout=600)
                while True:
                    with lock:
                        chunk = next(it, None)
                    if chunk is None:
                        break
                    body = json.dumps({"queries": chunk}).encode()
                    t0 = time.perf_counter()
                    conn.request("POST", "/bench/search_batch?limit=10",
                                 body=body)
                    r = conn.getresponse()
                    payload = json.loads(r.read())
                    dt = time.perf_counter() - t0
                    assert r.status == 200, (r.status, payload)
                    assert len(payload["responses"]) == len(chunk)
                    with lock:
                        lats.append(dt)
                conn.close()

            threads = [threading.Thread(target=worker)
                       for _ in range(args.clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            el = time.perf_counter() - t0
            print(f"[svc] {tag}: {len(queries)} queries / {len(reqs)} "
                  f"requests x {args.clients} clients in {el:.2f}s -> "
                  f"{len(queries) / el:.0f} QPS", file=sys.stderr,
                  flush=True)
            return el, lats

        run_clients("warmup")          # compiles / executable loads
        elapsed, lats = run_clients("measured")
        qps = len(queries) / elapsed
        lats_ms = np.sort(np.asarray(lats)) * 1e3

        # Sequential single-query latency over the plain endpoint.
        conn = http.client.HTTPConnection("127.0.0.1", args.port,
                                          timeout=600)
        seq = []
        for q in queries[: args.seq] * 2:  # first half warms
            t0 = time.perf_counter()
            conn.request("POST", "/bench/search?limit=10",
                         body=q.encode())
            r = conn.getresponse()
            r.read()
            assert r.status == 200
            seq.append(time.perf_counter() - t0)
        conn.close()
        warm = np.sort(np.asarray(seq[args.seq:])) * 1e3

        print(json.dumps({
            "metric": "service_http_qps",
            "value": round(qps, 1),
            "unit": "queries/s",
            "detail": {
                "docs": args.docs, "clients": args.clients,
                "req_batch": args.req_batch,
                "request_p50_ms": round(float(np.median(lats_ms)), 1),
                "request_p99_ms": round(float(lats_ms[-1]), 1),
                "seq_query_p50_ms": round(float(np.median(warm)), 1),
                "seq_query_p99_ms": round(float(warm[-1]), 1),
            },
        }))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


if __name__ == "__main__":
    main()
