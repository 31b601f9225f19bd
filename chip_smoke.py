#!/usr/bin/env python3
"""End-to-end check that the search engine runs on NVIDIA GPUs.

Run from the repository root on a machine with the card(s):

    python chip_smoke.py                       # one GPU, 1M-doc tier
    python chip_smoke.py --docs 8800000 --vocab 1000000 --mean-len 60
    python chip_smoke.py --devices 4           # doc-sharded mesh only

One GPU, in this order, with no phase catching its own failure:

1. preflight, before JAX is imported: the card's name and power
   limit (nvidia-smi), whether the native tokenizer built, and the
   ``gpu`` test lane (``pytest -m gpu`` in a child process that ends
   before this process touches the card);
2. device check: the first JAX device must be a GPU;
3. build: a seeded Zipf corpus (bench.py's generator) ingested by
   parallel writer processes, checkpointed, closed and reopened from
   the snapshot;
4. serve through the public API: prewarm, search, search_many at a
   batch of 2048, search_pipelined, ranked / boolean / typo traffic,
   BM25 at limits 10 and 1000 and TF-IDF, then removals and additions
   (the delta path);
5. REST: SearchService on a thread of this process, driven through
   urllib;
6. comparison with the float64 reference (nxsearch_tpu/reference.py)
   on a sample of ranked, boolean and typo queries;
7. report: executor counters, fuzzy route, compiles, device memory.

``--devices 4`` builds the same corpus and serves the comparison
sample through ``Nxs(mesh=make_mesh(...))`` over four GPUs and through
an unsharded index on device 0, both checked against the reference;
it runs no other phase.

Any failure exits non-zero before the result line.  The last line of
standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BATCH = 2048
N_FUZZY_BATCH = 512
# Scores are compared within this relative tolerance.  No path on the
# way does a matrix product, so TF32 does not apply; the device sums a
# document's per-term contributions in float32 with scatter-adds
# (candidate_topk's .at[seg].add, the dense executor) whose order
# changes from run to run, so the last bits differ from the float64
# reference and between runs.
SCORE_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def timed(name: str, card: str):
    t0 = time.perf_counter()
    yield
    log(f"[time] {name}: {time.perf_counter() - t0:.3f} s ({card})")


# -- 1. preflight (no JAX) -------------------------------------------------

def card_lines() -> list:
    """The cards' name and power limit, one line per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise SystemExit(f"no NVIDIA GPU: nvidia-smi failed ({e})")
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise SystemExit("no NVIDIA GPU: nvidia-smi lists no card")
    return lines


def card_line() -> str:
    return card_lines()[0]


def native_status() -> str:
    """Build native/ (g++) and load the tokenizer library."""
    native = os.path.join(ROOT, "native")
    lib = os.path.join(native, "libnxstext.so")
    subprocess.run(["make", "-C", native, "-s"], capture_output=True,
                   timeout=300)
    try:
        ctypes.CDLL(lib)
    except OSError as e:
        return f"NOT built ({e}); ingest runs the Python fallback"
    return f"built ({os.path.relpath(lib, ROOT)})"


def run_gpu_tests() -> None:
    """The ``gpu`` test lane, in a child that exits before this
    process opens the card (one JAX process per card)."""
    env = dict(os.environ, NXS_TEST_PLATFORM="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "-p", "no:randomly", "tests"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-15:]
    for ln in tail:
        log(f"  | {ln}")
    if proc.returncode != 0:
        raise SystemExit(f"gpu test lane failed (exit {proc.returncode})")


def preflight(args) -> str:
    cards = card_lines()
    for line in cards:
        log(f"card: {line}")
    card = cards[0]
    log(f"native tokenizer: {native_status()}")
    if args.devices == 1:
        log("gpu test lane: NXS_TEST_PLATFORM=cuda pytest -m gpu")
        run_gpu_tests()
    return card


# -- 2. device check -------------------------------------------------------

def require_gpu(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < n:
        raise SystemExit(f"--devices {n} needs {n} GPUs; JAX found "
                         f"{len(devs)}")
    return devs


# -- 3. build --------------------------------------------------------------

def vocabulary(vocab: int):
    """bench.py's query-side vocabulary: words and Zipf weights."""
    import numpy as np

    ranks = np.arange(vocab, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    words = np.array([f"w{i:05d}" for i in range(vocab)])
    return words, probs


def build(basedir: str, args, card: str) -> None:
    import bench
    from nxsearch_tpu import Nxs, parallel_ingest

    nxs = Nxs(basedir)
    nxs.index_create("smoke")
    nxs.close()
    workers = min(os.cpu_count() or 1, 8)
    t0 = time.perf_counter()
    parallel_ingest(basedir, "smoke",
                    functools.partial(bench.zipf_range, vocab=args.vocab,
                                      mean_len=args.mean_len),
                    args.docs, workers=workers)
    secs = time.perf_counter() - t0
    log(f"ingest: {args.docs} docs, {workers} writers, {secs:.1f} s "
        f"({args.docs / secs:.0f} docs/s, host CPU)")
    nxs = Nxs(basedir)
    idx = nxs.index_open("smoke")
    if idx.host.doc_count != args.docs:
        raise SystemExit(f"ingested {idx.host.doc_count} docs, "
                         f"expected {args.docs}")
    with timed("checkpoint", card):
        idx.checkpoint()    # False when the writers' close saved it
    nxs.close()


# -- 4. serve --------------------------------------------------------------

def check_responses(responses, limit: int, what: str) -> None:
    import numpy as np

    for r in responses:
        scores = np.asarray([s for _, s in r], dtype=np.float64)
        if len(scores) > limit or not np.isfinite(scores).all() \
                or (scores <= 0).any() or (np.diff(scores) > 0).any():
            raise SystemExit(f"{what}: malformed response {r.results[:5]}")


def serve(idx, queries: dict, card: str) -> None:
    from nxsearch_tpu import Params

    bm25_10 = Params().set_uint("limit", 10)
    bm25_1000 = Params().set_uint("limit", 1000)
    tfidf_10 = Params().set_uint("limit", 10).set_str("algo", "TF-IDF")
    with timed("prewarm", card):
        n = idx.prewarm(bm25_10)
    log(f"prewarm: {n} warmup queries")
    for q in queries["ranked"][:16]:
        check_responses([idx.search(q, bm25_10)], 10, "search")
    ranked = queries["ranked"][:BATCH]
    for what in ("first pass", "second pass"):
        with timed(f"search_many ranked x{BATCH} BM25 limit 10, {what}",
                   card):
            out = idx.search_many(ranked, bm25_10)
    check_responses(out, 10, "search_many")
    if sum(len(r) for r in out) == 0:
        raise SystemExit("ranked batch matched nothing")
    with timed(f"search_many ranked x{BATCH} BM25 limit 1000", card):
        check_responses(idx.search_many(ranked, bm25_1000), 1000,
                        "limit 1000")
    with timed(f"search_many ranked x{BATCH} TF-IDF limit 10", card):
        check_responses(idx.search_many(ranked, tfidf_10), 10, "TF-IDF")
    with timed(f"search_many mixed x{BATCH} BM25 limit 10", card):
        check_responses(idx.search_many(queries["mixed"][:BATCH],
                                        bm25_10), 10, "mixed")
    batches = [queries["ranked"][i: i + BATCH]
               for i in range(0, len(queries["ranked"]), BATCH)]
    with timed(f"search_pipelined {len(batches)} x {BATCH}", card):
        for out in idx.search_pipelined(batches, bm25_10):
            check_responses(out, 10, "search_pipelined")
    with timed(f"fuzzy batch x{N_FUZZY_BATCH} (typo queries, end to end)",
               card):
        check_responses(idx.search_many(queries["fuzzy_batch"], bm25_10),
                        10, "fuzzy batch")


@contextlib.contextmanager
def fallback_routing():
    """Route every query the way the CPU always has: candidate (sort +
    segment sum) or dense executors, with the prefix and sliced
    executors declined -- the queries a block-accumulation kernel
    once served."""
    import nxsearch_tpu.search as S

    saved = S._use_sliced, S._prefix_mode
    S._use_sliced = lambda *a: False
    S._prefix_mode = lambda *a: False
    try:
        yield
    finally:
        S._use_sliced, S._prefix_mode = saved


def counted(idx, queries, params, keys: tuple, card: str, what: str):
    """search_many, timed, with every query counted under ``keys``."""
    from nxsearch_tpu.search import EXEC_STATS

    before = dict(EXEC_STATS)
    with timed(f"{what}, first pass", card):
        idx.search_many(queries, params)
    with timed(f"{what}, second pass", card):
        out = idx.search_many(queries, params)
    delta = {k: (v - before.get(k, 0)) // 2 for k, v in EXEC_STATS.items()
             if v != before.get(k, 0)}
    if sum(delta.get(k, 0) for k in keys) != len(queries):
        raise SystemExit(f"{what}: expected {len(queries)} queries on "
                         f"{keys}, executor counters moved {delta}")
    log(f"  executors: {delta}")
    return out


def routing(idx, queries: dict, card: str) -> None:
    """The executors that the prefix and sliced paths decline, timed
    on their own, and the masked dense-row hybrid's route."""
    import numpy as np

    from nxsearch_tpu import Params

    p = Params().set_uint("limit", 10)
    words = [q.split() for q in queries["ranked"]]
    dense = [idx.host.term_values[t - 1] for t in idx.dev.dense_row_of]
    if not dense:
        raise SystemExit("no dense-row terms at this tier")
    # Masked queries with a dense-row term stay on the sliced hybrid.
    masked = [f"{dense[i % len(dense)]} AND {w[0]}" if i % 2 else
              f"{w[0]} {w[1]} AND NOT {dense[i % len(dense)]}"
              for i, w in enumerate(words[:64])]
    check_responses(counted(idx, masked, p, ("sliced",), card,
                            "masked dense-row hybrid x64"), 10, "masked")
    # Boolean queries over more than 32 terms: the dense executor.
    rng = np.random.default_rng(1)
    vocab = sorted({t for w in words for t in w})
    wide = ["(" + " ".join(rng.choice(vocab, 40, replace=False)) +
            f") AND NOT {w[0]}" for w in words[:64]]
    check_responses(counted(idx, wide, p, ("dense",), card,
                            "40-term boolean x64 (dense executor)"),
                    10, "wide")
    with fallback_routing():
        check_responses(counted(
            idx, queries["ranked"][:BATCH], p, ("candidate", "dense"),
            card, f"ranked x{BATCH} via the candidate/dense executors"), 10,
            "candidate")
        bools = [q for q in queries["mixed"] if " AND " in q][:256]
        check_responses(counted(
            idx, bools, p, ("candidate", "dense"), card,
            f"boolean x{len(bools)} via the candidate/dense executors"), 10,
            "candidate boolean")


def mutate(idx, args) -> None:
    """Removals and additions after the base snapshot: the delta path."""
    import bench
    from nxsearch_tpu import Params

    p = Params().set_uint("limit", 1000)

    def rare_and(text: str) -> str:
        # The doc's rarest words (highest Zipf rank), AND-ed: a small
        # result set that must contain the doc itself.
        words = sorted(set(text.split()), reverse=True)[:6]
        return " AND ".join(words)

    gone = bench.zipf_range(1, 6, args.vocab, args.mean_len)
    probes = [rare_and(text) for _, text in gone]
    for (doc_id, _), q in zip(gone, probes):
        if doc_id not in {d for d, _ in idx.search(q, p)}:
            raise SystemExit(f"doc {doc_id} does not match {q!r}")
    for doc_id, _ in gone:
        idx.remove(doc_id)
    for (doc_id, _), q in zip(gone, probes):
        if doc_id in {d for d, _ in idx.search(q, p)}:
            raise SystemExit(f"removed doc {doc_id} is still returned")
    extra = [(doc_id, f"{text} zzadded{i}") for i, (doc_id, text) in
             enumerate(bench.zipf_range(args.docs, args.docs + 5,
                                        args.vocab, args.mean_len))]
    idx.add_many(extra)
    for i, (doc_id, text) in enumerate(extra):
        if [d for d, _ in idx.search(f"zzadded{i}", p)] != [doc_id] or \
                doc_id not in {d for d, _ in idx.search(rare_and(text), p)}:
            raise SystemExit(f"added doc {doc_id} is not found")
    log("delta: 5 removals and 5 additions served")


# -- 5. REST ---------------------------------------------------------------

def rest(basedir: str, ranked_query: str, idx) -> None:
    import urllib.request
    from http.server import ThreadingHTTPServer

    from nxsearch_tpu.reference import compare_results
    from nxsearch_tpu.service.app import SearchService, make_handler

    svc = SearchService(basedir)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def call(method: str, path: str, body: bytes = b"", want: int = 200):
        req = urllib.request.Request(base + path, data=body, method=method)
        with urllib.request.urlopen(req, timeout=600) as resp:
            if resp.status != want:
                raise SystemExit(f"{method} {path}: HTTP {resp.status}")
            data = resp.read()
        return json.loads(data) if data else None

    try:
        call("POST", "/restsmoke", want=201)
        docs = {1: "the quick brown fox jumped over the lazy dog",
                2: "dogs and cats living together",
                3: "a fox and a dog"}
        for doc_id, text in docs.items():
            call("POST", f"/restsmoke/add/{doc_id}", text.encode(),
                 want=201)
        got = call("POST", "/restsmoke/search", b"fox")
        if {r["doc_id"] for r in got["results"]} != {1, 3}:
            raise SystemExit(f"REST search: {got}")
        got = call("POST", "/restsmoke/search_batch",
                   json.dumps({"queries": ["dog", "cat AND dog"]}).encode())
        if [r["count"] for r in got["responses"]] != [3, 1]:
            raise SystemExit(f"REST search_batch: {got}")
        # The big index through the service agrees with the library.
        got = call("POST", "/smoke/search?limit=10", ranked_query.encode())
        lib = [(d, s) for d, s in idx.search(ranked_query)]
        err = compare_results([(r["doc_id"], r["score"])
                               for r in got["results"]], lib, 10,
                              SCORE_RTOL)
        if err:
            raise SystemExit(f"REST /smoke/search: {err}")
        call("DELETE", "/restsmoke")
        log("rest: create, add, search, search_batch, delete: ok")
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        svc.close()


# -- 6. reference comparison -----------------------------------------------

def sample(queries: dict) -> dict:
    boolean = [q for q in queries["mixed"] if " AND " in q][:16]
    return {"ranked": queries["ranked"][-32:], "boolean": boolean,
            "fuzzy": queries["fuzzy_sample"]}


CONFIGS = (("BM25", 10), ("BM25", 1000), ("TF-IDF", 10))


def reference_results(ref, smp: dict) -> dict:
    """(kind, algo) -> every match of every sample query, ranked."""
    return {(kind, algo): ref.search_many(qs, algo=algo, limit=10 ** 9)
            for kind, qs in smp.items() for algo in ("BM25", "TF-IDF")}


def compare(label: str, idx, wants: dict, smp: dict) -> int:
    """Engine (batched and sequential) against the float64 reference;
    returns the number of (query, config) pairs checked."""
    from nxsearch_tpu import Params
    from nxsearch_tpu.reference import compare_results

    failures = []
    n = 0
    for kind, qs in smp.items():
        for algo, limit in CONFIGS:
            p = Params().set_uint("limit", limit).set_str("algo", algo)
            want = wants[kind, algo]
            batched = idx.search_many(qs, p)
            for i, q in enumerate(qs):
                got = [(d, s) for d, s in batched[i]]
                err = compare_results(got, want[i], limit, SCORE_RTOL)
                if err is None and i < 4:
                    seq = [(d, s) for d, s in idx.search(q, p)]
                    err = compare_results(seq, want[i], limit, SCORE_RTOL)
                    err = err and f"sequential: {err}"
                n += 1
                if err:
                    failures.append(f"{label} {kind} {algo}/{limit} "
                                    f"{q!r}: {err}")
    for f in failures[:20]:
        log(f"MISMATCH {f}")
    if failures:
        raise SystemExit(f"{label}: {len(failures)} of {n} results differ "
                         f"from the reference")
    log(f"reference ({label}): {n} (query, config) results agree "
        f"(doc sets up to ties at the limit, scores within {SCORE_RTOL})")
    return n


def compare_fuzzy_picks(idx, ref, smp: dict) -> None:
    """Device fuzzy picks equal the host levdist choice exactly."""
    from nxsearch_tpu.query.parser import parse_query
    from nxsearch_tpu.reference import _leaves

    values = []
    for q in smp["fuzzy"]:
        for v in _leaves(parse_query(q)):
            f = idx.pipeline.run(v)
            if f is not None and idx.host.term_lookup(f) is None:
                values.append(f)
    matcher = idx._fuzzy_matcher()
    matcher.prefetch(values)
    got = [matcher.lookup(v) for v in values]
    want = [ref.fuzzy_pick(v) for v in values]
    bad = [(v, g, w) for v, g, w in zip(values, got, want) if g != w]
    if bad or not values:
        raise SystemExit(f"fuzzy picks differ from levdist: {bad[:5]} "
                         f"({len(values)} typos)")
    if all(w is None for w in want):
        raise SystemExit("no typo resolved: the fuzzy check is vacuous")
    route = "Pallas/Triton kernel" if getattr(matcher, "_kernel", False) \
        else "jnp Myers sweep"
    log(f"fuzzy: {len(values)} typo picks equal levdist's; "
        f"device route: {route}")


# -- main --------------------------------------------------------------------

def make_queries(args) -> dict:
    import numpy as np

    import bench

    rng = np.random.default_rng(args.seed)
    words, probs = vocabulary(args.vocab)
    return {
        "ranked": bench.make_queries(2 * BATCH, words, probs, rng),
        "mixed": bench.make_mixed_queries(BATCH, words, probs, rng),
        "fuzzy_batch": bench.make_fuzzy_queries(N_FUZZY_BATCH, words,
                                                probs, rng, "x"),
        "fuzzy_sample": bench.make_fuzzy_queries(16, words, probs, rng,
                                                 "y"),
    }


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--mean-len", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0,
                    help="query sample seed (the corpus generator is "
                         "block-seeded, bench.zipf_range)")
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: the doc-sharded mesh path only")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    card = preflight(args)
    devs = require_gpu(args.devices)

    import jax

    import bench

    compiles = [0, 0.0]

    def on_duration(event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles[0] += 1
            compiles[1] += secs

    jax.monitoring.register_event_duration_secs_listener(on_duration)
    log(f"compile cache: "
        f"{bench.enable_compile_cache(args.docs, args.mean_len)}")
    queries = make_queries(args)
    from nxsearch_tpu import Nxs
    from nxsearch_tpu.reference import ReferenceIndex

    with tempfile.TemporaryDirectory(prefix="nxs-smoke-") as basedir:
        with timed("build", card):
            build(basedir, args, card)
        smp = sample(queries)
        if args.devices == 4:
            from nxsearch_tpu.parallel import make_mesh

            mesh_nxs = Nxs(basedir, mesh=make_mesh(devs[:4]))
            one_nxs = Nxs(basedir)
            sharded = mesh_nxs.index_open("smoke")
            single = one_nxs.index_open("smoke")
            with timed("float64 reference", card):
                wants = reference_results(
                    ReferenceIndex(single.host, single.pipeline), smp)
            with timed("sharded (4 GPUs) vs reference", card):
                compare("mesh x4", sharded, wants, smp)
            with timed("device 0 vs reference", card):
                compare("device 0", single, wants, smp)
            mesh_nxs.close()
            one_nxs.close()
        else:
            nxs = Nxs(basedir)
            with timed("reopen from snapshot", card):
                idx = nxs.index_open("smoke")
                idx.search(queries["ranked"][0])
            serve(idx, queries, card)
            routing(idx, queries, card)
            with timed("removals + additions", card):
                mutate(idx, args)
            with timed("rest", card):
                rest(basedir, queries["ranked"][1], idx)
            with timed("float64 reference", card):
                ref = ReferenceIndex(idx.host, idx.pipeline)
                wants = reference_results(ref, smp)
            with timed("reference comparison", card):
                compare("1 GPU", idx, wants, smp)
                with fallback_routing():
                    compare("1 GPU, candidate/dense", idx, wants, smp)
                compare_fuzzy_picks(idx, ref, smp)
            from nxsearch_tpu.search import EXEC_STATS
            log(f"EXEC_STATS: {json.dumps(dict(sorted(EXEC_STATS.items())))}")
            nxs.close()

    log(f"compiles: {compiles[0]} backend compiles, {compiles[1]:.1f} s")
    for d in devs[: args.devices]:
        st = d.memory_stats() or {}
        log(f"memory {d}: peak_bytes_in_use={st.get('peak_bytes_in_use')} "
            f"bytes_limit={st.get('bytes_limit')}")
    for line in card_lines():
        log(f"card: {line}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
