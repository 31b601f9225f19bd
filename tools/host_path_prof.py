"""Profile the ENTIRE host-side batch path with device calls stubbed.

Monkeypatches the device_search_* executors to return dummy arrays of
the right shape, so submit_query_batch + collect_query_batch measure
pure host work: prep, planning, grouping, buffer fills, unpack and
response building.  That host total is the pipelined-QPS ceiling
(steady state is max(host, device) per batch).  Dev tool.

Usage: JAX_PLATFORMS=cpu HP_DOCS=8800000 HP_VOCAB=1000000 HP_LEN=60 \
       python tools/host_path_prof.py
"""

import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    docs = int(os.environ.get("HP_DOCS", 1_000_000))
    vocab = int(os.environ.get("HP_VOCAB", 200_000))
    mean_len = int(os.environ.get("HP_LEN", 40))
    n_q, batch = 4096, 2048

    import bench as benchmod
    benchmod.enable_compile_cache(docs, mean_len)
    rng = np.random.default_rng(42)
    ranks = np.arange(vocab, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    words = np.array([f"w{i:05d}" for i in range(vocab)])
    queries = benchmod.make_queries(n_q, words, probs, rng)

    from nxsearch_tpu import Nxs, Params
    from nxsearch_tpu import search as S
    from nxsearch_tpu.ops import executor as E

    basedir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".bench_cache",
        f"d{docs}-v{vocab}-l{mean_len}-s42")
    t0 = time.perf_counter()
    nxs = Nxs(basedir)
    idx = nxs.index_open("bench")
    print(f"opened in {time.perf_counter() - t0:.1f}s", flush=True)

    sp = Params().set_uint("limit", 10)
    sp2 = S.get_search_params(idx.algo, sp)
    idx._read_synced()
    idx._rw.read_release()
    dev, pipeline = idx.dev, idx.pipeline
    fuzzy, prefetch = idx._fuzzy_lookup, idx._fuzzy_prefetch

    # ---- stub the device executors ------------------------------------
    class _FakeDev:
        def device(self):
            return None

    def _packed(n_pad, k):
        a = np.zeros((n_pad, 2, k), np.float32)
        return a

    real_sliced = E.device_search_sliced_packed

    def fake_sliced(postings_pack, alive_mask, doc_len, buf, adl,
                    dense_rows=None, *, qs, L, D, T, k, algo, n_slots,
                    use_mask, single, alive_all, use_rows, depth,
                    T_head, n_run):
        n_pad = int(buf.shape[0])
        kk = min(k, T) if (single and not use_mask and not use_rows) \
            else min(k, qs * T + T_head) if not use_rows \
            else min(k, n_slots)
        return _packed(n_pad, kk)

    def fake_dense(*args, k, n_slots, **kw):
        q_start = np.asarray(args[4])
        n = q_start.shape[0]
        return (np.zeros((n, min(k, n_slots)), np.float32),
                np.zeros((n, min(k, n_slots)), np.int32))

    def fake_batch(*args, budget, k, **kw):
        q_start = np.asarray(args[4])
        n = q_start.shape[0]
        kk = min(k, budget)
        return (np.zeros((n, kk), np.float32),
                np.zeros((n, kk), np.int32))

    E.device_search_sliced_packed = fake_sliced
    E.device_search_dense_batch = fake_dense
    E.device_search_batch = fake_batch
    S.device_search_dense_batch = fake_dense  # imported into module ns

    # unpack twins must cope with the dummy arrays (they already do:
    # packed [N, 2, k]).

    batches = [queries[i: i + batch] for i in range(0, n_q, batch)]

    # Warm pass.
    for qs_ in batches:
        prepared = S._prepare_many(dev, pipeline, qs_, sp2, fuzzy,
                                   prefetch)
        st = S.submit_query_batch(dev, prepared, sp2)
        S.collect_query_batch(dev, st, sp2)

    for rep in range(3):
        for b, qs_ in enumerate(batches):
            t0 = time.perf_counter()
            prepared = S._prepare_many(dev, pipeline, qs_, sp2, fuzzy,
                                       prefetch)
            t1 = time.perf_counter()
            st = S.submit_query_batch(dev, prepared, sp2)
            t2 = time.perf_counter()
            out = S.collect_query_batch(dev, st, sp2)
            t3 = time.perf_counter()
            assert len(out) == len(qs_)
            print(f"rep{rep} b{b}: prepare {1e3 * (t1 - t0):7.1f} ms  "
                  f"submit {1e3 * (t2 - t1):7.1f} ms  "
                  f"collect {1e3 * (t3 - t2):7.1f} ms  "
                  f"total {1e6 * (t3 - t0) / len(qs_):5.0f} us/q",
                  flush=True)

    pr = cProfile.Profile()
    pr.enable()
    for qs_ in batches:
        prepared = S._prepare_many(dev, pipeline, qs_, sp2, fuzzy,
                                   prefetch)
        st = S.submit_query_batch(dev, prepared, sp2)
        S.collect_query_batch(dev, st, sp2)
    pr.disable()
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(30)
    print(out.getvalue())
    nxs.close()


if __name__ == "__main__":
    main()
