"""Instrument the submit loop for a fuzzy-typo batch (dev tool).

Wraps the executor entry points with wall-clock timers to find where
submit_query_batch spends its time on the fuzzy tier (512 typo
queries, warm)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import bench as B


def main():
    docs, vocab, mean_len = 8_800_000, 1_000_000, 60
    B.enable_compile_cache(docs, mean_len)
    rng = np.random.default_rng(7)
    ranks = np.arange(vocab, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    words = np.array([f"w{i:05d}" for i in range(vocab)])

    from nxsearch_tpu import Nxs, Params
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    basedir = os.path.join(root, ".bench_cache",
                           f"d{docs}-v{vocab}-l{mean_len}-s42")
    nxs = Nxs(basedir)
    idx = nxs.index_open("bench")
    sp = Params().set_uint("limit", 10)

    # Warm: plain batch + one fuzzy batch.
    idx.search_many(B.make_queries(2048, words, probs, rng), sp)
    idx.search_many(B.make_fuzzy_queries(512, words, probs, rng, "w"), sp)

    from nxsearch_tpu.ops import executor as E

    for name in ("device_search_prefix_packed",
                 "device_search_sliced_packed",
                 "pack_prefix_group", "pack_sliced_group"):
        orig = getattr(E, name)

        def wrap(*a, _orig=orig, _name=name, **kw):
            t0 = time.perf_counter()
            out = _orig(*a, **kw)
            dt = time.perf_counter() - t0
            if dt > 0.005:
                print(f"    {_name}: {dt * 1e3:.1f} ms", flush=True)
            return out
        setattr(E, name, wrap)

    fq = B.make_fuzzy_queries(512, words, probs, rng, "z")
    t0 = time.perf_counter()
    idx.search_many(fq, sp)
    print(f"fuzzy batch total {time.perf_counter() - t0:.2f}s")
    nxs.close()


if __name__ == "__main__":
    main()
