"""Dispatch-plan statistics over the bench query mix (device stubbed).

Runs the REAL planner + grouping + dispatch path against the cached
bench corpus with fake device executors, and reports the counts that
determine device cost: dispatch-group count (each group is a launch
plus an upload), sort-plane lanes, head-plane (top_k) lanes, and
fetch volume.  Counts only -- no time is modeled.  Compares the pair-head
rule ON (default) vs OFF (_HEAD_MIN_DF_PAIR = _HEAD_MIN_DF) so the
routing change's group-structure impact is visible without a chip.

Usage: JAX_PLATFORMS=cpu python tools/plan_stats.py [--docs N ...]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=8_800_000)
    ap.add_argument("--vocab", type=int, default=1_000_000)
    ap.add_argument("--mean-len", type=int, default=60)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--mixed", action="store_true",
                    help="boolean + fuzzy trace mix")
    args = ap.parse_args()

    # Device calls are stubbed, but the index-open path still builds
    # small device arrays: pin the CPU backend via jax.config (a JAX
    # imported before JAX_PLATFORMS is read ignores the variable, and
    # this tool must not take a GPU from a concurrent bench).
    import jax
    jax.config.update("jax_platforms", "cpu")

    import bench as benchmod
    benchmod.enable_compile_cache(args.docs, args.mean_len)
    rng = np.random.default_rng(42)
    ranks = np.arange(args.vocab, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    words = np.array([f"w{i:05d}" for i in range(args.vocab)])
    make = benchmod.make_mixed_queries if args.mixed \
        else benchmod.make_queries
    queries = make(args.queries, words, probs, rng)

    from nxsearch_tpu import Nxs, Params
    from nxsearch_tpu import search as S
    from nxsearch_tpu.ops import executor as E

    basedir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_cache",
        f"d{args.docs}-v{args.vocab}-l{args.mean_len}-s42")
    nxs = Nxs(basedir)
    idx = nxs.index_open("bench")
    sp = Params().set_uint("limit", 10)
    sp2 = S.get_search_params(idx.algo, sp)
    idx._read_synced()
    idx._rw.read_release()
    dev, pipeline = idx.dev, idx.pipeline
    fuzzy, prefetch = idx._fuzzy_lookup, idx._fuzzy_prefetch

    calls = []

    def fake_sliced(postings_pack, alive_mask, doc_len, buf, adl,
                    dense_rows=None, *, qs, L, D, T, k, algo, n_slots,
                    use_mask, single, alive_all, use_rows, depth,
                    T_head, n_run):
        per = (3 * qs + (2 * L if use_mask else 0)
               + (2 * D if use_rows else 0) + (5 if T_head else 0)
               + (qs if (use_mask and n_run) else 0))
        n_pad = int(buf.shape[0]) // per
        calls.append(dict(kind="sliced", rows=n_pad, qs=qs, T=T,
                          T_head=T_head, n_run=n_run, mask=use_mask,
                          single=single, rows_hybrid=use_rows))
        kk = min(k, T) if (single and not use_mask and not use_rows) \
            else min(k, qs * T + T_head) if not use_rows \
            else min(k, n_slots)
        return np.zeros((n_pad, 2, kk), np.float32)

    def fake_dense(*a, k, n_slots, **kw):
        n = np.asarray(a[4]).shape[0]
        calls.append(dict(kind="dense", rows=n))
        return (np.zeros((n, min(k, n_slots)), np.float32),
                np.zeros((n, min(k, n_slots)), np.int32))

    def fake_batch(*a, budget, k, **kw):
        n = np.asarray(a[4]).shape[0]
        calls.append(dict(kind="candidate", rows=n))
        kk = min(k, budget)
        return (np.zeros((n, kk), np.float32),
                np.zeros((n, kk), np.int32))

    def fake_prefix(postings_pack, alive_mask, buf, adl, *, qs, R, T,
                    k, M, algo, n_slots, alive_all, n_run, k_ret=0):
        per = 4 * qs + 4 * R
        n_pad = int(np.asarray(buf).shape[0]) // per
        calls.append(dict(kind="prefix", rows=n_pad, qs=qs, T=T, R=R,
                          n_run=n_run))
        kk = min(k, qs * T) if R == 0 else min(k, min(M, qs * T))
        out = np.zeros((n_pad, 3, kk), np.float32)
        out[:, 2, :] = 1.0          # certified: no fallback re-run
        return out

    E.device_search_prefix_packed = fake_prefix
    E.device_search_sliced_packed = fake_sliced
    E.device_search_dense_batch = fake_dense
    E.device_search_batch = fake_batch
    S.device_search_dense_batch = fake_dense

    def run(label):
        calls.clear()
        prepared = S._prepare_many(dev, pipeline, queries, sp2, fuzzy,
                                   prefetch)
        st = S.submit_query_batch(dev, prepared, sp2)
        S.collect_query_batch(dev, st, sp2)
        sort_lanes = head_lanes = plane_lanes = 0
        fetch_mb = 0.0
        for c in calls:
            if c["kind"] == "prefix":
                lanes = c["rows"] * c["qs"] * c["T"]
                plane_lanes += lanes
                if c["n_run"] != 1:
                    sort_lanes += lanes
                fetch_mb += lanes * 12 / 1e6
                continue
            if c["kind"] != "sliced":
                continue
            lanes = c["rows"] * c["qs"] * c["T"]
            plane_lanes += lanes
            if not c["single"] and c["n_run"] != 1:
                sort_lanes += lanes
            head_lanes += c["rows"] * c["T_head"]
            fetch_mb += (lanes + c["rows"] * c["T_head"]) * 12 / 1e6
        n_groups = len(calls)
        print(f"{label}: {n_groups} dispatches "
              f"({sum(1 for c in calls if c['kind'] == 'sliced')} sliced"
              f", {sum(1 for c in calls if c['kind'] != 'sliced')} other)")
        print(f"  plane lanes {plane_lanes/1e6:.1f}M "
              f"(sorted {sort_lanes/1e6:.1f}M), "
              f"head lanes {head_lanes/1e6:.1f}M, fetch {fetch_mb:.0f} MB")
        for c in calls:
            if c["kind"] == "sliced":
                print(f"    sliced rows={c['rows']:<5} qs={c['qs']:<4} "
                      f"T={c['T']:<6} T_head={c['T_head']:<6} "
                      f"n_run={c['n_run']} mask={int(c['mask'])} "
                      f"single={int(c['single'])} "
                      f"hybrid={int(c['rows_hybrid'])}")
            elif c["kind"] == "prefix":
                print(f"    prefix rows={c['rows']:<5} qs={c['qs']:<4} "
                      f"T={c['T']:<6} R={c['R']} n_run={c['n_run']}")
            else:
                print(f"    {c['kind']} rows={c['rows']}")

    run("pair rule ON ")
    saved = S._HEAD_MIN_DF_PAIR
    S._HEAD_MIN_DF_PAIR = S._HEAD_MIN_DF
    try:
        run("pair rule OFF")
    finally:
        S._HEAD_MIN_DF_PAIR = saved

    # Padding-knob sweep: window width x column-pad floor (exactness-
    # neutral; pick the winner on real hardware via NXS_WINDOW_T /
    # NXS_QS_MIN).
    saved_t, saved_q = S._WINDOW_T, S._QS_MIN
    try:
        for t0 in (4096, 2048, 1024):
            for qmin in (4, 2):
                S._WINDOW_T, S._QS_MIN = t0, qmin
                run(f"T0={t0} qs_min={qmin}")
    finally:
        S._WINDOW_T, S._QS_MIN = saved_t, saved_q
    nxs.close()


if __name__ == "__main__":
    main()
