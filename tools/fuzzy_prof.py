"""Fuzzy sweep on the GPU: the Pallas/Triton kernel against the jnp path.

Part 1 times ``fuzzy_best_region`` at serving shapes -- region widths
of the 200k- and 1M-vocabulary bands (``w00000``-style terms, all
within one length band) and M queries per dispatch -- with the fused
kernel and with the vmapped jnp Myers sweep, in turns (kernel, jnp,
jnp, kernel), and checks that both pick the same terms.  ``--blocks``,
``--chunks``, ``--warps`` and ``--stages`` sweep the kernel's launch
parameters at the widest shape first.

Part 2 (``--docs`` > 0) builds chip_smoke.py's corpus and times the
fuzzy batch phase end to end (512 two-term typo queries through
``search_many``), once per route in turns, fresh typos every pass.

Usage: python tools/fuzzy_prof.py [--docs 1000000] [--blocks 128,256]
Prints the card's name and power limit beside every time; needs a GPU.
"""

import argparse
import functools
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def ints(s):
    return [int(x) for x in s.split(",") if x]


def region(n_terms: int, width: int):
    """Position-major and row-major vocab of w%05d terms, padded to
    ``width`` rows, with random totals and a permuted id column."""
    vb = np.zeros((width, 32), np.uint8)
    vl = np.zeros(width, np.int32)
    for i in range(n_terms):
        w = f"w{i:05d}".encode()
        vb[i, : len(w)] = np.frombuffer(w, np.uint8)
        vl[i] = len(w)
    rng = np.random.default_rng(1)
    totals = rng.integers(1, 1000, width).astype(np.uint32)
    ids = rng.permutation(width).astype(np.int32)
    return vb, vl, totals, ids


def typo_queries(m: int, n_terms: int, seed: int):
    rng = np.random.default_rng(seed)
    qb = np.zeros((m, 32), np.uint8)
    ql = np.zeros(m, np.int32)
    for i in range(m):
        t = b"x" + f"w{int(rng.integers(n_terms)):05d}".encode()[1:]
        qb[i, : len(t)] = np.frombuffer(t, np.uint8)
        ql[i] = len(t)
    return qb, ql


def time_call(fn, reps: int = 5) -> float:
    """Best of ``reps`` wall times of ``fn`` ending in device sync."""
    fn().block_until_ready()                     # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best


def micro(args, card: str) -> None:
    import jax
    import jax.numpy as jnp

    from nxsearch_tpu.ops.levenshtein import fuzzy_best_region
    from nxsearch_tpu.ops.pallas import fuzzy as F

    shapes = [(200_000, 1 << 18), (1_000_000, 1 << 20)]
    data = {}
    for n_terms, width in shapes:
        vb, vl, tt, ti = region(n_terms, width)
        data[width] = dict(
            row=jax.device_put(vb),
            pos=jax.device_put(np.ascontiguousarray(vb.T)),
            vl=jax.device_put(vl), tt=jax.device_put(tt),
            ti=jax.device_put(ti), n_terms=n_terms)

    def kernel_fn(d, qb, ql, width, **kw):
        return lambda: F.fuzzy_pick(d["pos"], d["vl"], d["tt"], d["ti"],
                                    qb, ql, tolerance=2, **kw)

    # Launch-parameter sweep at the widest shape, M = 64.
    width = shapes[-1][1]
    d = data[width]
    qb, ql = (jnp.asarray(x) for x in typo_queries(64, d["n_terms"], 0))
    best = None
    for blk in ints(args.blocks):
        for warps in ints(args.warps):
            for stages in ints(args.stages):
                for chunk in ints(args.chunks):
                    t = time_call(kernel_fn(
                        d, qb, ql, width, block=blk, chunk=chunk,
                        num_warps=warps, num_stages=stages))
                    print(f"sweep W={width} M=64 block={blk} "
                          f"chunk={chunk} warps={warps} stages={stages}: "
                          f"{t * 1e3:.3f} ms ({card})", flush=True)
                    if best is None or t < best[0]:
                        best = (t, blk, chunk, warps, stages)
    print(f"best launch: block={best[1]} chunk={best[2]} warps={best[3]} "
          f"stages={best[4]} (module defaults: block={F.BLOCK_TERMS} "
          f"chunk={F.QUERY_CHUNK} warps={F.NUM_WARPS} "
          f"stages={F.NUM_STAGES})", flush=True)

    for n_terms, width in shapes:
        d = data[width]
        for m in (8, 64):
            qb, ql = (jnp.asarray(x)
                      for x in typo_queries(m, n_terms, m))
            kern = functools.partial(
                fuzzy_best_region, d["pos"], d["vl"], d["tt"], d["ti"], qb,
                ql, jnp.int32(0), W=width, tolerance=2, kernel=True)
            plain = functools.partial(
                fuzzy_best_region, d["row"], d["vl"], d["tt"], d["ti"], qb,
                ql, jnp.int32(0), W=width, tolerance=2, kernel=False)
            same = np.array_equal(np.asarray(kern()), np.asarray(plain()))
            times = {"kernel": [], "jnp": []}
            for name in ("kernel", "jnp", "jnp", "kernel"):
                times[name].append(time_call(kern if name == "kernel"
                                             else plain))
            k, j = min(times["kernel"]), min(times["jnp"])
            print(f"fuzzy_best_region W={width} M={m}: kernel "
                  f"{k * 1e3:.3f} ms, jnp {j * 1e3:.3f} ms, "
                  f"jnp/kernel {j / k:.2f}x, picks equal: {same} "
                  f"({card})", flush=True)
            if not same:
                raise SystemExit("kernel and jnp picks differ")


def end_to_end(args, card: str) -> None:
    import chip_smoke
    import nxsearch_tpu.fuzzy as fuzzy_mod
    from nxsearch_tpu import Nxs, Params

    import bench

    words, probs = chip_smoke.vocabulary(args.vocab)
    rng = np.random.default_rng(7)
    p = Params().set_uint("limit", 10)
    with tempfile.TemporaryDirectory(prefix="nxs-fuzzy-") as basedir:
        chip_smoke.build(basedir, args, card)
        nxs = Nxs(basedir)
        idx = nxs.index_open("smoke")
        idx.prewarm(p)                 # the search side's shapes
        times = {"kernel": [], "jnp": []}
        real_platform = fuzzy_mod._platform
        salts = iter("abcdefghijklmnopqrstuv")
        for route in ("kernel", "jnp", "jnp", "kernel"):
            fuzzy_mod._platform = (real_platform if route == "kernel"
                                   else lambda: "jnp-route")
            idx._fuzzy = None          # fresh matcher: its own layout
            for i in range(4):         # pass 0 warms (compiles, upload)
                fq = bench.make_fuzzy_queries(
                    chip_smoke.N_FUZZY_BATCH, words, probs, rng,
                    next(salts))
                t0 = time.perf_counter()
                idx.search_many(fq, p)
                if i:
                    times[route].append(time.perf_counter() - t0)
            if idx._fuzzy_matcher()._kernel != (route == "kernel"):
                raise SystemExit(f"route {route} did not take effect")
        fuzzy_mod._platform = real_platform
        nxs.close()
    for route, ts in times.items():
        print(f"fuzzy batch x{chip_smoke.N_FUZZY_BATCH} end to end, "
              f"{route}: {' '.join(f'{t * 1e3:.1f}' for t in ts)} ms, "
              f"median {np.median(ts) * 1e3:.1f} ms ({card})", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", default="512")
    ap.add_argument("--warps", default="2")
    ap.add_argument("--stages", default="1")
    ap.add_argument("--chunks", default="8")
    ap.add_argument("--docs", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--mean-len", type=int, default=40)
    args = ap.parse_args()

    import chip_smoke

    card = chip_smoke.card_line()
    import jax

    chip_smoke.require_gpu(1)
    from nxsearch_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print(f"card: {card}; device: {jax.devices()[0].device_kind}",
          flush=True)
    micro(args, card)
    if args.docs:
        end_to_end(args, card)


if __name__ == "__main__":
    main()
