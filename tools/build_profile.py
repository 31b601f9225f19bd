"""Index-build phase profile.

The 1M-doc head-to-head (PARITY_AB v2) measured this repo's build at
4.0x the reference against a >= 5x target and attributed the
shortfall to unprofiled overheads.  This tool times the ingest loop's
phases separately by wrapping the internals the public add_many path
calls:

  gen       synthetic corpus text generation (bench.zipf_range) --
            note the reference side of the A/B reads a pre-written
            corpus FILE, so generation time inside the timed repo
            loop is pure A/B penalty, not engine cost
  tokenize  native batch tokenizer (C++ pipeline.process_batch)
  journal   host journal append (HostIndex.add_bulk_arrays: term
            staging, dtmap blocks, counters)

Usage: JAX_PLATFORMS=cpu python tools/build_profile.py [--docs N]
       [--vocab N] [--mean-len N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--mean-len", type=int, default=40)
    ap.add_argument("--pregen", action="store_true",
                    help="generate all texts up front (excluded from "
                         "the build wall time, like the reference's "
                         "corpus file read)")
    args = ap.parse_args()

    import bench as B
    B.enable_compile_cache(args.docs, args.mean_len)

    from nxsearch_tpu import Nxs, Params

    work = tempfile.mkdtemp(prefix="build_profile_")
    nxs = Nxs(work)
    idx = nxs.index_create(
        "p", Params().set_strlist("filters", ["normalizer"]))

    phases = {"gen": 0.0, "tokenize": 0.0, "journal": 0.0}

    native = idx.pipeline.native
    host = idx.host
    orig_batch = native.process_batch
    orig_bulk = host.add_bulk_arrays

    def timed_batch(texts):
        t0 = time.perf_counter()
        out = orig_batch(texts)
        phases["tokenize"] += time.perf_counter() - t0
        return out

    def timed_bulk(*a, **kw):
        t0 = time.perf_counter()
        out = orig_bulk(*a, **kw)
        phases["journal"] += time.perf_counter() - t0
        return out

    native.process_batch = timed_batch
    host.add_bulk_arrays = timed_bulk

    pre = None
    if args.pregen:
        t0 = time.perf_counter()
        pre = []
        for base in range(0, args.docs, B._ZIPF_BLOCK):
            pre.append(B.zipf_range(
                base, min(base + B._ZIPF_BLOCK, args.docs),
                args.vocab, args.mean_len))
        print(f"[pregen] {time.perf_counter() - t0:.1f}s", flush=True)

    t_build0 = time.perf_counter()
    for ci, base in enumerate(range(0, args.docs, B._ZIPF_BLOCK)):
        if pre is not None:
            docs = pre[ci]
        else:
            t0 = time.perf_counter()
            docs = B.zipf_range(
                base, min(base + B._ZIPF_BLOCK, args.docs),
                args.vocab, args.mean_len)
            phases["gen"] += time.perf_counter() - t0
        idx.add_many(docs)
    total = time.perf_counter() - t_build0
    other = total - sum(phases.values())

    t0 = time.perf_counter()
    idx.checkpoint()
    ckpt = time.perf_counter() - t0

    print(json.dumps({
        "docs": args.docs,
        "build_wall_s": round(total, 2),
        "docs_per_s": round(args.docs / total, 1),
        "phases_s": {k: round(v, 2) for k, v in phases.items()},
        "other_s": round(other, 2),
        "checkpoint_s": round(ckpt, 2),
        "pregen": bool(args.pregen),
    }))
    nxs.close()


if __name__ == "__main__":
    main()
