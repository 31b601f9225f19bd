"""Head-to-head vs the reference C engine (at the scaled tier).

Feeds BOTH engines the same synthetic Zipf corpus (ONE file, one
document per line, doc_id = line number) and the same query trace:

  - reference: the real C engine built by tools/refbuild/build_ref.sh,
    driven by the in-process ``multisearch`` driver (ingest mode +
    multi-query search mode) so neither side pays per-file reads or
    per-invocation index loads;
  - this repo: nxsearch_tpu with filters=["normalizer"], matching the
    reference build's effective pipeline (its libstemmer is an
    identity stub and it ships no stopword files).

Reports: index-build wall-clock ratio (BASELINE.md target: >= 5x),
BOTH engines' search throughput over the mixed trace (reference:
in-process sequential; repo: batched serving shape), and per-query
top-10 doc-id/score agreement (recall@10 parity).  Writes
PARITY_AB.md.

Usage: python tools/parity_ab.py [--docs N] [--queries N]
       [--ref-dir /tmp/refbuild/src] [--out PARITY_AB.md]
The 1M tier: --docs 1000000 --vocab 200000 --queries 512
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_corpus_file(path: str, docs: int, vocab: int, mean_len: int):
    """One document per line; doc_id = 1-based line number (matching
    bench.zipf_range's ids)."""
    import bench
    with open(path, "w") as f:
        for base in range(0, docs, bench._ZIPF_BLOCK):
            for _doc_id, text in bench.zipf_range(
                    base, min(base + bench._ZIPF_BLOCK, docs),
                    vocab, mean_len):
                f.write(text)
                f.write("\n")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--vocab", type=int, default=20_000)
    ap.add_argument("--mean-len", type=int, default=40)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--ref-dir", default="/tmp/refbuild/src")
    ap.add_argument("--out", default=None,
                    help="write PARITY_AB.md to this path")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    ref_test = os.path.join(args.ref_dir, "nxsearch_test")
    ref_multi = os.path.join(args.ref_dir, "multisearch")
    for b in (ref_test, ref_multi):
        if not os.path.exists(b):
            sys.exit(f"reference binary not found: {b} "
                     f"(run tools/refbuild/build_ref.sh first)")

    from nxsearch_tpu.utils.malloc import tune_host_allocator
    tune_host_allocator(
        prefault_mb=max(512, args.docs * args.mean_len * 12 * 2 >> 20))

    work = tempfile.mkdtemp(prefix="parity_ab_")
    corpus = os.path.join(work, "corpus.txt")
    ref_base = os.path.join(work, "ref_base")
    eng_base = os.path.join(work, "eng_base")
    os.makedirs(ref_base)
    os.makedirs(eng_base)

    print(f"[corpus] {args.docs} docs, vocab {args.vocab}", flush=True)
    build_corpus_file(corpus, args.docs, args.vocab, args.mean_len)

    def run_ref(binary, *a, timeout=None):
        env = dict(os.environ, NXS_BASEDIR=ref_base)
        return subprocess.run([binary, *a], env=env, check=True,
                              capture_output=True, text=True,
                              timeout=timeout).stdout

    # --- reference: create + in-process line ingest ---------------
    run_ref(ref_test, "-i", "bench", "-a")
    t0 = time.perf_counter()
    out = run_ref(ref_multi, ref_base, "bench", "--ingest", corpus)
    ref_index_wall_s = time.perf_counter() - t0
    m = re.search(r"ingest=([\d.]+) n=(\d+)", out)
    ref_index_ms = float(m.group(1))
    print(f"[ref] indexed {m.group(2)} docs in {ref_index_ms:.0f} ms "
          f"(wall {ref_index_wall_s:.1f}s)", flush=True)

    # --- this repo: same docs, normalizer-only pipeline ----------
    import bench as benchmod

    from nxsearch_tpu import Nxs, Params

    nxs = Nxs(eng_base)
    idx = nxs.index_create(
        "bench", Params().set_strlist("filters", ["normalizer"]))
    t0 = time.perf_counter()
    for base in range(0, args.docs, benchmod._ZIPF_BLOCK):
        idx.add_many(benchmod.zipf_range(
            base, min(base + benchmod._ZIPF_BLOCK, args.docs),
            args.vocab, args.mean_len))
    eng_index_s = time.perf_counter() - t0
    print(f"[engine] indexed in {eng_index_s * 1e3:.0f} ms", flush=True)

    # --- query trace ---------------------------------------------
    rng = np.random.default_rng(7)
    ranks = np.arange(args.vocab, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    words = np.array([f"w{i:05d}" for i in range(args.vocab)])
    queries = benchmod.make_mixed_queries(args.queries, words, probs, rng)
    qfile = os.path.join(work, "queries.txt")
    with open(qfile, "w") as f:
        f.write("\n".join(queries) + "\n")

    sp = Params().set_uint("limit", 10)
    n_agree = n_score = n_total = n_fuzzy_div = 0
    mismatches = []

    def has_fuzzy_term(q: str) -> bool:
        """True when any query term misses the dictionary and goes
        through fuzzy resolution.  Ranked parity is undefined there:
        the reference's 'most popular candidate' loop never updates
        its running max (idxterm.c:238-244, term_total stays 0), so
        its pick is BK-tree traversal-order-dependent; this repo
        implements the documented intent (true max total)."""
        toks = re.findall(r"[a-z0-9]+", q.lower())
        return any(t not in ("and", "or", "not")
                   and idx.host.term_lookup(t) is None for t in toks)

    # Reference side: ONE process, index loaded once, sequential
    # in-process queries (the library serving shape, search.c:285).
    out = run_ref(ref_multi, ref_base, "bench", qfile, "10",
                  timeout=3600)
    lines = [l for l in out.splitlines() if l.startswith("{")]
    m = re.search(r"load=([\d.]+) search_total=([\d.]+) n=(\d+)", out)
    ref_load_ms = float(m.group(1))
    ref_search_ms = float(m.group(2))
    assert int(m.group(3)) == len(queries) == len(lines)
    print(f"[ref] load {ref_load_ms:.0f} ms, {len(queries)} queries in "
          f"{ref_search_ms:.1f} ms "
          f"({len(queries) / max(ref_search_ms, 1e-9) * 1e3:.0f} QPS "
          f"in-process sequential)", flush=True)

    # Repo side: batched resolution (the serving shape).  Two passes:
    # the first absorbs per-signature compiles, the second is timed.
    idx.search_many(queries, sp)
    t0 = time.perf_counter()
    mine_all = idx.search_many(queries, sp)
    eng_search_s = time.perf_counter() - t0
    eng_qps = len(queries) / eng_search_s
    print(f"[engine] {len(queries)} queries in {eng_search_s * 1e3:.1f} ms "
          f"({eng_qps:.0f} QPS batched)", flush=True)

    for q, line, mine in zip(queries, lines, mine_all):
        payload = json.loads(line)
        ref_rows = [(r["doc_id"], r["score"])
                    for r in payload.get("results", [])][:10]
        my_rows = [(d, s) for d, s in mine][:10]
        n_total += 1
        ref_ids = {d for d, _ in ref_rows}
        my_ids = {d for d, _ in my_rows}
        scores_ok = False
        if ref_ids == my_ids:
            ref_s = {d: s for d, s in ref_rows}
            scores_ok = all(
                abs(s - ref_s[d]) <= 1e-3 * max(1.0, abs(s))
                for d, s in my_rows)
        elif ref_rows and my_rows:
            # k-th-place ties: engines order equal scores differently,
            # so the doc SETS differ while every disagreeing doc
            # scores within tolerance of the k-th score.  That is
            # rank-equivalent output, not a mismatch.
            kth = min(ref_rows[-1][1], my_rows[-1][1])
            tol = 1e-3 * max(1.0, abs(kth))
            only = ([s for d, s in ref_rows if d not in my_ids]
                    + [s for d, s in my_rows if d not in ref_ids])
            common = {d: s for d, s in ref_rows if d in my_ids}
            scores_ok = (all(abs(s - kth) <= tol for s in only)
                         and all(abs(s - common[d]) <= tol
                                 for d, s in my_rows if d in common))
        if scores_ok:
            n_agree += 1
            n_score += 1
        elif has_fuzzy_term(q):
            n_fuzzy_div += 1
        elif len(mismatches) < 5:
            mismatches.append((q, ref_rows, my_rows))

    print(f"[parity] top-10 set agreement {n_agree}/{n_total} "
          f"({n_fuzzy_div} fuzzy-pick divergences), "
          f"scores within 1e-3 on {n_score}", flush=True)
    for q, r, m_ in mismatches:
        print(f"  mismatch: {q!r}\n    ref {r[:4]}\n    eng {m_[:4]}")

    ratio = ref_index_ms / max(eng_index_s * 1e3, 1e-9)
    ref_qps = len(queries) / max(ref_search_ms, 1e-9) * 1e3
    report = f"""# Reference head-to-head (A/B)

Date: {time.strftime('%Y-%m-%d')}.  Reference binary: the real C
engine built offline by `tools/refbuild/build_ref.sh` (hand-written
parser shim for re2c/lemon, identity libstemmer, ICU 69-header/72-lib
retarget -- see that script's header for why), driven in-process by
`tools/refbuild/multisearch.c` (index loaded once; ingest from the
same one-doc-per-line corpus file both engines consume -- no per-file
or per-invocation overhead on either side).  Both engines ran the
same pipeline (normalize only), corpus and trace.

| metric | reference (C) | nxsearch_tpu | ratio |
|---|---|---|---|
| index build, {args.docs} docs x ~{args.mean_len} tokens | \
{ref_index_ms:.0f} ms | {eng_index_s * 1e3:.0f} ms | \
**{ratio:.1f}x** (target >= 5x) |
| search, {n_total} mixed queries | {ref_search_ms:.1f} ms \
({ref_qps:.0f} QPS, in-process sequential) | \
{eng_search_s * 1e3:.1f} ms ({eng_qps:.0f} QPS, batched) | \
**{eng_qps / max(ref_qps, 1e-9):.2f}x** |
| index load (open) | {ref_load_ms:.0f} ms | snapshot fast-open, \
see bench.py | - |

Parity over {n_total} mixed queries (ranked OR + boolean + fuzzy,
limit 10):

- top-10 agreement (doc sets equal, or differing only by ties at
  the 10th place, with every score within 1e-3 relative):
  **{n_agree}/{n_total}**
- fuzzy-pick divergences (expected, excluded from mismatches):
  {n_fuzzy_div}.  When a query term misses the dictionary, the
  reference's candidate-selection loop never updates its running
  maximum (`src/index/idxterm.c:238-244` -- `term_total` stays 0),
  so its pick is BK-tree traversal-order-dependent rather than the
  documented "most popular term"; this repo implements the
  documented intent (maximum total occurrence count), and the two
  can legitimately choose different replacement terms.
- remaining unexplained mismatches: {len(mismatches)}

Hardware note: the repo's engine ran on {_device_desc()}; the C
reference ran on this host's single CPU core.  Reproduce:
`sh tools/refbuild/build_ref.sh && python tools/parity_ab.py --docs
{args.docs} --vocab {args.vocab} --queries {args.queries}`.
"""
    out_path = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "PARITY_AB.md")
    with open(out_path, "w") as f:
        f.write(report)
    print(f"[report] {out_path}")

    nxs.close()
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)


def _device_desc() -> str:
    try:
        import jax
        d = jax.devices()[0]
        return f"{d.platform}:{d.device_kind}"
    except Exception:
        return "unknown device"


if __name__ == "__main__":
    main()
