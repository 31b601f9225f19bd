"""Device search execution: postings gather + ranking + top-k.

This is the device re-design of the reference's doc×term scoring
loop (src/query/search.c:210-271 iterates the result bitmap and, per
document, every query term's bitmap and per-document counts).  On the
device the same computation is expressed data-parallel over *postings*:

    1. The query's terms select CSR ranges of the postings arrays.
       All ranges are flattened into one fixed-budget gather plan
       (``flatten_ranges``) -- posting b maps to (query term q, source
       index src) by rank arithmetic, no data-dependent shapes.
    2. Every gathered posting (slot, tf) is scored elementwise with
       BM25 or TF-IDF (src/algo/ranking.c:41,99) -- pure elementwise math.
    3. Postings not surviving the boolean mask (AND/OR/AND-NOT, see
       ops/boolean.py) are zeroed.
    4. Scores are scatter-added into a dense per-document-slot score
       vector -- the analogue of nxs_resp_addresult's per-doc summing
       (src/core/results.c:128-137) -- and ``lax.top_k`` replaces the
       reference's capped min-heap (src/algo/heap.c).

Everything is static-shaped: the caller picks bucket sizes for the
postings budget B, the query width Q and k, so XLA compiles one kernel
per bucket signature, reused across queries.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

# BM25 constants (reference: src/algo/ranking.c:141-142).
BM25_K1 = 1.2
BM25_B = 0.75

ALGO_BM25 = 0
ALGO_TFIDF = 1


def flatten_ranges(q_start: jax.Array, q_len: jax.Array, budget: int):
    """Flatten Q variable-length CSR ranges into one fixed-size plan.

    Args:
      q_start: int32[Q] -- start offset of each query term's postings.
      q_len:   int32[Q] -- length of each range (0 for absent terms).
      budget:  static total budget B (must be >= sum(q_len)).

    Returns (src, qid, valid): for each flat position b, the postings
    source index, the owning query-term index, and whether b addresses
    a real posting.  Ranges are laid out back-to-back in term order.
    """
    q_len = q_len.astype(jnp.int32)
    cum = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(q_len)])  # i32[Q+1]
    total = cum[-1]
    b = jnp.arange(budget, dtype=jnp.int32)
    # side='right' skips zero-length ranges.
    qid = jnp.searchsorted(cum, b, side="right").astype(jnp.int32) - 1
    qid = jnp.clip(qid, 0, q_len.shape[0] - 1)
    src = q_start[qid] + (b - cum[qid])
    valid = b < total
    return src, qid, valid


def bm25(ltf, dl, idf, adl):
    """BM25 (ranking.c:99-174): tf'/(tf' + k*(1 - b + b*dl/adl)) * idf.

    All logarithms are precomputed on the host in f64 (XLA's f32 log is
    a fast approximation whose ~6e-5 error breaks exact score parity):
    ``ltf`` is log(tf+1) stored in the postings snapshot and ``idf`` is
    log((N - df + 0.5)/(df + 0.5) + 1) per query term.  ``adl`` must
    use the reference's *integer* division token_count // doc_count
    (ranking.c:160 divides unsigned longs).
    """
    return ltf / (ltf + BM25_K1 * (1.0 - BM25_B + BM25_B * dl / adl)) * idf


def tf_idf(ltf, idf):
    """TF-IDF (ranking.c:41-96): log(tf+1) * (log(N/df) + 1).

    ``idf`` = log(N/df) + 1, host-precomputed per query term.
    """
    return ltf * idf


def host_idf(algo: int, doc_count: int, df: int) -> float:
    """Per-term IDF in f64 on the host, matching the C arithmetic.

    TF-IDF: log((float)N / df) + 1 -- the N/df division is f32 in the
    reference (ranking.c:91 casts), mirrored here before the log.
    BM25:   log((N - df + 0.5)/(df + 0.5) + 1) in f64 (ranking.c:171).
    """
    if algo == ALGO_TFIDF:
        ratio = float(np.float32(doc_count) / np.float32(df))
        return math.log(ratio) + 1.0
    return math.log((doc_count - df + 0.5) / (df + 0.5) + 1.0)
