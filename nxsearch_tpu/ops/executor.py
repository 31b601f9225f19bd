"""Device search executables (src/query/search.c:210-283 equivalent).

Four strategies, picked by the router in search.py:

- **prefix** (pure-OR BM25, the default serving plan): impact-prefix
  pruned windows over the interleaved postings pack
  (``prefix_topk``).
- **sliced** (selective queries, masked queries, dense-row hybrids):
  contiguous per-term windows of the pack, one variadic sort and a
  shifted-pass segment sum (``sliced_topk``).
- **candidate** (what the two above decline): flatten the query
  terms' CSR ranges into one fixed-budget gather, score elementwise,
  sort by slot, segment-sum per document (the reference's per-doc
  score summing, results.c:128-137), evaluate boolean programs on
  per-candidate presence bits, lax.top_k (the capped min-heap of
  src/algo/heap.c).  O(candidate postings log).
- **dense** (>32-term boolean queries, or postings streams that rival
  the corpus size): packed per-term doc bitmaps + a dense per-slot
  score scatter.

Static bucket parameters define executable signatures; query content
(CSR ranges, IDF, the postfix boolean program) is runtime data, so all
queries in a bucket share one compiled kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .boolean import build_term_masks, eval_program, eval_program_bits
from .scoring import ALGO_BM25, bm25, flatten_ranges, tf_idf

# A host scalar: a jnp constant here would open the default device
# at import time (every spawned ingest worker would reserve GPU memory).
_SLOT_SENTINEL = np.int32(0x7FFFFFFF)


def candidate_topk(
    postings_slot: jax.Array,    # int32[P_pad], slot-sorted per term
    postings_ltf: jax.Array,     # float32[P_pad]: log(tf+1), host f64
    doc_len: jax.Array,          # float32[S_pad]
    alive_mask: jax.Array,       # uint32[S_pad/32]: packed live bitmap
    q_start: jax.Array,          # int32[Q]
    q_len: jax.Array,            # int32[Q]
    q_idf: jax.Array,            # float32[Q]: per-term IDF, host f64
    adl: jax.Array,              # float32 scalar
    prog_ops: jax.Array,         # int32[L] (NOP-padded)
    prog_args: jax.Array,
    *,
    budget: int,
    k: int,
    algo: int,
    use_mask: bool,
    depth: int = 8,
):
    """Core candidate-scoring pipeline shared by the single-device and
    per-shard executors.  Returns (scores f32[k'], slots i32[k']) with
    k' = min(k, budget); entries with score <= 0 are non-matches."""
    src, qid, valid = flatten_ranges(q_start, q_len, budget)
    real_slot = postings_slot[src]
    ltf = postings_ltf[src]
    idf = q_idf[qid]

    if algo == ALGO_BM25:
        score = bm25(ltf, doc_len[real_slot], idf, adl)
    else:
        score = tf_idf(ltf, idf)
    # Documents removed since the base snapshot are masked out via the
    # packed alive bitmap (incremental refresh; see index/device.py).
    alive = (alive_mask[real_slot >> 5]
             >> (real_slot & 31).astype(jnp.uint32)) & 1
    contrib = jnp.where(valid & alive.astype(bool), score, 0.0)
    bits = jnp.where(valid,
                     jnp.uint32(1) << jnp.minimum(qid, 31).astype(jnp.uint32),
                     jnp.uint32(0))

    # Sort by slot; padded entries carry a sentinel and sink to the end.
    sort_key = jnp.where(valid, real_slot, _SLOT_SENTINEL)
    order = jnp.argsort(sort_key)
    slot_s = sort_key[order]
    contrib_s = contrib[order]
    bits_s = bits[order]

    # Segment runs of equal slots: per-candidate score sum + presence.
    first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                             slot_s[1:] != slot_s[:-1]])
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    n = slot_s.shape[0]
    agg_score = jnp.zeros((n,), jnp.float32).at[seg].add(contrib_s)
    agg_slot = jnp.zeros((n,), jnp.int32).at[seg].max(slot_s)
    if use_mask:
        # Each (query term, doc) pair occurs once, so scatter-add of
        # distinct bits == OR.
        agg_bits = jnp.zeros((n,), jnp.uint32).at[seg].add(bits_s)
        keep = eval_program_bits(agg_bits, prog_ops, prog_args, depth=depth)
        agg_score = jnp.where(keep, agg_score, 0.0)

    k_eff = min(k, n)
    top_scores, idx = lax.top_k(agg_score, k_eff)
    return top_scores, agg_slot[idx]


def alive_factors(alive_mask: jax.Array) -> jax.Array:
    """Packed u32 alive bitmap -> per-slot 0/1 f32 factors."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return (((alive_mask[:, None] >> shifts[None, :]) & 1)
            .astype(jnp.float32).reshape(-1))


def _sliced_fetch(postings_pack, q_start, *, T: int):
    """Per-(query, term) contiguous windows of the interleaved
    (slot, ltf, dl) postings rows: [N, Qs] starts -> [N, Qs, T, 3].

    Contiguity is the whole point: each window is ONE sequential
    device-memory read (lowered as a gather with slice_sizes=(T, 3))
    instead of the random per-posting gathers of the sort-based
    candidate path.  Guard rows in the pack (index/device.py) guarantee the
    slice start is never clamped.
    """
    def one(s):
        return lax.dynamic_slice(postings_pack, (s, 0), (T, 3))
    return jax.vmap(jax.vmap(one))(q_start)


def sliced_topk(
    postings_pack,   # f32[P_pad + guard, 3]: (slot, ltf, dl) rows
    alive_mask,      # uint32[S_pad/32]
    doc_len,         # f32[S_pad] (hybrid dense-row scoring only)
    q_start,         # int32[N, Qs]: CSR starts of the sliced terms
    q_len,           # int32[N, Qs]
    q_idf,           # float32[N, Qs]
    adl,             # f32 scalar
    prog_ops,        # int32[N, L]
    prog_args,       # int32[N, L]
    dense_rows=None,  # f32[H, S_pad]: heavy-term ltf rows
    d_row=None,       # int32[N, D]: dense_rows row index, -1 pad
    d_idf=None,       # float32[N, D]: idf of each dense term
    h_start=None,     # int32[N]: head term CSR start (T_head > 0)
    h_len=None,       # int32[N]
    h_idf=None,       # float32[N]
    h_row=None,       # int32[N]: head token row (mask bit position)
    h_pass=None,      # bool[N]: program({head}) -- head-only docs pass
    sl_rows=None,     # int32[N, Qs]: token row per column (windowed
                      # plans split one term over several columns)
    d_bit=None,       # int32[N, D]: dense term's token row / bit pos
                      # (masked hybrid only; -1 pad)
    d_pass=None,      # bool[N, 2**D]: program verdict for every
                      # dense-only presence pattern (masked hybrid)
    *, T: int, k: int, algo: int, n_slots: int, use_mask: bool,
    single: bool, alive_all: bool, use_rows: bool, depth: int = 8,
    T_head: int = 0, n_run: int = 0,
):
    """Sliced exact top-k: contiguous per-term fetch, one variadic
    sort, segmented-scan aggregation.  The accelerator fast path for
    selective queries (and, with ``use_rows``, the pure-OR hybrid for
    queries that include dense-row head terms).

    Exactness notes:
    - Per-document sums use a segmented associative scan, so f32
      addition happens only *within* a document's run -- matching the
      scatter-add executors (a global prefix-sum difference trick
      loses ~4e-4 to cancellation).
    - Presence bits aggregate by summation, which equals OR because a
      (term, slot) pair occurs at most once in the CSR.
    - The hybrid's merge is a scatter-max: a candidate document's
      total (all its matching terms, dense included) dominates its
      dense-row partial sum because contributions are non-negative,
      and documents matched ONLY by dense-row terms are exact in the
      dense sweep.  NOT/AND semantics cannot be evaluated on partial
      bits, so masked queries with dense terms take the masked
      hybrid below (presence bits gathered from the dense rows plus a
      host-evaluated verdict table for dense-only documents) or the
      candidate executor.

    With ``T_head > 0`` the query's single heaviest term (the "head")
    is kept OUT of the sort plane: its contributions merge into the
    tail candidates by a batched binary search (both sides are
    slot-sorted), and documents matched only by the head go through a
    plain ``top_k`` over its slice instead of the sort, which is where
    high-df query terms would otherwise spend their time (whether
    that pays on a given device is unmeasured; the router keeps it
    off by default, search.py _HEAD_MIN_DF).  Masked queries stay exact: the
    head's presence bit joins the candidate bits before program
    evaluation, and ``h_pass`` (the program evaluated host-side on the
    head-only bit pattern) decides whether head-only documents can
    appear at all.

    Returns packed f32[N, 2, k']: scores and slot indexes by value
    (exact: the router gates on n_slots < 2**24).
    """
    assert not (use_rows and use_mask) or d_pass is not None, \
        "masked dense-row hybrid requires the d_bit/d_pass inputs"
    assert not (use_rows and T_head), \
        "dense-row and head-term hybrids are mutually exclusive (router)"
    n_batch, n_terms = q_start.shape
    # Windowed plans split a wide term over ceil(df/T) columns, so the
    # sort plane holds ~df lanes instead of a power-of-8 tier pad.  A
    # document still occurs at most once per LOGICAL term (windows
    # partition a term's postings), so ``n_run`` -- the logical term
    # count -- bounds run lengths in the sorted plane, and the shifted
    # aggregation passes stay O(logical terms), not O(columns).
    n_logical = n_run if n_run > 0 else n_terms
    win = _sliced_fetch(postings_pack, q_start, T=T)   # [N, Qs, T, 3]
    slot_f = win[..., 0]
    ltf = win[..., 1]
    dl = win[..., 2]
    pos = jnp.arange(T, dtype=jnp.int32)[None, None, :]
    valid = pos < q_len[:, :, None]
    idf = q_idf[:, :, None]
    if algo == ALGO_BM25:
        contrib = bm25(ltf, dl, idf, adl)
    else:
        contrib = tf_idf(ltf, idf)
    if not alive_all:
        slot_i = slot_f.astype(jnp.int32)
        word = jnp.minimum(slot_i >> 5, alive_mask.shape[0] - 1)
        alive = ((alive_mask[word] >> (slot_i & 31).astype(jnp.uint32)) & 1
                 ).astype(jnp.bool_)
        valid_score = valid & alive
    else:
        valid_score = valid
    contrib = jnp.where(valid_score, contrib, 0.0)

    dsum = None
    d_rows_cache = []
    if use_rows:
        # Dense-row sweep: per-slot exact sums of the heavy terms'
        # contributions -- pure elementwise over [N, S] (rows are ltf
        # by device slot; doc_len is slot-indexed too).
        from .scoring import BM25_B, BM25_K1
        c1 = jnp.float32(BM25_K1 * (1.0 - BM25_B))
        c2 = (jnp.float32(BM25_K1 * BM25_B)
              / jnp.maximum(adl, 1e-9)).astype(jnp.float32)
        dsum = jnp.zeros((n_batch, n_slots), jnp.float32)
        for j in range(d_row.shape[1]):
            row = jnp.take(dense_rows, jnp.maximum(d_row[:, j], 0),
                           axis=0)                      # [N, S]
            if use_mask:
                d_rows_cache.append(row)
            if algo == ALGO_BM25:
                part = row / (row + c1 + c2 * doc_len[None, :])
            else:
                part = row
            part = part * d_idf[:, j: j + 1]
            dsum = dsum + jnp.where((d_row[:, j] >= 0)[:, None], part, 0.0)
        if not alive_all:
            dsum = dsum * alive_factors(alive_mask)[None, :]

    if single and not use_mask and not use_rows:
        c = contrib[:, 0, :]
        scores, ix = lax.top_k(c, min(k, T))
        slots = jnp.take_along_axis(slot_f[:, 0, :], ix, axis=1)
        slots = jnp.where(scores > 0.0, slots, 0.0)
        return jnp.stack([scores, slots], axis=1)

    # Head-term slice: one contiguous window per query, scored
    # elementwise; invalid tail positions key to +inf so the plane
    # stays ascending for the binary-search merge below.
    if T_head > 0:
        hwin = _sliced_fetch(postings_pack, h_start[:, None],
                             T=T_head)[:, 0]          # [N, T_h, 3]
        h_valid = (jnp.arange(T_head, dtype=jnp.int32)[None, :]
                   < h_len[:, None])
        if algo == ALGO_BM25:
            hc = bm25(hwin[..., 1], hwin[..., 2],
                      h_idf[:, None], adl)
        else:
            hc = tf_idf(hwin[..., 1], h_idf[:, None])
        h_key = jnp.where(h_valid, hwin[..., 0], jnp.float32(jnp.inf))
        if not alive_all:
            h_slot_i = h_key.astype(jnp.int32)
            h_slot_i = jnp.where(h_valid, h_slot_i, 0)
            word = jnp.minimum(h_slot_i >> 5, alive_mask.shape[0] - 1)
            h_alive = ((alive_mask[word]
                        >> (h_slot_i & 31).astype(jnp.uint32)) & 1
                       ).astype(jnp.bool_)
            hc = jnp.where(h_valid & h_alive, hc, 0.0)
        else:
            hc = jnp.where(h_valid, hc, 0.0)

    flat = n_terms * T
    key = jnp.where(valid, slot_f, jnp.float32(jnp.inf)).reshape(
        n_batch, flat)
    contrib_f = contrib.reshape(n_batch, flat)
    if use_mask:
        if sl_rows is not None:
            # Windowed plans carry each column's token row explicitly.
            rows = sl_rows
        else:
            # Presence-bit position of CSR column c is its token row:
            # the columns preserve token order, with the head's row
            # (if any) skipped -- columns at or past it shift up by one.
            rows = jnp.arange(n_terms, dtype=jnp.int32)[None, :]
            if T_head > 0:
                rows = rows + (rows >= h_row[:, None]).astype(jnp.int32)
        bit = (jnp.uint32(1) << jnp.minimum(rows, 31).astype(jnp.uint32)
               )[:, :, None]
        bits = jnp.where(valid, bit, jnp.uint32(0)).reshape(n_batch, flat)
        if use_rows:
            # Masked hybrid: a candidate's presence bits must include
            # the dense-handled terms -- gather each dense row at the
            # candidate lanes' slots (non-zero ltf == present).
            slot_l = jnp.clip(slot_f.astype(jnp.int32), 0, n_slots - 1
                              ).reshape(n_batch, flat)
            valid_f = valid.reshape(n_batch, flat)
            for j in range(d_row.shape[1]):
                at = jnp.take_along_axis(d_rows_cache[j], slot_l, axis=1)
                dbit = (jnp.uint32(1) << jnp.minimum(
                    jnp.maximum(d_bit[:, j], 0), 31).astype(jnp.uint32))
                on = (valid_f & (at > 0.0)
                      & (d_row[:, j] >= 0)[:, None])
                bits = bits | jnp.where(on, dbit[:, None], jnp.uint32(0))
    else:
        bits = None
    if n_logical == 1:
        # One CSR term: its slice is already slot-ascending (CSR
        # postings are slot-sorted; invalid tail lanes keyed +inf) --
        # no sort, and each document occurs exactly once.
        key_s, contrib_s, bits_s = key, contrib_f, bits
    elif use_mask:
        key_s, contrib_s, bits_s = lax.sort(
            (key, contrib_f, bits), dimension=1, num_keys=1)
    else:
        key_s, contrib_s = lax.sort(
            (key, contrib_f), dimension=1, num_keys=1)
        bits_s = None

    diff = key_s[:, 1:] != key_s[:, :-1]
    ones = jnp.ones((n_batch, 1), jnp.bool_)
    last = jnp.concatenate([diff, ones], axis=1)

    # Within-segment aggregation by shifted passes: a document's run
    # in the sorted plane is at most n_terms long (each term holds one
    # posting per doc), so summing neighbors at offsets 1..n_terms-1
    # whose key matches is an exact segment sum -- pure contiguous
    # shift/compare/add, no scans, no strided relayouts.  (An
    # associative_scan formulation compiled to stride-2 recursions
    # that were pathologically slow to build at large widths.)
    run = contrib_s
    run_bits = bits_s
    zf = jnp.zeros((n_batch, 1), jnp.float32)
    zb = jnp.zeros((n_batch, 1), jnp.uint32) if use_mask else None
    zk = jnp.full((n_batch, 1), jnp.float32(-jnp.inf))
    for off in range(1, n_logical):
        if off >= flat:
            break
        key_prev = jnp.concatenate(
            [jnp.broadcast_to(zk, (n_batch, off)), key_s[:, :-off]], axis=1)
        eq = key_prev == key_s
        c_prev = jnp.concatenate(
            [jnp.broadcast_to(zf, (n_batch, off)), contrib_s[:, :-off]],
            axis=1)
        run = run + jnp.where(eq, c_prev, 0.0)
        if use_mask:
            b_prev = jnp.concatenate(
                [jnp.broadcast_to(zb, (n_batch, off)), bits_s[:, :-off]],
                axis=1)
            run_bits = run_bits | jnp.where(eq, b_prev, jnp.uint32(0))

    # Head merge: batched binary search of the candidate slots into the
    # (sorted) head slice -- matched candidates absorb the head's
    # contribution (and its presence bit) before program evaluation.
    h_add = None
    if T_head > 0:
        find = jax.vmap(
            lambda a, v: jnp.searchsorted(a, v, side="left"))(h_key, key_s)
        find_c = jnp.minimum(find, T_head - 1)
        matched = (jnp.take_along_axis(h_key, find_c, axis=1) == key_s) \
            & jnp.isfinite(key_s)
        h_add = jnp.where(matched,
                          jnp.take_along_axis(hc, find_c, axis=1), 0.0)
        if use_mask:
            hbit = (jnp.uint32(1)
                    << jnp.minimum(h_row, 31).astype(jnp.uint32))
            run_bits = run_bits | jnp.where(matched, hbit[:, None],
                                            jnp.uint32(0))
    if use_mask:
        keep = jax.vmap(
            lambda b, po, pa: eval_program_bits(b, po, pa, depth=depth)
        )(run_bits, prog_ops, prog_args)
    else:
        keep = True

    is_doc = last & jnp.isfinite(key_s)
    total = run if h_add is None else run + h_add
    segsum = jnp.where(is_doc & keep, total, 0.0)

    if use_rows:
        # Candidate totals must include the dense terms' contributions
        # for their documents; then the dense sweep merges per slot and
        # the top-k runs over the merged [N, S] plane.
        slot_idx = jnp.where(is_doc, key_s, jnp.float32(n_slots)
                             ).astype(jnp.int32)
        dense_at = jnp.take_along_axis(
            dsum, jnp.minimum(slot_idx, n_slots - 1), axis=1)
        n_ix = jnp.arange(n_batch)[:, None]
        if use_mask:
            # Masked hybrid: documents with NO candidate (CSR) term are
            # gated by the host-evaluated program verdict over their
            # dense-only presence pattern (D <= 4 -> 2**D-entry table);
            # candidate documents OVERRIDE their slot with the full,
            # keep-gated total (0 when the program fails -- covered
            # slots must not fall back to the dense-only score).
            pattern = jnp.zeros((n_batch, n_slots), jnp.int32)
            for j in range(d_row.shape[1]):
                on = ((d_rows_cache[j] > 0.0)
                      & (d_row[:, j] >= 0)[:, None])
                pattern = pattern | jnp.where(on, 1 << j, 0)
            verdict = jnp.take_along_axis(
                d_pass.astype(jnp.float32), pattern, axis=1)
            base = dsum * verdict
            cand_val = jnp.where(is_doc & keep, segsum + dense_at, 0.0)
            merged = base.at[n_ix, slot_idx].set(cand_val, mode="drop")
        else:
            # Pure-OR: scatter-max is exact because contributions are
            # non-negative (a candidate total dominates its dense-only
            # partial sum).
            cand_final = jnp.where(segsum > 0.0, segsum + dense_at, 0.0)
            merged = dsum.at[n_ix, slot_idx].max(cand_final, mode="drop")
        scores, slots_i = lax.top_k(merged, min(k, n_slots))
        slots = jnp.where(scores > 0.0, slots_i.astype(jnp.float32), 0.0)
        return jnp.stack([scores, slots], axis=1)

    if T_head > 0:
        # Head-only documents: drop head postings a tail candidate
        # consumed (their doc's full total lives on the candidate
        # side), gate the rest on the host-evaluated head-only program
        # verdict, then top-k over both planes at once.
        drop_ix = jnp.where(is_doc & matched, find_c, T_head)
        hplane = hc.at[jnp.arange(n_batch)[:, None], drop_ix].set(
            0.0, mode="drop")
        if use_mask:
            hplane = jnp.where(h_pass[:, None], hplane, 0.0)
        scores_all = jnp.concatenate([segsum, hplane], axis=1)
        slots_all = jnp.concatenate([key_s, h_key], axis=1)
        scores, ix = lax.top_k(scores_all, min(k, flat + T_head))
        slots = jnp.take_along_axis(slots_all, ix, axis=1)
        slots = jnp.where(scores > 0.0, slots, 0.0)
        return jnp.stack([scores, slots], axis=1)

    scores, ix = lax.top_k(segsum, min(k, flat))
    slots = jnp.take_along_axis(key_s, ix, axis=1)
    slots = jnp.where(scores > 0.0, slots, 0.0)
    return jnp.stack([scores, slots], axis=1)


device_search_sliced_batch = functools.partial(
    jax.jit,
    static_argnames=("T", "k", "algo", "n_slots", "use_mask", "single",
                     "alive_all", "use_rows", "depth", "T_head", "n_run"),
)(sliced_topk)


def prefix_topk(
    postings_pack,   # f32[P_pad + prefix + guard, 3]: (slot, ltf, dl)
    alive_mask,      # uint32[S_pad/32]
    q_start,         # int32[N, Qs]: window starts (wide terms point at
                     # their impact-prefix region)
    q_len,           # int32[N, Qs]
    q_idf,           # float32[N, Qs]
    adl,             # f32 scalar
    col_bit,         # int32[N, Qs]: 1 << j for windows of wide term j,
                     # 0 for complete terms' windows
    w_tail,          # float32[N, R]: idf * tail impact bound per wide
                     # term (0 on padding rows)
    w_start,         # int32[N, R]: FULL CSR start of each wide term
    w_len,           # int32[N, R]: FULL base df (0 on padding rows)
    w_idf,           # float32[N, R]
    *, T: int, k: int, M: int, algo: int, n_slots: int,
    alive_all: bool, n_run: int, k_ret: int = 0,
):
    """Impact-prefix pruned exact top-k (pure-OR BM25).

    The device MaxScore analogue (reference efficiency anchor: the
    matching-docs-only scoring loop, src/query/search.c:236-271).  Wide
    terms (base df > DeviceIndex.PREFIX_CAP) contribute only their
    top-CAP postings by impact, so the sort plane is bounded by
    CAP * terms lanes; every document's score is then either exact or
    under-counted by at most the sum of the missed wide terms' tail
    bounds:

      1. The windowed plane (same fetch/sort/shifted-segsum machinery
         as sliced_topk) yields per candidate the partial score s_d
         and presence bits over the query's wide terms.
      2. u_d = s_d + sum of absent wide terms' tails upper-bounds the
         true score; the top-M candidates by u are RESCORED exactly: a
         per-(candidate, wide term) binary search over the term's full
         slot-sorted CSR postings recovers any truncated contribution.
      3. The result is certified exact when the k-th rescored score
         strictly dominates both the best unselected candidate's bound
         and the all-tails bound of documents outside the plane
         (ulp-inflated, mirroring the block-max certification).  A
         zero total tail is exact by construction (the plane was
         complete).  Uncertified queries re-run on the classic path.

    Ties match the classic executors: candidate selection and the
    final top-k both resolve equal scores toward the lowest device
    slot (the plane is slot-sorted; selected candidates re-sort by
    slot before the final top_k).

    Returns packed f32[N, 3, k']: scores, slots (by value), exact flag.

    ``R == 0`` (no wide terms in the group) is the complete-plane fast
    path: every term's windows cover its full CSR range, so the result
    is exact by construction -- presence bits leave the sort (two
    operands instead of three) and the bound/rescore/certification
    epilogue is skipped entirely.  On the damped-Zipf serving mix
    ~90% of rows have no wide term, so this is the dominant signature.
    """
    assert algo == ALGO_BM25, "impact prefixes are built for BM25"
    n_batch, n_terms = q_start.shape
    R = w_tail.shape[1]
    n_logical = n_run if n_run > 0 else n_terms

    win = _sliced_fetch(postings_pack, q_start, T=T)   # [N, Qs, T, 3]
    slot_f = win[..., 0]
    pos = jnp.arange(T, dtype=jnp.int32)[None, None, :]
    valid = pos < q_len[:, :, None]
    contrib = bm25(win[..., 1], win[..., 2], q_idf[:, :, None], adl)
    if not alive_all:
        slot_i = slot_f.astype(jnp.int32)
        word = jnp.minimum(slot_i >> 5, alive_mask.shape[0] - 1)
        alive = ((alive_mask[word]
                  >> (slot_i & 31).astype(jnp.uint32)) & 1
                 ).astype(jnp.bool_)
        contrib = jnp.where(valid & alive, contrib, 0.0)
    else:
        contrib = jnp.where(valid, contrib, 0.0)

    flat = n_terms * T
    key = jnp.where(valid, slot_f, jnp.float32(jnp.inf)).reshape(
        n_batch, flat)
    contrib_f = contrib.reshape(n_batch, flat)
    use_bits = R > 0
    if use_bits:
        bits = jnp.where(valid, col_bit[:, :, None].astype(jnp.uint32),
                         jnp.uint32(0))
        bits_f = bits.reshape(n_batch, flat)
    if n_logical == 1:
        # One logical term: windows partition slot-sorted postings, so
        # the concatenated lanes are already ascending and each doc
        # occurs once.
        key_s, contrib_s = key, contrib_f
        bits_s = bits_f if use_bits else None
    elif use_bits:
        key_s, contrib_s, bits_s = lax.sort(
            (key, contrib_f, bits_f), dimension=1, num_keys=1)
    else:
        key_s, contrib_s = lax.sort(
            (key, contrib_f), dimension=1, num_keys=1)
        bits_s = None

    diff = key_s[:, 1:] != key_s[:, :-1]
    ones = jnp.ones((n_batch, 1), jnp.bool_)
    last = jnp.concatenate([diff, ones], axis=1)
    run = contrib_s
    run_bits = bits_s
    zf = jnp.zeros((n_batch, 1), jnp.float32)
    zb = jnp.zeros((n_batch, 1), jnp.uint32)
    zk = jnp.full((n_batch, 1), jnp.float32(-jnp.inf))
    for off in range(1, n_logical):
        if off >= flat:
            break
        key_prev = jnp.concatenate(
            [jnp.broadcast_to(zk, (n_batch, off)), key_s[:, :-off]],
            axis=1)
        eq = key_prev == key_s
        c_prev = jnp.concatenate(
            [jnp.broadcast_to(zf, (n_batch, off)), contrib_s[:, :-off]],
            axis=1)
        run = run + jnp.where(eq, c_prev, 0.0)
        if use_bits:
            b_prev = jnp.concatenate(
                [jnp.broadcast_to(zb, (n_batch, off)), bits_s[:, :-off]],
                axis=1)
            run_bits = run_bits | jnp.where(eq, b_prev, jnp.uint32(0))

    is_doc = last & jnp.isfinite(key_s)
    if not use_bits:
        # Complete plane: exact by construction -- straight top-k over
        # the aggregated per-document sums, no candidate selection.
        segsum = jnp.where(is_doc, run, 0.0)
        k_eff = min(k, flat)
        scores, ix = lax.top_k(segsum, k_eff)
        slots = jnp.take_along_axis(key_s, ix, axis=1)
        slots = jnp.where(scores > 0.0, slots, 0.0)
        exact1 = jnp.ones((n_batch, 1), jnp.float32)
        assert n_slots < (1 << 24), \
            "slot indexes must stay exact in f32"
        return jnp.stack(
            [scores, slots,
             jnp.broadcast_to(exact1, scores.shape)], axis=1)
    total_tail = w_tail.sum(axis=1)                       # [N]
    have = jnp.zeros((n_batch, flat), jnp.float32)
    for j in range(R):
        bit_j = ((run_bits >> jnp.uint32(j)) & 1).astype(jnp.float32)
        have = have + w_tail[:, j: j + 1] * bit_j
    u = run + (total_tail[:, None] - have)
    u_lane = jnp.where(is_doc, u, -jnp.inf)

    m1 = min(M + 1, flat)
    m_sel = min(M, flat)
    topu, ix = lax.top_k(u_lane, m1)
    u_out = topu[:, m_sel] if m1 > m_sel \
        else jnp.full((n_batch,), -jnp.inf)
    sel = ix[:, :m_sel]
    cand_slot = jnp.take_along_axis(key_s, sel, axis=1)   # f32
    cand_s = jnp.take_along_axis(
        jnp.where(is_doc, run, 0.0), sel, axis=1)
    cand_bits = jnp.take_along_axis(run_bits, sel, axis=1)
    cand_ok = jnp.isfinite(jnp.take_along_axis(u_lane, sel, axis=1))

    # Exact rescore: binary search each candidate in every absent wide
    # term's full slot-sorted postings.  iters covers the largest df.
    pack0 = postings_pack[:, 0]
    pack_last = postings_pack.shape[0] - 1
    iters = max(int(n_slots).bit_length(), 1)
    s_ex = cand_s
    for j in range(R):
        lo = jnp.broadcast_to(w_start[:, j: j + 1],
                              (n_batch, m_sel)).astype(jnp.int32)
        hi0 = w_start[:, j: j + 1] + w_len[:, j: j + 1]
        hi = jnp.broadcast_to(hi0, (n_batch, m_sel)).astype(jnp.int32)
        target = cand_slot
        for _ in range(iters):
            mid = (lo + hi) >> 1
            v = jnp.take(pack0, jnp.minimum(mid, pack_last))
            go_right = v < target
            lo = jnp.where(go_right, mid + 1, lo)
            hi = jnp.where(go_right, hi, mid)
        lo_c = jnp.minimum(lo, pack_last)
        found = ((jnp.take(pack0, lo_c) == target)
                 & (lo < hi0) & (w_len[:, j: j + 1] > 0))
        c = bm25(jnp.take(postings_pack[:, 1], lo_c),
                 jnp.take(postings_pack[:, 2], lo_c),
                 w_idf[:, j: j + 1], adl)
        absent = ((cand_bits >> jnp.uint32(j)) & 1) == 0
        s_ex = s_ex + jnp.where(found & absent & cand_ok, c, 0.0)

    if not alive_all:
        # A dead document's plane lanes contribute 0, but rescored
        # contributions must not resurrect it.
        cslot_i = jnp.where(cand_ok, cand_slot, 0.0).astype(jnp.int32)
        word = jnp.minimum(cslot_i >> 5, alive_mask.shape[0] - 1)
        alive_c = ((alive_mask[word]
                    >> (cslot_i & 31).astype(jnp.uint32)) & 1
                   ).astype(jnp.float32)
        s_ex = s_ex * alive_c
    s_ex = jnp.where(cand_ok, s_ex, 0.0)

    # Final order: sort the M candidates by slot so top_k breaks score
    # ties toward the lowest device slot, like the classic executors
    # over their slot-sorted planes.
    sort_slot = jnp.where(cand_ok, cand_slot, jnp.float32(jnp.inf))
    slot_sorted, s_sorted = lax.sort((sort_slot, s_ex), dimension=1,
                                     num_keys=1)
    k_eff = min(k, m_sel)
    scores, ixf = lax.top_k(s_sorted, k_eff)
    slots = jnp.take_along_axis(slot_sorted, ixf, axis=1)
    slots = jnp.where(scores > 0.0, slots, 0.0)

    # Certification (ulp-inflated bounds): the k-th exact score must
    # strictly dominate both the
    # best unselected candidate's upper bound and the all-tails bound
    # of documents with no plane lane.  total_tail == 0 means the
    # plane was complete: exact by construction.
    # Certify at the REQUESTED result depth (k_ret <= the padded k
    # bucket): only the returned rows must be provably complete.
    kth = scores[:, min(k_ret or k_eff, k_eff) - 1]
    inflate = (lambda x: jnp.where(
        x > 0.0, x * jnp.float32(1.0 + 1e-5) + jnp.float32(1e-10), x))
    exact = ((total_tail == 0.0)
             | ((kth > inflate(u_out)) & (kth > inflate(total_tail)))
             ).astype(jnp.float32)
    assert n_slots < (1 << 24), "slot indexes must stay exact in f32"
    return jnp.stack(
        [scores, slots,
         jnp.broadcast_to(exact[:, None], scores.shape)], axis=1)


def prefix_topk_packed(
    postings_pack, alive_mask,
    buf,              # int32[n * (4*qs + 4*R)]: packed host inputs
    adl,
    *, qs: int, R: int, T: int, k: int, M: int, algo: int,
    n_slots: int, alive_all: bool, n_run: int, k_ret: int = 0,
):
    """One-buffer front end for prefix_topk (one host->device transfer
    per dispatch group; see sliced_topk_packed).  Layout (row-major
    [n, ...] per field): sl_start[n,qs] sl_len[n,qs] sl_idf[n,qs]
    col_bit[n,qs] w_tail[n,R] w_start[n,R] w_len[n,R] w_idf[n,R]."""
    per = 4 * qs + 4 * R
    n = buf.shape[0] // per
    off = 0

    def take_i32(m, shape):
        nonlocal off
        seg = lax.slice_in_dim(buf, off, off + m * n).reshape((n,) + shape)
        off += m * n
        return seg

    def take_f32(m, shape):
        return lax.bitcast_convert_type(take_i32(m, shape), jnp.float32)

    q_start = take_i32(qs, (qs,))
    q_len = take_i32(qs, (qs,))
    q_idf = take_f32(qs, (qs,))
    col_bit = take_i32(qs, (qs,))
    if R > 0:
        w_tail = take_f32(R, (R,))
        w_start = take_i32(R, (R,))
        w_len = take_i32(R, (R,))
        w_idf = take_f32(R, (R,))
    else:
        w_tail = jnp.zeros((n, 0), jnp.float32)
        w_start = jnp.zeros((n, 0), jnp.int32)
        w_len = jnp.zeros((n, 0), jnp.int32)
        w_idf = jnp.zeros((n, 0), jnp.float32)
    return prefix_topk(
        postings_pack, alive_mask, q_start, q_len, q_idf, adl,
        col_bit, w_tail, w_start, w_len, w_idf,
        T=T, k=k, M=M, algo=algo, n_slots=n_slots,
        alive_all=alive_all, n_run=n_run, k_ret=k_ret)


device_search_prefix_packed = functools.partial(
    jax.jit,
    static_argnames=("qs", "R", "T", "k", "M", "algo", "n_slots",
                     "alive_all", "n_run", "k_ret"),
)(prefix_topk_packed)


def pack_prefix_group(sl_start, sl_len, sl_idf, col_bit, w_tail,
                      w_start, w_len, w_idf):
    """Host-side packer matching prefix_topk_packed's layout."""
    import numpy as np

    def i32(p):
        p = np.ascontiguousarray(p)
        if p.dtype == np.float32:
            return p.view(np.int32).ravel()
        return p.astype(np.int32, copy=False).ravel()

    return np.concatenate([i32(p) for p in (
        sl_start, sl_len, sl_idf, col_bit, w_tail, w_start, w_len,
        w_idf)])


def unpack_prefix(packed):
    """Packed [N, 3, k] prefix result -> (scores f32[N, k],
    slots i32[N, k], exact bool[N]) numpy arrays."""
    import numpy as np

    arr = np.asarray(packed)
    return (arr[:, 0, :], arr[:, 1, :].astype(np.int32),
            arr[:, 2, 0] > 0.5)


def sliced_topk_packed(
    postings_pack, alive_mask, doc_len,
    buf,              # int32[n * per_row]: all per-group host inputs
    adl,              # f32[] (device-resident scalar)
    dense_rows=None,  # f32[H, S_pad] (use_rows only)
    *, qs: int, L: int, D: int, T: int, k: int, algo: int, n_slots: int,
    use_mask: bool, single: bool, alive_all: bool, use_rows: bool,
    depth: int = 8, T_head: int = 0, n_run: int = 0,
):
    """One-buffer front end for sliced_topk.

    Every per-group host input is packed into a single int32 buffer
    (f32 fields bitcast), so a dispatch costs ONE host->device
    transfer instead of up to 13.  The static slices below are folded
    away by XLA.

    Buffer layout (row-major [n, ...] per field, fields concatenated):
    sl_start[n,qs] sl_len[n,qs] sl_idf[n,qs]
    | use_mask: prog_ops[n,L] prog_args[n,L]
    | use_rows: d_row[n,D] d_idf[n,D]
    | T_head:   h_start[n] h_len[n] h_idf[n] h_row[n] h_pass[n]
    | use_mask and n_run: sl_rows[n,qs]
    | use_mask and use_rows: d_bit[n,D] d_pass[n,2**D]
    """
    per = (3 * qs + (2 * L if use_mask else 0)
           + (2 * D if use_rows else 0) + (5 if T_head else 0)
           + (qs if (use_mask and n_run) else 0)
           + (D + (1 << D) if (use_mask and use_rows) else 0))
    n = buf.shape[0] // per
    off = 0

    def take_i32(m, shape):
        nonlocal off
        seg = lax.slice_in_dim(buf, off, off + m * n).reshape((n,) + shape)
        off += m * n
        return seg

    def take_f32(m, shape):
        return lax.bitcast_convert_type(take_i32(m, shape), jnp.float32)

    sl_start = take_i32(qs, (qs,))
    sl_len = take_i32(qs, (qs,))
    sl_idf = take_f32(qs, (qs,))
    if use_mask:
        prog_ops = take_i32(L, (L,))
        prog_args = take_i32(L, (L,))
    else:
        prog_ops = jnp.zeros((n, L), jnp.int32)
        prog_args = jnp.zeros((n, L), jnp.int32)
    d_row = d_idf = None
    if use_rows:
        d_row = take_i32(D, (D,))
        d_idf = take_f32(D, (D,))
    h_start = h_len = h_idf = h_row = h_pass = None
    if T_head:
        h_start = take_i32(1, ())
        h_len = take_i32(1, ())
        h_idf = take_f32(1, ())
        h_row = take_i32(1, ())
        h_pass = take_i32(1, ()) != 0
    sl_rows = None
    if use_mask and n_run:
        sl_rows = take_i32(qs, (qs,))
    d_bit = d_pass = None
    if use_mask and use_rows:
        d_bit = take_i32(D, (D,))
        d_pass = take_i32(1 << D, (1 << D,)) != 0
    return sliced_topk(
        postings_pack, alive_mask, doc_len, sl_start, sl_len, sl_idf,
        adl, prog_ops, prog_args, dense_rows, d_row, d_idf,
        h_start, h_len, h_idf, h_row, h_pass, sl_rows, d_bit, d_pass,
        T=T, k=k, algo=algo, n_slots=n_slots, use_mask=use_mask,
        single=single, alive_all=alive_all, use_rows=use_rows,
        depth=depth, T_head=T_head, n_run=n_run)


device_search_sliced_packed = functools.partial(
    jax.jit,
    static_argnames=("qs", "L", "D", "T", "k", "algo", "n_slots",
                     "use_mask", "single", "alive_all", "use_rows",
                     "depth", "T_head", "n_run"),
)(sliced_topk_packed)


def pack_sliced_group(sl_start, sl_len, sl_idf, prog_ops=None,
                      prog_args=None, d_row=None, d_idf=None,
                      h_start=None, h_len=None, h_idf=None, h_row=None,
                      h_pass=None, sl_rows=None, d_bit=None,
                      d_pass=None):
    """Host-side packer matching sliced_topk_packed's layout.  Fields
    must be passed exactly when their gate is on (see layout doc)."""
    import numpy as np

    def i32(p):
        p = np.ascontiguousarray(p)
        if p.dtype == np.float32:
            return p.view(np.int32).ravel()
        return p.astype(np.int32, copy=False).ravel()

    parts = [sl_start, sl_len, sl_idf]
    if prog_ops is not None:
        parts += [prog_ops, prog_args]
    if d_row is not None:
        parts += [d_row, d_idf]
    if h_start is not None:
        parts += [h_start, h_len, h_idf, h_row, h_pass]
    if sl_rows is not None:
        parts.append(sl_rows)
    if d_bit is not None:
        parts += [d_bit, d_pass]
    return np.concatenate([i32(p) for p in parts])


def unpack_sliced(packed):
    """Host-side split of the packed [N, 2, k] sliced result into
    (scores f32[N, k], slots i32[N, k]) numpy arrays."""
    import numpy as np

    arr = np.asarray(packed)
    return arr[:, 0, :], arr[:, 1, :].astype(np.int32)


@functools.partial(
    jax.jit,
    static_argnames=("budget", "k", "algo", "use_mask", "depth"),
)
def device_search(
    postings_slot, postings_ltf, doc_len, alive_mask,
    q_start, q_len, q_idf, adl, prog_ops, prog_args,
    *, budget: int, k: int, algo: int, use_mask: bool, depth: int = 8,
):
    """Single-device jitted entry over the candidate-scoring core."""
    return candidate_topk(
        postings_slot, postings_ltf, doc_len, alive_mask,
        q_start, q_len, q_idf, adl, prog_ops, prog_args,
        budget=budget, k=k, algo=algo, use_mask=use_mask, depth=depth)


@functools.partial(
    jax.jit,
    static_argnames=("budget", "k", "algo", "use_mask", "depth"),
)
def device_search_batch(
    postings_slot, postings_ltf, doc_len, alive_mask,
    q_start,    # int32[N, Q]
    q_len,      # int32[N, Q]
    q_idf,      # float32[N, Q]
    adl,        # float32 scalar
    prog_ops,   # int32[N, L]
    prog_args,  # int32[N, L]
    *, budget: int, k: int, algo: int, use_mask: bool, depth: int = 8,
):
    """Batched queries over one snapshot: vmap of the candidate core.

    The index arrays are shared (broadcast) across the batch; each
    query brings its own CSR ranges, IDF and boolean program.  One
    device dispatch scores N queries -- the amortization that the
    per-query host round-trip cannot provide.
    """
    def one(qs, ql, qi, po, pa):
        return candidate_topk(
            postings_slot, postings_ltf, doc_len, alive_mask,
            qs, ql, qi, adl, po, pa,
            budget=budget, k=k, algo=algo, use_mask=use_mask, depth=depth)

    return jax.vmap(one)(q_start, q_len, q_idf, prog_ops, prog_args)


def dense_topk(
    postings_slot: jax.Array,    # int32[P_pad]
    postings_ltf: jax.Array,     # float32[P_pad]
    doc_len: jax.Array,          # float32[S_pad]
    alive_mask: jax.Array,       # uint32[S_pad/32]
    q_start: jax.Array,          # int32[Q]
    q_len: jax.Array,            # int32[Q]
    q_idf: jax.Array,            # float32[Q]
    adl: jax.Array,              # float32 scalar
    prog_ops: jax.Array | None,  # int32[L] or None when not use_mask
    prog_args: jax.Array | None,
    *,
    budget: int,
    k: int,
    algo: int,
    n_slots: int,
    use_mask: bool,
    depth: int = 8,
):
    """Dense scoring core: packed per-term doc bitmaps + a dense
    per-slot score scatter, no sort.  O(B + S) -- the right choice for
    >32-term queries (presence bits overflow) and for postings streams
    comparable to the corpus size, where sorting would dominate."""
    n_terms = q_start.shape[0]
    src, qid, valid = flatten_ranges(q_start, q_len, budget)
    slot = postings_slot[src]
    ltf = postings_ltf[src]
    idf = q_idf[qid]

    if algo == ALGO_BM25:
        score = bm25(ltf, doc_len[slot], idf, adl)
    else:
        score = tf_idf(ltf, idf)
    alive = (alive_mask[slot >> 5]
             >> (slot & 31).astype(jnp.uint32)) & 1
    contrib = jnp.where(valid & alive.astype(bool), score, 0.0)

    if use_mask:
        n_words = n_slots // 32
        masks = build_term_masks(slot, qid, valid,
                                 n_terms=n_terms, n_words=n_words)
        final = eval_program(masks, prog_ops, prog_args, depth=depth)
        bit = (final[slot >> 5] >> (slot & 31).astype(jnp.uint32)) & 1
        contrib = jnp.where(bit.astype(bool), contrib, 0.0)

    dense = jnp.zeros((n_slots,), jnp.float32).at[slot].add(
        contrib, mode="drop")
    k_eff = min(k, n_slots)
    top_scores, top_slots = lax.top_k(dense, k_eff)
    return top_scores, top_slots.astype(jnp.int32)


device_search_dense = functools.partial(
    jax.jit,
    static_argnames=("budget", "k", "algo", "n_slots", "use_mask", "depth"),
)(dense_topk)


@functools.partial(
    jax.jit,
    static_argnames=("budget", "k", "algo", "n_slots", "use_mask", "depth"),
)
def device_search_dense_batch(
    postings_slot, postings_ltf, doc_len, alive_mask,
    q_start,    # int32[N, Q]
    q_len,      # int32[N, Q]
    q_idf,      # float32[N, Q]
    adl,        # float32 scalar
    prog_ops,   # int32[N, L]
    prog_args,  # int32[N, L]
    *, budget: int, k: int, algo: int, n_slots: int, use_mask: bool,
    depth: int = 8,
):
    """Batched dense scoring: vmap of the dense core over queries."""
    def one(qs, ql, qi, po, pa):
        return dense_topk(
            postings_slot, postings_ltf, doc_len, alive_mask,
            qs, ql, qi, adl, po, pa,
            budget=budget, k=k, algo=algo, n_slots=n_slots,
            use_mask=use_mask, depth=depth)

    return jax.vmap(one)(q_start, q_len, q_idf, prog_ops, prog_args)
