"""Sliced-executor parity: routed results vs the candidate core.

The sliced executor (ops/executor.py sliced_topk) is the fast path
for selective queries: contiguous per-term postings windows instead
of random gathers, one variadic sort, segmented-scan aggregation, and
(for pure-OR queries with dense-row head terms) a scatter-max hybrid
with the dense-row sweep.  Results must match the sort/scatter
candidate executor document-for-document and score-for-score.
"""

import numpy as np
import pytest

from nxsearch_tpu import Nxs, Params
from nxsearch_tpu.index.device import DeviceIndex


def _rand_corpus(rng, n_docs, vocab, mean_len):
    words = [f"t{i:03d}" for i in range(vocab)]
    probs = 1.0 / (np.arange(vocab) + 3.0)
    probs /= probs.sum()
    docs = []
    for i in range(n_docs):
        n = max(3, int(rng.poisson(mean_len)))
        docs.append((i + 1, " ".join(rng.choice(words, size=n, p=probs))))
    return docs, words


def _reference_scores(idx, query, sp):
    """Force the non-sliced executors and return {doc: score}."""
    import nxsearch_tpu.search as S

    saved_sl = S._use_sliced
    S._use_sliced = lambda p, s, d: False
    try:
        return dict(idx.search(query, sp))
    finally:
        S._use_sliced = saved_sl


QUERIES = [
    "t000",                       # head term (dense-row at low DIV)
    "t042",
    "t001 t017 t033",
    "t000 t050 t090",             # head + tail mix (hybrid path)
    "t003 AND t011",
    "t004 AND NOT t001",
    "(t002 OR t013) AND NOT t005",
    "t000 AND t029",              # masked + would-be-dense term
    "t077 t078 t079 t080 t081 t082 t083 t084 t085",  # > 8 terms
]


@pytest.fixture(scope="module")
def corpus_index(tmp_path_factory):
    rng = np.random.default_rng(7)
    docs, _ = _rand_corpus(rng, 400, 100, 30)
    base = tmp_path_factory.mktemp("sliced")
    nxs = Nxs(str(base))
    idx = nxs.index_create("c")
    idx.add_many(docs)
    yield idx
    nxs.close()


@pytest.mark.parametrize("algo", ["BM25", "TF-IDF"])
@pytest.mark.parametrize("query", QUERIES)
def test_sliced_matches_candidate(corpus_index, query, algo):
    sp = Params().set_uint("limit", 25).set_str("algo", algo)
    got = dict(corpus_index.search(query, sp))
    want = _reference_scores(corpus_index, query, sp)
    assert set(got) == set(want)
    for d, s in want.items():
        assert got[d] == pytest.approx(s, abs=1e-4), (query, d)


def test_sliced_with_dense_rows(tmp_path):
    """Low DENSE_DF_DIV forces head terms into dense rows so pure-OR
    queries exercise the hybrid scatter-max merge."""
    saved = DeviceIndex.DENSE_DF_DIV
    DeviceIndex.DENSE_DF_DIV = 4
    try:
        rng = np.random.default_rng(11)
        docs, _ = _rand_corpus(rng, 500, 60, 25)
        nxs = Nxs(str(tmp_path))
        idx = nxs.index_create("h")
        idx.add_many(docs)
        assert idx.dev is None or True
        sp = Params().set_uint("limit", 30)
        for query in ["t000", "t000 t001 t040", "t002 t003",
                      "t000 t001 t002 t003 t050"]:
            got = dict(idx.search(query, sp))
            assert idx.dev.dense_row_of, "expected dense rows at DIV=4"
            want = _reference_scores(idx, query, sp)
            assert set(got) == set(want), query
            for d, s in want.items():
                assert got[d] == pytest.approx(s, abs=1e-4), (query, d)
        nxs.close()
    finally:
        DeviceIndex.DENSE_DF_DIV = saved


def test_sliced_after_removals(tmp_path):
    """Removals flip the alive bitmap (alive_all False): the sliced
    path must mask dead documents in both planes."""
    rng = np.random.default_rng(3)
    docs, _ = _rand_corpus(rng, 300, 50, 20)
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("r")
    idx.add_many(docs)
    idx.search("t001")  # build the base snapshot
    for doc_id in range(2, 300, 7):
        idx.remove(doc_id)
    sp = Params().set_uint("limit", 50)
    for query in ["t000 t004", "t001 AND t002", "t005 AND NOT t001"]:
        got = dict(idx.search(query, sp))
        removed = set(range(2, 300, 7))
        assert not (set(got) & removed), query
        want = _reference_scores(idx, query, sp)
        assert set(got) == set(want), query
        for d, s in want.items():
            assert got[d] == pytest.approx(s, abs=1e-4), (query, d)
    nxs.close()


def test_sliced_batched_matches_sequential(corpus_index):
    sp = Params().set_uint("limit", 10)
    seq = [dict(corpus_index.search(q, sp)) for q in QUERIES]
    batched = corpus_index.search_many(QUERIES, sp)
    for q, s, b in zip(QUERIES, seq, batched):
        got = dict(b)
        assert set(got) == set(s), q
        for d, v in s.items():
            assert got[d] == pytest.approx(v, abs=1e-5), (q, d)


def test_sliced_delta_merge(tmp_path):
    """Post-snapshot documents (host delta) merge with sliced device
    results exactly like the other executors."""
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("d")
    idx.add_many([(i + 1, f"alpha beta w{i % 7}") for i in range(64)])
    idx.search("alpha")  # snapshot
    idx.add(1000, "alpha gamma")
    idx.add(1001, "gamma delta")
    got = dict(idx.search("alpha gamma", Params().set_uint("limit", 100)))
    assert 1000 in got and 1001 in got and 1 in got
    nxs.close()


def test_sliced_head_term_hybrid(tmp_path):
    """Head-term extraction: the heaviest CSR term leaves the sort
    plane for the searchsorted/top_k merge (T_head > 0).  Lowering
    _HEAD_MIN_DF (and disabling dense rows with DENSE_DF_DIV=1) makes
    the tiny corpus take that path; results must match the reference
    executors exactly, including masked (AND/NOT) queries where
    head-only documents are gated by the host-evaluated program."""
    import nxsearch_tpu.search as S

    saved_df = S._HEAD_MIN_DF
    saved_pair = S._HEAD_MIN_DF_PAIR
    saved_div = DeviceIndex.DENSE_DF_DIV
    S._HEAD_MIN_DF = 16
    S._HEAD_MIN_DF_PAIR = 16            # pair queries use this one
    DeviceIndex.DENSE_DF_DIV = 1        # df > s_pad: no dense rows
    try:
        rng = np.random.default_rng(23)
        docs, _ = _rand_corpus(rng, 500, 80, 25)
        nxs = Nxs(str(tmp_path))
        idx = nxs.index_create("hd")
        idx.add_many(docs)
        # The impact-prefix path would otherwise win the route for
        # pure-OR BM25 rows (limit <= 1024 serves prefix since r5);
        # this test exercises the CLASSIC head hybrid, so disable it.
        idx.search("t000")
        idx.dev.prefix_cap = 0
        queries = [
            "t000 t050",                   # head + 1 tail
            "t000 t001 t060 t070",         # head + 3 tails
            "t000 AND t030",               # masked: head must pass AND
            "t031 AND NOT t000",           # masked: head is the NOT arm
            "(t000 OR t055) AND t001",     # masked, nested
            "t000 OR t001",                # two heavy terms: one head
        ]
        for algo in ("BM25", "TF-IDF"):
            sp = Params().set_uint("limit", 60).set_str("algo", algo)
            for query in queries:
                S.EXEC_STATS.pop("sliced_head", None)
                got = dict(idx.search(query, sp))
                assert S.EXEC_STATS.get("sliced_head", 0) >= 1, \
                    (query, algo, "head path not taken")
                want = _reference_scores(idx, query, sp)
                assert set(got) == set(want), (query, algo)
                for d, s in want.items():
                    assert got[d] == pytest.approx(s, abs=1e-4), \
                        (query, algo, d)
        # Batched: same plans through the vectorized planner.
        sp = Params().set_uint("limit", 30)
        seq = [dict(idx.search(q, sp)) for q in queries]
        S.EXEC_STATS.pop("sliced_head", None)
        batched = idx.search_many(queries, sp)
        assert S.EXEC_STATS.get("sliced_head", 0) >= 1
        for q, s, b in zip(queries, seq, batched):
            got = dict(b)
            assert set(got) == set(s), q
            for d, v in s.items():
                assert got[d] == pytest.approx(v, abs=1e-5), (q, d)
        # Removals: alive masking applies to the head plane too.
        for doc_id in range(3, 500, 11):
            idx.remove(doc_id)
        sp = Params().set_uint("limit", 50)
        for query in ["t000 t040", "t000 AND t020"]:
            got = dict(idx.search(query, sp))
            removed = set(range(3, 500, 11))
            assert not (set(got) & removed), query
            want = _reference_scores(idx, query, sp)
            assert set(got) == set(want), query
            for d, s in want.items():
                assert got[d] == pytest.approx(s, abs=1e-4), (query, d)
        nxs.close()
    finally:
        S._HEAD_MIN_DF = saved_df
        S._HEAD_MIN_DF_PAIR = saved_pair
        DeviceIndex.DENSE_DF_DIV = saved_div


def test_sliced_pair_head(tmp_path):
    """Two-term queries take the head merge at the lower pair
    threshold (_HEAD_MIN_DF_PAIR): the remaining single logical term
    skips the sort entirely.  Three-term queries at the same df must
    still use the general threshold.  Exactness vs the reference
    executors, masked and unmasked, sequential and batched."""
    import nxsearch_tpu.search as S

    saved_pair = S._HEAD_MIN_DF_PAIR
    saved_div = DeviceIndex.DENSE_DF_DIV
    S._HEAD_MIN_DF_PAIR = 16            # pair rule fires on tiny corpus
    DeviceIndex.DENSE_DF_DIV = 1        # df > s_pad: no dense rows
    try:
        rng = np.random.default_rng(31)
        docs, _ = _rand_corpus(rng, 600, 90, 25)
        nxs = Nxs(str(tmp_path))
        idx = nxs.index_create("ph")
        idx.add_many(docs)
        # Disable the prefix route (it would win pure-OR BM25 rows);
        # this test exercises the CLASSIC pair-head hybrid.
        idx.search("t000")
        idx.dev.prefix_cap = 0
        pair_queries = [
            "t000 t061",                 # big head, small tail
            "t005 t006",                 # mid pair
            "t000 AND t044",             # masked pair
            "t050 AND NOT t000",         # masked, head on the NOT arm
        ]
        for algo in ("BM25", "TF-IDF"):
            sp = Params().set_uint("limit", 60).set_str("algo", algo)
            for query in pair_queries:
                S.EXEC_STATS.pop("sliced_head", None)
                got = dict(idx.search(query, sp))
                assert S.EXEC_STATS.get("sliced_head", 0) >= 1, \
                    (query, algo, "pair head path not taken")
                want = _reference_scores(idx, query, sp)
                assert set(got) == set(want), (query, algo)
                for d, s in want.items():
                    assert got[d] == pytest.approx(s, abs=1e-4), \
                        (query, algo, d)
        # A 3-term query at the same dfs stays below _HEAD_MIN_DF:
        # no head extraction (the general threshold still applies).
        S.EXEC_STATS.pop("sliced_head", None)
        sp = Params().set_uint("limit", 60)
        got = dict(idx.search("t005 t006 t007", sp))
        assert S.EXEC_STATS.get("sliced_head", 0) == 0
        want = _reference_scores(idx, "t005 t006 t007", sp)
        assert set(got) == set(want)
        # Batched planner: same pair routing and results.
        seq = [dict(idx.search(q, sp)) for q in pair_queries]
        S.EXEC_STATS.pop("sliced_head", None)
        batched = idx.search_many(pair_queries, sp)
        assert S.EXEC_STATS.get("sliced_head", 0) >= 1
        for q, s, b in zip(pair_queries, seq, batched):
            got = dict(b)
            assert set(got) == set(s), q
            for d, v in s.items():
                assert got[d] == pytest.approx(v, abs=1e-5), (q, d)
        nxs.close()
    finally:
        S._HEAD_MIN_DF_PAIR = saved_pair
        DeviceIndex.DENSE_DF_DIV = saved_div


def test_sliced_window_split(tmp_path):
    """Wide terms split into fixed-width window columns: shrinking
    _WINDOW_T forces every df > 32 across several columns.  Results
    (sequential and batched, pure-OR and masked) must match the
    reference executors exactly, and multi-window plans must carry
    n_run (the logical term count) below the column count."""
    import nxsearch_tpu.search as S

    saved_t = S._WINDOW_T
    saved_div = DeviceIndex.DENSE_DF_DIV
    S._WINDOW_T = 32
    DeviceIndex.DENSE_DF_DIV = 1        # no dense rows
    try:
        rng = np.random.default_rng(31)
        docs, _ = _rand_corpus(rng, 500, 80, 25)
        nxs = Nxs(str(tmp_path))
        idx = nxs.index_create("win")
        idx.add_many(docs)
        queries = [
            "t000",                        # single wide term, many windows
            "t000 t001",                   # two wide terms
            "t000 t050 t060",              # wide + narrow mix
            "t000 AND t001",               # masked across windows
            "t002 AND NOT t000",           # NOT arm is wide
            "(t000 OR t055) AND t001",
            "t001 t002 t003 t004 t005",    # several mid terms
        ]
        # The planner must actually split: a df>32 term gets >1 column.
        sp0 = Params().set_uint("limit", 30)
        idx.search("t000", sp0)   # materialize the device snapshot
        prepared = S._prepare_many(
            idx.dev, idx.pipeline, ["t000 t001"],
            S.get_search_params(idx.algo, sp0),
            idx._fuzzy_lookup, idx._fuzzy_prefetch)
        plan = S._build_plans(idx.dev, prepared,
                              S.get_search_params(idx.algo, sp0))[0]
        n_cols = int((plan.sl_len > 0).sum())
        assert plan.n_run >= 2 and n_cols > 2, \
            (plan.n_run, n_cols, "expected multi-window split")
        assert plan.sl_T == 32
        for algo in ("BM25", "TF-IDF"):
            sp = Params().set_uint("limit", 60).set_str("algo", algo)
            for query in queries:
                got = dict(idx.search(query, sp))
                want = _reference_scores(idx, query, sp)
                assert set(got) == set(want), (query, algo)
                for d, s in want.items():
                    assert got[d] == pytest.approx(s, abs=1e-4), \
                        (query, algo, d)
        # Batched planner takes the same windowed shape.
        sp = Params().set_uint("limit", 30)
        seq = [dict(idx.search(q, sp)) for q in queries]
        batched = idx.search_many(queries, sp)
        for q, s, b in zip(queries, seq, batched):
            assert dict(b) == pytest.approx(s, abs=1e-4), q
        nxs.close()
    finally:
        S._WINDOW_T = saved_t
        DeviceIndex.DENSE_DF_DIV = saved_div


def test_sliced_window_overflow_fallback(tmp_path):
    """Queries whose windows exceed _WINDOW_MAX_COLS keep the legacy
    tiered plane (n_run == 0) and still return exact results."""
    import nxsearch_tpu.search as S

    saved_t = S._WINDOW_T
    saved_cols = S._WINDOW_MAX_COLS
    saved_div = DeviceIndex.DENSE_DF_DIV
    S._WINDOW_T = 16
    S._WINDOW_MAX_COLS = 8
    DeviceIndex.DENSE_DF_DIV = 1
    try:
        rng = np.random.default_rng(37)
        docs, _ = _rand_corpus(rng, 400, 60, 25)
        nxs = Nxs(str(tmp_path))
        idx = nxs.index_create("ovf")
        idx.add_many(docs)
        sp = Params().set_uint("limit", 40)
        idx.search("t000", sp)   # materialize the device snapshot
        spp = S.get_search_params(idx.algo, sp)
        prepared = S._prepare_many(idx.dev, idx.pipeline,
                                   ["t000 t001 t002"], spp,
                                   idx._fuzzy_lookup, idx._fuzzy_prefetch)
        plan = S._build_plans(idx.dev, prepared, spp)[0]
        assert plan.n_run == 0, "expected legacy fallback plan"
        for query in ["t000 t001 t002", "t000 AND t001"]:
            got = dict(idx.search(query, sp))
            want = _reference_scores(idx, query, sp)
            assert set(got) == set(want), query
            for d, s in want.items():
                assert got[d] == pytest.approx(s, abs=1e-4), (query, d)
        # Mixed batch: overflow rows fall back per-query, narrow rows
        # stay windowed; results identical either way.
        queries = ["t000 t001 t002", "t050 t051"]
        seq = [dict(idx.search(q, sp)) for q in queries]
        batched = idx.search_many(queries, sp)
        for q, s, b in zip(queries, seq, batched):
            assert dict(b) == pytest.approx(s, abs=1e-4), q
        nxs.close()
    finally:
        S._WINDOW_T = saved_t
        S._WINDOW_MAX_COLS = saved_cols
        DeviceIndex.DENSE_DF_DIV = saved_div


def test_sliced_group_coalescing(tmp_path):
    """Small fine-signature groups merge into widened coarse groups
    (search.py _coalesce_sliced_groups): a heterogeneous batch --
    different column pads, head/no-head tiers, run counts, masked and
    single-term rows -- must dispatch FEWER groups than fine keys
    while matching sequential results score-for-score."""
    import nxsearch_tpu.search as S

    saved_df = S._HEAD_MIN_DF
    saved_div = DeviceIndex.DENSE_DF_DIV
    S._HEAD_MIN_DF = 16
    DeviceIndex.DENSE_DF_DIV = 1        # no dense rows
    try:
        rng = np.random.default_rng(41)
        docs, _ = _rand_corpus(rng, 500, 90, 25)
        nxs = Nxs(str(tmp_path))
        idx = nxs.index_create("co")
        idx.add_many(docs)
        queries = [
            "t042",                          # single, no head
            "t000",                          # single, head-df term
            "t000 t050",                     # head + tail, qs small
            "t001 t060 t070 t075 t080",      # head + several tails
            "t051 t061",                     # tails only
            "t052 t062 t071 t076 t081 t082 t083",  # wider qs
            "t000 AND t030",                 # masked with head
            "t031 AND NOT t053",             # masked, no head
            "(t054 OR t055) AND t056",       # masked, nested
        ]
        sp = Params().set_uint("limit", 50)
        seq = [dict(idx.search(q, sp)) for q in queries]

        # Count dispatched groups via the chunked plan list.
        spp = S.get_search_params(idx.algo, sp)
        idx._read_synced()
        idx._rw.read_release()
        prepared = S._prepare_many(idx.dev, idx.pipeline, queries, spp,
                                   idx._fuzzy_lookup, idx._fuzzy_prefetch)
        plans = [S._build_plan(idx.dev, q, spp) for q in prepared]
        fine = {}
        for p in plans:
            if p is None:
                continue
            fine.setdefault((len(p.sl_start), p.h_T, p.n_run, p.single,
                             p.use_mask, len(p.prog_ops)), 0)
        st = S.submit_query_batch(idx.dev, prepared, spp)
        n_groups = len(st.chunked)
        assert n_groups < len(fine), (n_groups, len(fine))
        batched = S.collect_query_batch(idx.dev, st, spp)

        for q, s, b in zip(queries, seq, batched):
            got = dict(b)
            assert set(got) == set(s), q
            for d, v in s.items():
                assert got[d] == pytest.approx(v, abs=1e-5), (q, d)
        nxs.close()
    finally:
        S._HEAD_MIN_DF = saved_df
        DeviceIndex.DENSE_DF_DIV = saved_div


def test_dense_row_cap_reorder(tmp_path):
    """When the dense-row cap binds, the kept heavy terms must be
    re-sorted by term id: _dense_rows_dev maps postings to rows via a
    searchsorted over per-row CSR starts, which requires monotone
    starts.  Arrange arrival order so the heaviest term has the
    LARGEST id (any real corpus; the synthetic bench's df happens to
    be monotone in id, which masked this)."""
    import numpy as np

    saved_rows = DeviceIndex.MAX_DENSE_ROWS
    saved_div = DeviceIndex.DENSE_DF_DIV
    DeviceIndex.MAX_DENSE_ROWS = 2
    DeviceIndex.DENSE_DF_DIV = 1024       # threshold df > s_pad/1024
    try:
        rng = np.random.default_rng(3)
        nxs = Nxs(str(tmp_path))
        idx = nxs.index_create("cap")
        docs = []
        for i in range(128):
            words = ["filler%d" % rng.integers(0, 50)]
            # mid1/mid2 registered FIRST (lower ids); huge first
            # appears in doc 9, so its term id is the LARGEST of the
            # dense-eligible set -- the df-ordered cap selection must
            # re-sort it ascending.
            words.append("mid1" if i % 2 == 0 else "mid2")
            if i >= 8:
                words.append("huge")
            docs.append((i + 1, " ".join(words)))
        idx.add_many(docs)
        idx.search("huge")  # build the device snapshot
        # dense-eligible: mid1 (64), mid2 (64), huge (120) with cap 2
        # -> keeps {huge, mid1}; ids must come out ascending.
        rows = idx.dev.dense_row_of
        assert len(rows) == 2, rows
        assert list(rows) == sorted(rows), rows
        sp = Params().set_uint("limit", 128)
        for q in ("huge", "mid1 huge", "mid2 huge filler3",
                  "mid1 mid2 huge"):
            got = dict(idx.search(q, sp))
            want = _reference_scores(idx, q, sp)
            assert set(got) == set(want), q
            for d, s in want.items():
                assert got[d] == pytest.approx(s, abs=1e-4), (q, d)
        nxs.close()
    finally:
        DeviceIndex.MAX_DENSE_ROWS = saved_rows
        DeviceIndex.DENSE_DF_DIV = saved_div


def test_masked_dense_hybrid(tmp_path):
    """Masked dense-row hybrid (NXS_MASKED_HYBRID): AND/NOT queries
    with dense-handled terms run on the sliced path -- candidate lanes
    gather dense presence bits, dense-only documents are gated by the
    host-evaluated verdict table, and covered slots override the
    dense-only score (a failing candidate must NOT fall back to its
    dense partial).  Exact vs the reference executors."""
    import nxsearch_tpu.search as S

    saved_flag = S._MASKED_HYBRID
    saved_div = DeviceIndex.DENSE_DF_DIV
    S._MASKED_HYBRID = True
    DeviceIndex.DENSE_DF_DIV = 1024
    try:
        rng = np.random.default_rng(29)
        docs, _ = _rand_corpus(rng, 400, 50, 20)
        nxs = Nxs(str(tmp_path))
        idx = nxs.index_create("mh")
        idx.add_many(docs)
        idx.search("t000")
        assert idx.dev.dense_row_of, "expected dense rows"
        queries = [
            "t000 AND t020",              # dense AND csr
            "t000 AND NOT t015",          # dense AND NOT csr
            "t020 AND NOT t000",          # csr AND NOT dense
            "(t000 OR t030) AND t010",    # dense in an OR arm
            "(t000 OR t001) AND NOT t025",  # two dense terms
            "t000 AND t001",              # dense AND dense
        ]
        for algo in ("BM25", "TF-IDF"):
            sp = Params().set_uint("limit", 500).set_str("algo", algo)
            for q in queries:
                plan_q = idx._prepare(q) if hasattr(idx, "_prepare") \
                    else None
                got = dict(idx.search(q, sp))
                want = _reference_scores(idx, q, sp)
                assert set(got) == set(want), (q, algo)
                for d, s in want.items():
                    assert got[d] == pytest.approx(s, abs=1e-4), \
                        (q, algo, d)
        # Batched path through the grouped dispatch.
        sp = Params().set_uint("limit", 500)
        seq = [dict(idx.search(q, sp)) for q in queries]
        for q, b, s in zip(queries, idx.search_many(queries, sp), seq):
            got = dict(b)
            assert set(got) == set(s), q
            for d, v in s.items():
                assert got[d] == pytest.approx(v, abs=1e-5), (q, d)
        # Removals: alive masking applies to both planes.
        for doc_id in range(3, 400, 9):
            idx.remove(doc_id)
        for q in ("t000 AND t005", "t008 AND NOT t000"):
            got = dict(idx.search(q, sp))
            assert not (set(got) & set(range(3, 400, 9))), q
            want = _reference_scores(idx, q, sp)
            assert set(got) == set(want), q
            for d, s in want.items():
                assert got[d] == pytest.approx(s, abs=1e-4), (q, d)
        nxs.close()
    finally:
        S._MASKED_HYBRID = saved_flag
        DeviceIndex.DENSE_DF_DIV = saved_div
