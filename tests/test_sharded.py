"""Doc-sharded search over a virtual 8-device mesh.

Verifies that the shard_map execution path (per-shard CSR gather +
local top-k + all_gather merge) produces results identical to the
single-device executor, including exact scores and boolean mask
semantics.
"""

import jax
import pytest

from nxsearch_tpu import Nxs, Params
from nxsearch_tpu.parallel import make_mesh

DOCS = [
    (1, "The quick brown fox jumped over the lazy dog"),
    (2, "Once upon a time there were three little foxes"),
    (3, "Dogs and cats living together in harmony"),
    (4, "A dog chasing a cat chasing a mouse"),
    (5, "Textbook about Erlang in Linux environment"),
    (6, "Unix Shell scripting textbook"),
    (7, "Erlang and Python examples"),
    (8, "Textbook about Python using Linux and Windows"),
    (9, "All but NOT: Textbook Erlang Python Shell Linux Unix Java"),
    (10, "All keywords: Textbook Erlang Python Shell Linux Unix"),
]

QUERIES = [
    "dog",
    "fox dog cat",
    "dog AND cat",
    "dog AND NOT cat",
    "textbook AND (Erlang OR Python OR Shell) AND "
    "(Linux OR Unix) AND NOT (Windows OR Java)",
    "nonexistentterm",
]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    single = Nxs(str(tmp_path_factory.mktemp("single")))
    sharded = Nxs(str(tmp_path_factory.mktemp("sharded")),
                  mesh=make_mesh(jax.devices()))
    for nxs in (single, sharded):
        idx = nxs.index_create("c")
        for doc_id, text in DOCS:
            idx.add(doc_id, text)
    yield single.index_get("c"), sharded.index_get("c")
    single.close()
    sharded.close()


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("algo", ["BM25", "TF-IDF"])
def test_sharded_matches_single_chip(corpora, query, algo):
    single, sharded = corpora
    p = Params().set_str("algo", algo)
    res_single = dict(single.search(query, p))
    res_sharded = dict(sharded.search(query, p))
    assert set(res_single) == set(res_sharded)
    for doc_id, score in res_single.items():
        assert res_sharded[doc_id] == pytest.approx(score, abs=1e-6)


def test_sharded_mutation_and_limit(corpora):
    _, sharded = corpora
    resp = sharded.search("dog", Params().set_uint("limit", 1))
    assert resp.count == 1
    # Mutations refresh the sharded snapshot too.
    sharded.add(100, "another dog appears")
    assert 100 in dict(sharded.search("dog"))
    sharded.remove(100)
    assert 100 not in dict(sharded.search("dog"))


def test_sharded_incremental_no_reupload(tmp_path):
    """A mutation must NOT rebuild/re-upload the postings across the
    mesh: removals flip the alive bitmap, additions stay in the host
    delta until the budget forces a rebuild.
    Private corpus: this test mutates destructively."""
    nxs = Nxs(str(tmp_path), mesh=make_mesh(jax.devices()))
    sharded = nxs.index_create("inc")
    for doc_id, text in DOCS:
        sharded.add(doc_id, text)
    sharded.search("dog")                      # force a fresh snapshot
    dev = sharded.dev
    base_postings = dev.postings_slot
    base_gen = dev.generation

    sharded.add(200, "incremental dog document")
    assert 200 in dict(sharded.search("dog"))
    assert sharded.dev.postings_slot is base_postings, \
        "add must go to the host delta, not a device rebuild"

    sharded.remove(200)
    assert 200 not in dict(sharded.search("dog"))
    assert sharded.dev.postings_slot is base_postings

    # Removing a BASE document flips only the alive bitmap.
    sharded.remove(2)
    assert 2 not in dict(sharded.search("fox"))
    assert sharded.dev.postings_slot is base_postings
    assert sharded.dev.generation != base_gen
    nxs.close()


def test_sharded_wide_boolean_query(corpora):
    """>32 unique terms with boolean operators: the per-shard dense
    executor handles it (the r1 hard 32-term error is gone)."""
    single, sharded = corpora
    words = " ".join(f"zz{i:02d}" for i in range(40))
    for idx in (single, sharded):
        try:
            idx.add(300, words + " dog")
            idx.add(301, words)
        except Exception:
            pass  # module-scoped fixture: docs persist across tests
    q = "(" + " ".join(f"zz{i:02d}" for i in range(40)) + ") AND NOT dog"
    res_single = dict(single.search(q))
    res_sharded = dict(sharded.search(q))
    assert 301 in res_sharded and 300 not in res_sharded
    assert set(res_single) == set(res_sharded)
    for doc_id, score in res_single.items():
        assert res_sharded[doc_id] == pytest.approx(score, abs=1e-6)


def test_sharded_windowed_planes(tmp_path):
    """Sharded windowed plans: with a tiny window width every term
    splits into multiple columns per shard (ragged per-shard window
    counts padded with zero-length columns), and results must match a
    single-chip index exactly -- masked and unmasked, sequential and
    batched."""
    import numpy as np

    import nxsearch_tpu.search as S

    saved_t = S._WINDOW_T
    S._WINDOW_T = 4          # every df > 4 becomes multi-window
    try:
        rng = np.random.default_rng(11)
        words = [f"t{i:02d}" for i in range(40)]
        docs = []
        for i in range(120):
            n = max(3, int(rng.poisson(12)))
            probs = 1.0 / (np.arange(40) + 2.0)
            probs /= probs.sum()
            docs.append((i + 1, " ".join(
                rng.choice(words, size=n, p=probs))))
        single = Nxs(str(tmp_path / "s"))
        sharded = Nxs(str(tmp_path / "m"), mesh=make_mesh(jax.devices()))
        for nxs in (single, sharded):
            idx = nxs.index_create("w")
            idx.add_many(docs)
        i1, i2 = single.index_get("w"), sharded.index_get("w")
        queries = [
            "t00",                       # heavy single term, many windows
            "t00 t07",                   # pair
            "t00 t05 t11",
            "t01 AND t03",
            "t00 AND NOT t04",
            "(t02 OR t06) AND t01",
        ]
        sp = Params().set_uint("limit", 60)
        for q in queries:
            want = dict(i1.search(q, sp))
            got = dict(i2.search(q, sp))
            assert set(got) == set(want), q
            for d, s in want.items():
                assert got[d] == pytest.approx(s, abs=1e-4), (q, d)
        # Batched path through the grouped ssl dispatch.
        seq = [dict(i2.search(q, sp)) for q in queries]
        for q, b, s in zip(queries, i2.search_many(queries, sp), seq):
            got = dict(b)
            assert set(got) == set(s), q
            for d, v in s.items():
                assert got[d] == pytest.approx(v, abs=1e-5), (q, d)
        # Removal: alive masking still applies per shard.
        i2.remove(1)
        i1.remove(1)
        for q in ("t00", "t00 AND NOT t04"):
            assert dict(i2.search(q, sp)).keys() == \
                dict(i1.search(q, sp)).keys()
        single.close()
        sharded.close()
    finally:
        S._WINDOW_T = saved_t


def test_sharded_head_term(tmp_path):
    """Sharded head-term merge: with lowered thresholds the heaviest
    term leaves the per-shard sort plane (per-shard head ranges,
    shard-local searchsorted merge); results must match a single-chip
    index exactly, including masked queries and the 2-term pair rule
    (n_run == 1 skips the sort inside every shard)."""
    import numpy as np

    import nxsearch_tpu.search as S

    saved_df = S._HEAD_MIN_DF
    saved_pair = S._HEAD_MIN_DF_PAIR
    S._HEAD_MIN_DF = 16
    S._HEAD_MIN_DF_PAIR = 16
    try:
        rng = np.random.default_rng(5)
        words = [f"t{i:02d}" for i in range(50)]
        probs = 1.0 / (np.arange(50) + 2.0)
        probs /= probs.sum()
        docs = [(i + 1, " ".join(rng.choice(
            words, size=max(3, int(rng.poisson(15))), p=probs)))
            for i in range(300)]
        single = Nxs(str(tmp_path / "s"))
        sharded = Nxs(str(tmp_path / "m"), mesh=make_mesh(jax.devices()))
        for nxs in (single, sharded):
            idx = nxs.index_create("h")
            idx.add_many(docs)
        i1, i2 = single.index_get("h"), sharded.index_get("h")
        # limit > n_docs: k-truncation of tied tails would otherwise
        # make the two top-k SETS differ legitimately.
        queries = [
            "t00 t30",                   # pair: head + tail, no sort
            "t00 t10 t20 t31",           # head + 3 tails
            "t00 AND t12",               # masked pair
            "t25 AND NOT t00",           # head on the NOT arm
            "(t00 OR t33) AND t02",
        ]
        sp = Params().set_uint("limit", 400)
        for algo in ("BM25", "TF-IDF"):
            spa = Params().set_uint("limit", 400).set_str("algo", algo)
            for q in queries:
                want = dict(i1.search(q, spa))
                got = dict(i2.search(q, spa))
                assert set(got) == set(want), (q, algo)
                for d, s in want.items():
                    assert got[d] == pytest.approx(s, abs=1e-4), \
                        (q, algo, d)
        # Batched ssl dispatch with the head group.
        seq = [dict(i2.search(q, sp)) for q in queries]
        for q, b, s in zip(queries, i2.search_many(queries, sp), seq):
            got = dict(b)
            assert set(got) == set(s), q
            for d, v in s.items():
                assert got[d] == pytest.approx(v, abs=1e-5), (q, d)
        single.close()
        sharded.close()
    finally:
        S._HEAD_MIN_DF = saved_df
        S._HEAD_MIN_DF_PAIR = saved_pair


def test_sharded_prefix_routing(corpora):
    """Pure-OR BM25 queries on the mesh must route through the
    sharded impact-prefix executor (the flagship single-chip serving
    plan, R = 0 complete planes per shard) -- not a fallback -- and
    match the single-chip results exactly."""
    from nxsearch_tpu.search import EXEC_STATS

    single, sharded = corpora
    EXEC_STATS.clear()
    queries = ["dog", "fox dog cat", "textbook erlang python"]
    for q in queries:
        want = dict(single.search(q))
        got = dict(sharded.search(q))
        assert set(got) == set(want), q
        for d, s in want.items():
            assert got[d] == pytest.approx(s, abs=1e-6), (q, d)
    assert EXEC_STATS.get("sharded_prefix", 0) >= len(queries), \
        f"mesh pure-OR queries did not run the prefix path: {EXEC_STATS}"
    # Batched: the spf group dispatch.
    EXEC_STATS.clear()
    seq = [dict(single.search(q)) for q in queries]
    for q, b, s in zip(queries, sharded.search_many(queries), seq):
        got = dict(b)
        assert set(got) == set(s), q
        for d, v in s.items():
            assert got[d] == pytest.approx(v, abs=1e-6), (q, d)
    assert EXEC_STATS.get("sharded_prefix", 0) >= len(queries)


@pytest.mark.slow
def test_sharded_midscale_equivalence(tmp_path):
    """Mid-scale single-vs-sharded sweep (reference stress analogue:
    src/tests/t_stress_dtmap.c:22-128): a 100k-doc Zipf corpus with a
    small window width so the mesh actually exercises window splits,
    column-tier ladders, variable window widths, boolean masks and the
    fuzzy resolve -- the plan mix multi-chip serving would run -- and
    every query's results must equal the single-chip engine's."""
    import numpy as np

    import nxsearch_tpu.search as S
    from nxsearch_tpu.search import EXEC_STATS

    saved_t = S._WINDOW_T
    S._WINDOW_T = 64            # mid-df terms split into many windows
    try:
        rng = np.random.default_rng(23)
        n_vocab, n_docs = 5000, 100_000
        words = np.array([f"w{i:04d}" for i in range(n_vocab)])
        probs = 1.0 / (np.arange(n_vocab) + 10.0)
        probs /= probs.sum()
        single = Nxs(str(tmp_path / "s"))
        sharded = Nxs(str(tmp_path / "m"), mesh=make_mesh(jax.devices()))
        idx1 = single.index_create("mid")
        idx2 = sharded.index_create("mid")
        for base in range(0, n_docs, 4096):
            hi = min(base + 4096, n_docs)
            lens = rng.poisson(10, hi - base).clip(3, None)
            all_ids = rng.choice(n_vocab, size=int(lens.sum()), p=probs)
            bounds = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=bounds[1:])
            docs = [(base + i + 1,
                     " ".join(words[all_ids[bounds[i]: bounds[i + 1]]]))
                    for i in range(hi - base)]
            idx1.add_many(docs)
            idx2.add_many(docs)

        qp = probs ** 0.35
        qp /= qp.sum()
        queries = []
        for j in range(64):
            ids = rng.choice(n_vocab, size=int(rng.integers(2, 5)), p=qp)
            toks = [str(words[i]) for i in ids]
            r = j % 8
            if r == 5:
                queries.append(f"{toks[0]} AND {' '.join(toks[1:])}")
            elif r == 6:
                queries.append(f"{' '.join(toks[:-1])} AND NOT {toks[-1]}")
            elif r == 7:
                queries.append("x" + toks[0][1:] + " " + toks[-1])  # typo
            else:
                queries.append(" ".join(toks))
        sp = Params().set_uint("limit", 20)

        def check(q, w, g):
            # Tie-robust equivalence: single-chip device slots are
            # dl-ordered while sharded slots are host-ordered, so
            # EQUAL-scored docs at the k-truncation boundary may
            # legitimately swap.  The score list itself must match
            # exactly, and every doc present in both must score
            # identically.
            assert len(w) == len(g), q
            np.testing.assert_allclose(
                sorted(w.values(), reverse=True),
                sorted(g.values(), reverse=True), atol=1e-4,
                err_msg=q)
            for d in set(w) & set(g):
                assert g[d] == pytest.approx(w[d], abs=1e-4), (q, d)

        want = [dict(r) for r in idx1.search_many(queries, sp)]
        EXEC_STATS.clear()
        got_b = [dict(r) for r in idx2.search_many(queries, sp)]
        assert EXEC_STATS.get("sharded_prefix", 0) > 0, EXEC_STATS
        for q, w, g in zip(queries, want, got_b):
            check(q, w, g)
        # Sequential spot checks through the per-query path.
        for q in queries[:8]:
            check(q, dict(idx1.search(q, sp)), dict(idx2.search(q, sp)))
        single.close()
        sharded.close()
    finally:
        S._WINDOW_T = saved_t


def test_sharded_dense_rows(tmp_path):
    """Sharded dense-row hybrid: heavy terms (global df over the
    threshold) get per-shard dense score rows; pure-OR queries with
    them run the scatter-max hybrid inside shard_map and must match a
    single-chip index exactly.  Masked queries with dense terms must
    route away from the hybrid (partial presence bits cannot evaluate
    NOT/AND) and still be exact."""
    import numpy as np

    from nxsearch_tpu.index.device import DeviceIndex

    saved_div = DeviceIndex.DENSE_DF_DIV
    DeviceIndex.DENSE_DF_DIV = 1024      # low threshold: dense rows on
    try:
        rng = np.random.default_rng(17)
        words = [f"t{i:02d}" for i in range(30)]
        probs = 1.0 / (np.arange(30) + 2.0)
        probs /= probs.sum()
        docs = [(i + 1, " ".join(rng.choice(
            words, size=max(3, int(rng.poisson(10))), p=probs)))
            for i in range(250)]
        single = Nxs(str(tmp_path / "s"))
        sharded = Nxs(str(tmp_path / "m"), mesh=make_mesh(jax.devices()))
        for nxs in (single, sharded):
            idx = nxs.index_create("d")
            idx.add_many(docs)
        i1, i2 = single.index_get("d"), sharded.index_get("d")
        sp = Params().set_uint("limit", 300)
        i2.search("t00", sp)             # build the sharded snapshot
        assert i2.dev.dense_row_of, "expected sharded dense rows"
        queries = [
            "t00",                        # dense single term
            "t00 t01 t19",                # dense + csr mix (hybrid)
            "t00 t01",                    # two dense terms
            "t00 AND t05",                # masked: must avoid hybrid
            "t07 AND NOT t00",
        ]
        for algo in ("BM25", "TF-IDF"):
            spa = Params().set_uint("limit", 300).set_str("algo", algo)
            for q in queries:
                want = dict(i1.search(q, spa))
                got = dict(i2.search(q, spa))
                assert set(got) == set(want), (q, algo)
                for d, s in want.items():
                    assert got[d] == pytest.approx(s, abs=1e-4), \
                        (q, algo, d)
        # Batched + removals.
        seq = [dict(i2.search(q, sp)) for q in queries]
        for q, b, s in zip(queries, i2.search_many(queries, sp), seq):
            got = dict(b)
            assert set(got) == set(s), q
        for doc_id in range(5, 250, 13):
            i1.remove(doc_id)
            i2.remove(doc_id)
        for q in ("t00 t02", "t00 AND t03"):
            assert dict(i2.search(q, sp)).keys() == \
                dict(i1.search(q, sp)).keys(), q
        single.close()
        sharded.close()
    finally:
        DeviceIndex.DENSE_DF_DIV = saved_div
