"""Impact-prefix pruned executor: exactness and routing.

The prefix executor (ops/executor.prefix_topk) is the pruned fast path
for pure-OR BM25 queries: wide terms (base df > DeviceIndex.PREFIX_CAP)
contribute only their top-CAP postings by impact, bounded by a per-term
tail; the top-M candidates are rescored exactly by binary search and
the result carries an exactness certificate.  Certified results must
match the classic executors document-for-document and
score-for-score; uncertified queries must transparently fall back.
Reference efficiency anchor: the matching-docs-only scoring loop,
/root/reference/src/query/search.c:236-271.
"""

import numpy as np
import pytest

import nxsearch_tpu.search as S
from nxsearch_tpu import Nxs, Params
from nxsearch_tpu.index.device import DeviceIndex


@pytest.fixture()
def small_cap(monkeypatch):
    """Force wide terms on tiny corpora, with wide terms allowed in
    prefix plans (the R > 0 executor defaults off in serving --
    measured certification ~0% at the 8.8M tier -- but stays
    supported via NXS_PREFIX_MAX_WIDE; these tests pin its
    correctness)."""
    monkeypatch.setattr(DeviceIndex, "PREFIX_CAP", 8)
    monkeypatch.setattr(DeviceIndex, "WIDE_MIN_DF", 8)
    monkeypatch.setattr(S, "_PREFIX_MAX_WIDE", 4)


def _classic(idx, query, sp):
    """The same query through the classic (non-prefix) planner."""
    saved = S._prefix_mode
    S._prefix_mode = lambda *a: False
    try:
        return [(d, round(s, 4)) for d, s in idx.search(query, sp)]
    finally:
        S._prefix_mode = saved


def _rows(resp):
    return [(d, round(s, 4)) for d, s in resp]


def test_prefix_parity_random(tmp_path, small_cap):
    """Certified-or-fallback, every query matches the classic result
    (incl. tie order) on a random Zipf corpus where most terms are
    wide at CAP=8."""
    rng = np.random.default_rng(11)
    words = [f"t{i:03d}" for i in range(60)]
    probs = 1.0 / (np.arange(60) + 3.0)
    probs /= probs.sum()
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("t")
    idx.add_many(
        (i + 1, " ".join(rng.choice(words, size=max(3, int(
            rng.poisson(12))), p=probs)))
        for i in range(500))
    sp = Params().set_uint("limit", 10)
    S.EXEC_STATS.clear()
    queries = []
    for _ in range(48):
        n = int(rng.integers(1, 4))
        queries.append(" ".join(rng.choice(words, size=n)))
    got = idx.search_many(queries, sp)
    for q, g in zip(queries, got):
        assert _rows(g) == _classic(idx, q, sp), q
    assert S.EXEC_STATS.get("prefix", 0) > 0
    nxs.close()


def test_prefix_certifies_and_is_exact(tmp_path, small_cap):
    """A corpus with a clear impact hierarchy: the top-CAP high-tf
    short documents dominate the term's excluded tail, so the
    certificate fires and the certified result equals the classic
    executors'."""
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("t")
    docs = []
    did = 1
    # 8 super docs: "pad" x4, short -- exactly the CAP=8 prefix.
    for i in range(8):
        docs.append((did, " ".join(["pad"] * 4 + ["x"] * (2 + i))))
        did += 1
    # 52 weak docs: "pad" once, much longer (low impact tail).
    for i in range(52):
        docs.append((did, "pad " + " ".join(
            f"f{j:02d}" for j in range(30 + i % 9))))
        did += 1
    # 300 docs without "pad" keep idf meaningful.
    for i in range(300):
        docs.append((did, " ".join(
            f"g{j:02d}" for j in range(20 + i % 7))))
        did += 1
    idx.add_many(docs)
    sp = Params().set_uint("limit", 5)

    S.EXEC_STATS.clear()
    got = _rows(idx.search("pad", sp))
    assert S.EXEC_STATS.get("prefix_exact", 0) == 1, S.EXEC_STATS
    assert len(got) == 5
    assert got == _classic(idx, "pad", sp)
    nxs.close()


def test_prefix_narrow_only_certifies(tmp_path, small_cap):
    """Queries whose terms are all complete (df <= CAP) certify by
    construction (total tail 0) and match the classic plan."""
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("t")
    idx.add_many((i + 1, f"alpha w{i:03d} " + "filler " * (i % 5))
                 for i in range(6))
    sp = Params().set_uint("limit", 10)
    S.EXEC_STATS.clear()
    got = _rows(idx.search("alpha w003", sp))
    assert S.EXEC_STATS.get("prefix_exact", 0) == 1
    assert S.EXEC_STATS.get("prefix_fallback", 0) == 0
    assert got == _classic(idx, "alpha w003", sp)
    nxs.close()


def test_prefix_disabled_after_delta(tmp_path, small_cap):
    """Post-snapshot additions move adl away from adl_built: the
    planner must stop routing prefix plans (bounds no longer valid)
    while results stay exact."""
    rng = np.random.default_rng(3)
    words = [f"t{i:02d}" for i in range(30)]
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("t")
    idx.add_many((i + 1, " ".join(rng.choice(words, size=10)))
                 for i in range(200))
    sp = Params().set_uint("limit", 10)
    assert _rows(idx.search("t01 t02", sp))   # snapshot built

    # Long delta docs shift adl; a short one may keep it -- either
    # way results must match the classic plan.
    idx.add(1001, " ".join(rng.choice(words, size=400)))
    S.EXEC_STATS.clear()
    got = _rows(idx.search("t01 t02", sp))
    assert got == _classic(idx, "t01 t02", sp)
    dev = idx.dev
    if dev.adl != dev.adl_built:
        assert S.EXEC_STATS.get("prefix", 0) == 0
    nxs.close()


def test_prefix_respects_removals(tmp_path, small_cap):
    """Tombstoned documents must not resurface through the rescore
    pass (alive masking on candidates)."""
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("t")
    docs = [(i + 1, "zz " + " ".join(["hot"] * (2 + i % 4))
             + " tail" * (i % 6)) for i in range(120)]
    idx.add_many(docs)
    sp = Params().set_uint("limit", 10)
    before = _rows(idx.search("zz hot", sp))
    for d, _ in before[:3]:
        idx.remove(d)
    S.EXEC_STATS.clear()
    got = _rows(idx.search("zz hot", sp))
    assert all(d not in {x[0] for x in before[:3]} for d, _ in got)
    assert got == _classic(idx, "zz hot", sp)
    nxs.close()


def test_prefix_skips_large_limits(tmp_path, small_cap):
    """Limits beyond the rescore ladder top (1024; covers the
    reference's default 1000) keep the classic executors; limits
    within it route prefix with the laddered rescore depth and stay
    exact (a gate of limit <= 32 would push a stock limit=1000 caller
    onto the slow plans)."""
    rng = np.random.default_rng(5)
    words = [f"t{i:02d}" for i in range(20)]
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("t")
    idx.add_many((i + 1, " ".join(rng.choice(words, size=8)))
                 for i in range(150))
    sp = Params().set_uint("limit", 2000)
    S.EXEC_STATS.clear()
    idx.search("t01 t02 t03", sp)
    assert S.EXEC_STATS.get("prefix", 0) == 0

    # limit 100 (and the stock 1000) now serve through prefix, and
    # the results equal the classic executors' exactly.
    for limit in (100, 1000):
        sp = Params().set_uint("limit", limit)
        S.EXEC_STATS.clear()
        got = dict(idx.search("t01 t02 t03", sp))
        assert S.EXEC_STATS.get("prefix", 0) == 1, S.EXEC_STATS
        saved = idx.dev.prefix_cap
        idx.dev.prefix_cap = 0
        try:
            want = dict(idx.search("t01 t02 t03", sp))
        finally:
            idx.dev.prefix_cap = saved
        assert set(got) == set(want)
        for d, s in want.items():
            assert got[d] == pytest.approx(s, abs=1e-5), (limit, d)
    nxs.close()


def test_prefix_boolean_stays_classic(tmp_path, small_cap):
    """Masked (AND/NOT) queries never take the prefix path (presence
    bits over truncated postings cannot evaluate boolean programs)."""
    rng = np.random.default_rng(9)
    words = [f"t{i:02d}" for i in range(20)]
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("t")
    idx.add_many((i + 1, " ".join(rng.choice(words, size=8)))
                 for i in range(150))
    sp = Params().set_uint("limit", 10)
    S.EXEC_STATS.clear()
    idx.search("t01 AND NOT t02", sp)
    assert S.EXEC_STATS.get("prefix", 0) == 0
    nxs.close()


def test_no_prefix_batch_never_plans_prefix(tmp_path, small_cap,
                                            monkeypatch):
    """A no_prefix batch must stay classic even for rows that hit the
    vectorized planner's over-wide per-query fallback (that path once
    dropped the flag and recursed through the certification fallback
    forever)."""
    rng = np.random.default_rng(23)
    words = [f"t{i:03d}" for i in range(40)]
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("t")
    idx.add_many((i + 1, " ".join(rng.choice(words, size=10)))
                 for i in range(400))
    sp_obj = Params().set_uint("limit", 10)
    sp = S.get_search_params(idx.algo, sp_obj)
    idx._read_synced()
    try:
        # Shrink the column cap so a multi-term query overflows into
        # the per-query fallback inside the vectorized classic tail.
        monkeypatch.setattr(S, "_WINDOW_MAX_COLS", 2)
        from nxsearch_tpu.query.parser import parse_query
        from nxsearch_tpu.query.prepare import prepare
        q = prepare(parse_query("t000 t001 t002 t003"), idx.pipeline,
                    idx.dev.host.term_lookup, fuzzymatch=False)
        plans = S._build_plans(idx.dev, [q], sp, no_prefix=True)
        assert plans[0] is not None and not plans[0].pf
    finally:
        idx._rw.read_release()
    nxs.close()


def test_prefix_batch_matches_sequential(tmp_path, small_cap):
    """search_many (vectorized prefix planner + group fallback) equals
    per-query search for a mixed batch."""
    rng = np.random.default_rng(17)
    words = [f"t{i:03d}" for i in range(80)]
    probs = 1.0 / (np.arange(80) + 3.0)
    probs /= probs.sum()
    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("t")
    idx.add_many((i + 1, " ".join(rng.choice(
        words, size=max(3, int(rng.poisson(15))), p=probs)))
        for i in range(600))
    sp = Params().set_uint("limit", 10)
    queries = []
    for _ in range(40):
        n = int(rng.integers(1, 5))
        queries.append(" ".join(rng.choice(words, size=n)))
    queries.append("t000 AND t001")          # masked row in the batch
    queries.append(" ".join(f"t{i:03d}" for i in range(40)))  # wide
    batch = idx.search_many(queries, sp)
    for q, b in zip(queries, batch):
        assert _rows(b) == _rows(idx.search(q, sp)), q
    nxs.close()
