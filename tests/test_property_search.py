"""Randomized differential testing: the routed engine vs an
independent numpy oracle.

Random corpora and random boolean query trees run through the full
public API (whatever executor the router picks -- sliced, hybrid,
prefix, candidate, dense, windowed, head, pair) and must match a
from-scratch numpy implementation of the reference semantics
(search.c:118-271, ranking.c:41-172): recursive bitmap algebra over
per-term document sets, BM25/TF-IDF summed per document, removed
documents invisible.  Knob variations (dense rows, masked hybrid,
window width) reroute the same queries through different executors.
"""

import numpy as np
import pytest

from nxsearch_tpu import Nxs, Params
from nxsearch_tpu.index.device import DeviceIndex

BM25_K1, BM25_B = 1.2, 0.75


def _oracle_scores(doc_tokens, alive_ids, query, algo, token_map=None):
    """Independent scorer: doc_tokens = {doc_id: [token, ...]} (post-
    filter), alive_ids = set of live doc ids.  Returns {doc_id: score}
    for the boolean query tree (parsed with a tiny recursive parser
    over the same grammar subset the generator emits).

    ``token_map`` maps leaf strings to resolved terms (fuzzy).  Query
    tokens dedupe by STRING like the reference tokenset, and scoring
    runs per unique token -- two distinct tokens resolving to the same
    term legitimately double-count, matching the reference's
    per-token score loop (search.c:236-271)."""
    # --- corpus statistics over LIVE documents ------------------------
    live = {d: toks for d, toks in doc_tokens.items() if d in alive_ids}
    n_docs = len(live)
    if n_docs == 0:
        return {}
    doc_len = {d: len(t) for d, t in live.items()}
    token_count = sum(doc_len.values())
    adl = token_count // n_docs
    if algo == "BM25" and adl < 1:
        return {}
    df: dict = {}
    tf: dict = {}
    for d, toks in live.items():
        seen = {}
        for t in toks:
            seen[t] = seen.get(t, 0) + 1
        for t, c in seen.items():
            df[t] = df.get(t, 0) + 1
            tf[(d, t)] = c

    # --- tiny parser for the generated queries ------------------------
    # grammar subset: term | (expr) | expr AND expr | expr OR expr |
    # expr AND NOT expr ; adjacency = OR.
    tokens = query.replace("(", " ( ").replace(")", " ) ").split()
    pos = [0]

    # Precedence mirrors the reference grammar (grammar.y:67-84,
    # tests/test_queryparser.py): AND / AND NOT bind tightest, then
    # explicit OR, then adjacency (implicit OR) loosest.
    def parse_adj():
        node = parse_or()
        while pos[0] < len(tokens) and tokens[pos[0]] != ")":
            node = ("OR", node, parse_or())
        return node

    def parse_or():
        node = parse_and()
        while pos[0] < len(tokens) and tokens[pos[0]] == "OR":
            pos[0] += 1
            node = ("OR", node, parse_and())
        return node

    def parse_and():
        node = parse_prim()
        while pos[0] < len(tokens) and tokens[pos[0]] == "AND":
            pos[0] += 1
            if tokens[pos[0]] == "NOT":
                pos[0] += 1
                node = ("ANDNOT", node, parse_prim())
            else:
                node = ("AND", node, parse_prim())
        return node

    def parse_prim():
        t = tokens[pos[0]]
        if t == "(":
            pos[0] += 1
            node = parse_adj()
            assert tokens[pos[0]] == ")"
            pos[0] += 1
            return node
        pos[0] += 1
        return ("LEAF", t)

    root = parse_adj()

    # --- bitmap algebra + scoring (reference semantics) ----------------
    def docs_of(node):
        kind = node[0]
        if kind == "LEAF":
            t = (token_map or {}).get(node[1], node[1])
            if t is None:
                return set()
            return {d for d in live if (d, t) in tf}
        a, b = docs_of(node[1]), docs_of(node[2])
        if kind == "AND":
            return a & b
        if kind == "OR":
            return a | b
        return a - b

    def leaves(node):
        if node[0] == "LEAF":
            return [node[1]]
        return leaves(node[1]) + leaves(node[2])

    tmap = token_map or {}

    result_docs = docs_of(root)
    terms = [tmap.get(ls, ls) for ls in dict.fromkeys(leaves(root))]
    scores = {}
    for d in result_docs:
        s = 0.0
        for t in terms:
            c = tf.get((d, t))
            if c is None or t not in df:
                continue
            ltf = np.float32(np.log(np.float64(c + 1)))
            if algo == "BM25":
                idf = np.float32(np.log(
                    (n_docs - df[t] + 0.5) / (df[t] + 0.5) + 1.0))
                denom = np.float32(ltf + BM25_K1 * (
                    1.0 - BM25_B + BM25_B * doc_len[d] / adl))
                s += float(np.float32(ltf / denom) * idf)
            else:
                idf = np.float32(np.log(n_docs / df[t]) + 1.0)
                s += float(np.float32(ltf * idf))
        scores[d] = s
    return scores


def _random_query(rng, words):
    """Random boolean tree over the vocab (depth <= 3)."""
    def term():
        return str(words[rng.integers(0, len(words))])

    def expr(depth):
        r = rng.random()
        if depth >= 3 or r < 0.35:
            return term()
        a, b = expr(depth + 1), expr(depth + 1)
        op = rng.choice([" ", " AND ", " OR ", " AND NOT "])
        q = f"{a}{op}{b}"
        return f"({q})" if rng.random() < 0.4 else q
    return expr(0)


@pytest.mark.parametrize("trial", range(6))
def test_random_queries_match_oracle(tmp_path, trial):
    rng = np.random.default_rng(100 + trial)
    vocab = int(rng.integers(10, 60))
    n_docs = int(rng.integers(30, 220))
    words = np.array([f"w{i:03d}x" for i in range(vocab)])
    probs = 1.0 / (np.arange(vocab) + 1.5)
    probs /= probs.sum()

    doc_tokens = {}
    docs = []
    for i in range(n_docs):
        n = max(1, int(rng.poisson(8)))
        toks = [str(w) for w in rng.choice(words, size=n, p=probs)]
        doc_tokens[i + 1] = toks
        docs.append((i + 1, " ".join(toks)))

    import nxsearch_tpu.search as S
    knobs = trial % 3
    saved = (S._MASKED_HYBRID, S._WINDOW_T, DeviceIndex.DENSE_DF_DIV)
    if knobs == 1:
        S._MASKED_HYBRID = True
        DeviceIndex.DENSE_DF_DIV = 1024      # everything dense-capable
    elif knobs == 2:
        S._WINDOW_T = 8                      # multi-window planes
    try:
        nxs = Nxs(str(tmp_path))
        # stemming/stopwords off: the oracle sees raw lowercase tokens.
        idx = nxs.index_create("p", Params({"filters": ["normalizer"]}))
        idx.add_many(docs)

        alive = set(doc_tokens)
        removed = rng.choice(n_docs, size=n_docs // 5, replace=False)
        for r in removed:
            idx.remove(int(r) + 1)
            alive.discard(int(r) + 1)

        for algo in ("BM25", "TF-IDF"):
            sp = Params().set_uint("limit", 100000).set_str("algo", algo)
            for _ in range(12):
                q = _random_query(rng, words)
                got = dict(idx.search(q, sp))
                want = _oracle_scores(doc_tokens, alive, q, algo)
                want = {d: s for d, s in want.items() if s > 0.0}
                assert set(got) == set(want), (trial, algo, q)
                for d, s in want.items():
                    assert got[d] == pytest.approx(s, abs=2e-4), \
                        (trial, algo, q, d)
        nxs.close()
    finally:
        (S._MASKED_HYBRID, S._WINDOW_T,
         DeviceIndex.DENSE_DF_DIV) = saved


def _levdist(a: str, b: str) -> int:
    """Classic Wagner-Fischer (insert/delete/substitute, unit costs) --
    byte-level like the reference levdist.c."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("trial", range(3))
def test_fuzzy_queries_match_oracle(tmp_path, trial):
    """Fuzzy resolution differential test: typo'd tokens must resolve
    to the reference's selection -- highest LIVE total occurrences
    within Levenshtein tolerance 2, ties to the oldest term
    (idxterm.c:236-242; select_best_ids) -- then score like any term."""
    rng = np.random.default_rng(500 + trial)
    vocab = int(rng.integers(12, 40))
    n_docs = int(rng.integers(40, 160))
    words = np.array([f"word{i:02d}end" for i in range(vocab)])
    probs = 1.0 / (np.arange(vocab) + 2.0)
    probs /= probs.sum()

    doc_tokens = {}
    docs = []
    term_order: list = []
    for i in range(n_docs):
        n = max(1, int(rng.poisson(7)))
        toks = [str(w) for w in rng.choice(words, size=n, p=probs)]
        doc_tokens[i + 1] = toks
        for t in toks:
            if t not in term_order:
                term_order.append(t)
        docs.append((i + 1, " ".join(toks)))

    nxs = Nxs(str(tmp_path))
    idx = nxs.index_create("f", Params({"filters": ["normalizer"]}))
    idx.add_many(docs)
    alive = set(doc_tokens)
    for r in rng.choice(n_docs, size=n_docs // 6, replace=False):
        idx.remove(int(r) + 1)
        alive.discard(int(r) + 1)

    def live_total(t):
        return sum(doc_tokens[d].count(t) for d in alive)

    def resolve(tok):
        """Reference fuzzy selection for an unregistered token."""
        if tok in term_order:
            return tok
        best, best_total = None, 0
        for t in term_order:            # oldest-first: ties keep first
            if live_total(t) > 0 and _levdist(tok, t) <= 2:
                if live_total(t) > best_total:
                    best, best_total = t, live_total(t)
        return best

    sp = Params().set_uint("limit", 100000)
    for _ in range(10):
        w = str(words[rng.integers(0, vocab)])
        # typo: swap two adjacent chars or drop one (never a vocab hit:
        # the wordNNend shape keeps mutations out of the vocabulary).
        p = int(rng.integers(1, len(w) - 1))
        typo = w[:p - 1] + w[p] + w[p - 1] + w[p + 1:] \
            if rng.random() < 0.5 else w[:p] + w[p + 1:]
        if typo in term_order:
            continue
        other = str(words[rng.integers(0, vocab)])
        q = f"{typo} {other}"
        got = dict(idx.search(q, sp))
        rt = resolve(typo)
        want = _oracle_scores(doc_tokens, alive, q, "BM25",
                              token_map={typo: rt})
        want = {d: s for d, s in want.items() if s > 0.0}
        assert set(got) == set(want), (trial, q, rt)
        for d, s in want.items():
            assert got[d] == pytest.approx(s, abs=2e-4), (trial, q, d)
    nxs.close()
