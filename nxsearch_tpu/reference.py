"""Plain float64 reference search over a HostIndex, for checks.

An independent implementation of the engine's query semantics that
the device paths are compared with (chip_smoke.py, tests).  It shares
no code with ops/ or index/device.py:

- postings come straight from the host journal arrays (arrival order,
  live documents only), grouped per query term with numpy;
- BM25 / TF-IDF (src/algo/ranking.c) are evaluated in float64;
- AND / OR / AND NOT are numpy set algebra over document slots,
  walking the parsed query (src/query/search.c:118-174);
- a query token missing from the dictionary resolves to the most
  popular term within Levenshtein distance 2 over UTF-8 bytes (ties:
  lowest term id), found by a vectorised Wagner-Fischer scan of the
  whole dictionary (src/index/idxterm.c:210-249).

Only the text pipeline and the query parser are shared with the
engine: both sides must see the same tokens.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .query.ast import EXPR_OP_AND, EXPR_OP_NOT, EXPR_OP_OR
from .query.parser import parse_query

# ranking.c:141-142, restated here on purpose.
_K1 = 1.2
_B = 0.75
FUZZY_TOLERANCE = 2


class ReferenceIndex:
    """Snapshot of one HostIndex's live state for reference queries.

    Build it after the last mutation the queries should see."""

    def __init__(self, host, pipeline):
        host.sync()
        self.host = host
        self.pipeline = pipeline
        alive = host.doc_alive.view().copy()
        slots = host.p_slot.view()
        live = alive[slots]
        self._p_term = host.p_term.view()[live]
        self._p_slot = slots[live]
        self._p_tf = host.p_count.view()[live]
        self.doc_ids = host.doc_ids.view().copy()
        self.doc_len = host.doc_len.view().astype(np.float64)
        self.df = host.term_df.view().copy()
        self.total = host.term_total.view().copy()
        self.n_docs = int(host.doc_count)
        # Integer division, as ranking.c:160 does.
        self.adl = float(host.token_count // max(host.doc_count, 1))
        self._terms = [v.encode("utf-8") for v in host.term_values]
        self._term_len = np.fromiter((len(t) for t in self._terms),
                                     dtype=np.int64, count=len(self._terms))

    # -- term resolution ------------------------------------------------

    def fuzzy_pick(self, value: str) -> Optional[int]:
        """1-based id of the most popular live term within distance 2
        of ``value`` (ties: lowest id), or None."""
        q = np.frombuffer(value.encode("utf-8"), dtype=np.uint8)
        m = len(q)
        cand = np.nonzero((self.total > 0)
                          & (np.abs(self._term_len - m) <= FUZZY_TOLERANCE)
                          )[0]
        if not len(cand):
            return None
        lens = self._term_len[cand]
        width = int(lens.max())
        chars = np.zeros((len(cand), width), dtype=np.int16)
        for row, t in enumerate(cand):
            enc = self._terms[t]
            chars[row, : len(enc)] = np.frombuffer(enc, dtype=np.uint8)
        # Row i of the DP table over every candidate at once:
        # prev[:, j] = distance(q[:i], term[:j]).
        prev = np.broadcast_to(np.arange(width + 1), (len(cand), width + 1)
                               ).copy()
        for i in range(1, m + 1):
            cur = np.empty_like(prev)
            cur[:, 0] = i
            sub = prev[:, :-1] + (chars != q[i - 1])
            dele = prev[:, 1:] + 1
            best = np.minimum(sub, dele)
            for j in range(1, width + 1):
                cur[:, j] = np.minimum(best[:, j - 1], cur[:, j - 1] + 1)
            prev = cur
        dist = prev[np.arange(len(cand)), lens]
        ok = cand[dist <= FUZZY_TOLERANCE]
        if not len(ok):
            return None
        top = self.total[ok].max()
        return int(ok[self.total[ok] == top].min()) + 1

    def resolve(self, value: str, fuzzy: bool = True) -> Optional[int]:
        """Query leaf -> 1-based term id (None: trimmed)."""
        filtered = self.pipeline.run(value)
        if filtered is None:
            return None
        tid = self.host.term_lookup(filtered)
        if tid is None and fuzzy:
            tid = self.fuzzy_pick(filtered)
        return tid

    # -- search -----------------------------------------------------------

    def _postings(self, term_ids) -> dict:
        """term id -> (slots int64, tf float64) of its live postings."""
        need = np.zeros(len(self.df) + 1, dtype=bool)
        need[list(term_ids)] = True
        sel = np.nonzero(need[self._p_term])[0]
        terms = self._p_term[sel]
        order = np.argsort(terms, kind="stable")
        sel, terms = sel[order], terms[order]
        bounds = np.searchsorted(terms, np.asarray(sorted(term_ids)))
        out = {}
        for t, lo in zip(sorted(term_ids), bounds):
            hi = np.searchsorted(terms, t, side="right")
            rows = sel[lo:hi]
            out[t] = (self._p_slot[rows].astype(np.int64),
                      self._p_tf[rows].astype(np.float64))
        return out

    def _idf(self, algo: str, t: int) -> float:
        df = float(self.df[t - 1])
        n = float(self.n_docs)
        if algo == "TF-IDF":
            return math.log(n / df) + 1.0
        return math.log((n - df + 0.5) / (df + 0.5) + 1.0)

    def search_many(self, queries: list[str], algo: str = "BM25",
                    limit: int = 1000, fuzzy: bool = True
                    ) -> list[list[tuple[int, float]]]:
        """Per query its matches as (doc_id, score), best first
        (ties: lowest doc id), cut at ``limit``."""
        parsed = []
        tokens: dict[str, Optional[int]] = {}
        for q in queries:
            root = parse_query(q)
            leaves = list(_leaves(root)) if root is not None else []
            for v in leaves:
                if v not in tokens:
                    tokens[v] = self.resolve(v, fuzzy)
            parsed.append((root, leaves))
        live_ids = {t for t in tokens.values() if t is not None}
        postings = self._postings(live_ids) if live_ids else {}
        out = []
        for root, leaves in parsed:
            if root is None:
                out.append([])
                continue
            docs = _evaluate(root, tokens, postings)
            in_docs = np.zeros(len(self.doc_ids), dtype=bool)
            in_docs[docs] = True
            # One contribution per distinct filtered token, as the
            # engine's token set holds each query value once.
            hit_slots, parts = [], []
            seen = set()
            for v in leaves:
                key = self.pipeline.run(v)
                t = tokens[v]
                if t is None or key in seen:
                    continue
                seen.add(key)
                slots, tf = postings[t]
                hit = in_docs[slots]
                ltf = np.log(tf[hit] + 1.0)
                idf = self._idf(algo, t)
                if algo == "TF-IDF":
                    part = ltf * idf
                else:
                    dl = self.doc_len[slots[hit]]
                    part = ltf / (ltf + _K1 * (1.0 - _B + _B * dl / self.adl)
                                  ) * idf
                hit_slots.append(slots[hit])
                parts.append(part)
            if not hit_slots:
                out.append([])
                continue
            uniq, inv = np.unique(np.concatenate(hit_slots),
                                  return_inverse=True)
            score = np.bincount(inv, weights=np.concatenate(parts))
            ids = self.doc_ids[uniq]
            keep = score > 0.0
            score, ids = score[keep], ids[keep]
            order = np.lexsort((ids, -score))[:limit]
            out.append(list(zip(ids[order].tolist(),
                                score[order].tolist())))
        return out


def _leaves(root):
    stack = [root]
    while stack:
        e = stack.pop()
        if e.is_operator:
            stack.extend(reversed(e.elements))
        else:
            yield e.value


def _evaluate(e, tokens, postings) -> np.ndarray:
    """Sorted unique document slots matching expression ``e``."""
    if not e.is_operator:
        t = tokens[e.value]
        if t is None:
            return np.zeros(0, dtype=np.int64)
        return np.sort(postings[t][0])
    left = _evaluate(e.elements[0], tokens, postings)
    right = _evaluate(e.elements[1], tokens, postings)
    if e.type == EXPR_OP_AND:
        return np.intersect1d(left, right, assume_unique=True)
    if e.type == EXPR_OP_OR:
        return np.union1d(left, right)
    if e.type == EXPR_OP_NOT:
        return np.setdiff1d(left, right, assume_unique=True)
    raise ValueError(f"unknown operator {e.type}")


def compare_results(got, want, limit: int, rel: float = 1e-4
                    ) -> Optional[str]:
    """None when ``got`` (engine) agrees with ``want`` (the reference's
    full ranked list), else a description of the first difference.

    Doc sets must be equal except for ties at the limit-th place, and
    every returned score must be within ``rel`` of the reference's."""
    want_score = dict(want)
    n_want = min(limit, len(want))
    if len(got) != n_want:
        return f"{len(got)} results, reference has {n_want}"
    for d, s in got:
        if d not in want_score:
            return f"doc {d} is not a match in the reference"
        w = want_score[d]
        if abs(s - w) > rel * abs(w):
            return f"doc {d}: score {s!r} vs reference {w!r}"
    if n_want:
        kth = want[n_want - 1][1]
        top = {d for d, _ in want[:n_want]}
        for d in top.symmetric_difference(d for d, _ in got):
            if abs(want_score[d] - kth) > rel * abs(kth):
                return f"doc {d} differs above the tie at place {n_want}"
    return None
