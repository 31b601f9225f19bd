"""Candidate and dense executors against a float64 reference.

These two XLA executors serve every query that the prefix and sliced
executors decline (masked queries over more than 32 terms, slice-wide
terms, very wide queries).  Both must agree with a plain float64
scorer over the same CSR snapshot -- same matched documents up to
ties at the k-th place, same scores -- across boolean programs, alive
bitmaps and both ranking algorithms; end to end, masked queries with
dense-row terms must agree with the candidate route.
"""

import math
import random

import jax.numpy as jnp
import numpy as np
import pytest

from nxsearch_tpu import Nxs, Params
from nxsearch_tpu.index.device import DeviceIndex
from nxsearch_tpu.ops.boolean import (EMPTY_LEAF_BIT, OP_AND, OP_ANDNOT,
                                      OP_OR, OP_PUSH)
from nxsearch_tpu.ops.executor import device_search, device_search_dense
from nxsearch_tpu.reference import ReferenceIndex, compare_results

K1, B = 1.2, 0.75


def make_index(rng, n_slots=2048, n_terms=6, max_len=900, p_pad=8192):
    """Random slot-sorted CSR: (arrays for the executors, numpy copy)."""
    lens = [rng.randint(0, max_len) for _ in range(n_terms)]
    ps = np.zeros(p_pad, np.int32)
    pf = np.zeros(p_pad, np.float32)
    starts, pos = [], 0
    for n in lens:
        starts.append(pos)
        g = np.random.default_rng(rng.randint(0, 1 << 30))
        ps[pos: pos + n] = np.sort(g.choice(n_slots, size=n, replace=False))
        pf[pos: pos + n] = np.log(g.integers(1, 6, n) + 1.0)
        pos += n
    dlen = np.random.default_rng(7).integers(5, 60, n_slots) \
        .astype(np.float32)
    alive = np.ones(n_slots, bool)
    alive[rng.randint(0, n_slots - 1)] = False
    q_pad = 8
    qs = np.zeros(q_pad, np.int32)
    ql = np.zeros(q_pad, np.int32)
    qi = np.zeros(q_pad, np.float32)
    qs[:n_terms] = starts
    ql[:n_terms] = lens
    qi[:n_terms] = [0.3 + 0.2 * i for i in range(n_terms)]
    host = dict(ps=ps, pf=pf, dlen=dlen, alive=alive, qs=qs, ql=ql, qi=qi)
    amask = np.packbits(alive, bitorder="little").view(np.uint32)
    dev = (jnp.asarray(ps), jnp.asarray(pf), jnp.asarray(dlen),
           jnp.asarray(amask), jnp.asarray(qs), jnp.asarray(ql),
           jnp.asarray(qi))
    return dev, host


def reference_topk(h, prog, use_mask, algo, adl, k):
    """float64 scores of the live matches, best first (ties: slot)."""
    sets, score = [], {}
    for t in range(len(h["qs"])):
        lo, n = int(h["qs"][t]), int(h["ql"][t])
        slots = h["ps"][lo: lo + n].astype(np.int64)
        sets.append(set(slots.tolist()))
        ltf = h["pf"][lo: lo + n].astype(np.float64)
        idf = float(h["qi"][t])
        if algo == 0:
            dl = h["dlen"][slots].astype(np.float64)
            part = ltf / (ltf + K1 * (1.0 - B + B * dl / adl)) * idf
        else:
            part = ltf * idf
        for s, p in zip(slots.tolist(), part.tolist()):
            score[s] = score.get(s, 0.0) + p
    if use_mask:
        stack = []
        for op, arg in prog:
            if op == OP_PUSH:
                stack.append(set() if arg == EMPTY_LEAF_BIT else sets[arg])
            else:
                b, a = stack.pop(), stack.pop()
                stack.append({OP_AND: a & b, OP_OR: a | b,
                              OP_ANDNOT: a - b}[op])
        keep = stack[-1]
    else:
        keep = set().union(*sets)
    ranked = sorted(((s, v) for s, v in score.items()
                     if s in keep and h["alive"][s] and v > 0),
                    key=lambda x: (-x[1], x[0]))
    return ranked


def as_pairs(scores, slots):
    return [(int(s), float(v)) for v, s in
            zip(np.asarray(scores), np.asarray(slots)) if v > 0]


PROGRAMS = [
    (False, [(OP_PUSH, 0)]),                          # dummy (pure OR)
    (True, [(OP_PUSH, 0), (OP_PUSH, 1), (OP_AND, 0)]),
    (True, [(OP_PUSH, 0), (OP_PUSH, 1), (OP_ANDNOT, 0)]),
    (True, [(OP_PUSH, 0), (OP_PUSH, 2), (OP_OR, 0),
            (OP_PUSH, 1), (OP_AND, 0)]),
    (True, [(OP_PUSH, 0), (OP_PUSH, EMPTY_LEAF_BIT), (OP_ANDNOT, 0)]),
]


def _program(prog):
    ops = np.zeros(16, np.int32)
    args = np.zeros(16, np.int32)
    for j, (o, a) in enumerate(prog):
        ops[j], args[j] = o, a
    return jnp.asarray(ops), jnp.asarray(args)


def _run_both(dev, prog, use_mask, algo, k, n_slots, budget):
    ps, pf, dlen, amask, qs, ql, qi = dev
    ops, args = _program(prog)
    adl = jnp.float32(30.0)
    cand = device_search(ps, pf, dlen, amask, qs, ql, qi, adl, ops, args,
                         budget=budget, k=k, algo=algo, use_mask=use_mask,
                         depth=4)
    dense = device_search_dense(ps, pf, dlen, amask, qs, ql, qi, adl,
                                ops if use_mask else None,
                                args if use_mask else None,
                                budget=budget, k=k, algo=algo,
                                n_slots=n_slots, use_mask=use_mask,
                                depth=4)
    return as_pairs(*cand), as_pairs(*dense)


@pytest.mark.parametrize("algo", [0, 1])
@pytest.mark.parametrize("prog_i", range(len(PROGRAMS)))
def test_candidate_and_dense_match_float64(algo, prog_i):
    rng = random.Random(41 + prog_i)
    dev, host = make_index(rng)
    use_mask, prog = PROGRAMS[prog_i]
    want = reference_topk(host, prog, use_mask, algo, 30.0, 64)
    cand, dense = _run_both(dev, prog, use_mask, algo, 64, 2048, 8192)
    assert want
    for name, got in (("candidate", cand), ("dense", dense)):
        err = compare_results(got, want, 64, 1e-5)
        assert err is None, (name, err)


@pytest.fixture
def dense_row_index(tmp_path):
    """An index whose head terms have dense device rows."""
    saved = DeviceIndex.DENSE_DF_DIV
    DeviceIndex.DENSE_DF_DIV = 4
    rng = np.random.default_rng(11)
    words = [f"t{i:03d}" for i in range(60)]
    probs = 1.0 / (np.arange(60) + 3.0)
    probs /= probs.sum()
    nxs = Nxs(str(tmp_path))
    try:
        idx = nxs.index_create("h")
        idx.add_many([(i + 1, " ".join(rng.choice(
            words, size=max(3, int(rng.poisson(25))), p=probs)))
            for i in range(500)])
        idx.search("t001")
        assert idx.dev.dense_row_of, "expected dense rows at DIV=4"
        yield idx
    finally:
        nxs.close()
        DeviceIndex.DENSE_DF_DIV = saved


@pytest.mark.parametrize("algo", ["BM25", "TF-IDF"])
@pytest.mark.parametrize("use_mask", [False, True], ids=["or", "masked"])
def test_dense_row_queries_match_references(dense_row_index, algo,
                                            use_mask):
    """Queries over dense-row terms (the sliced hybrids) agree with the
    candidate route and with the float64 reference."""
    import nxsearch_tpu.search as S

    idx = dense_row_index
    sp = Params().set_uint("limit", 30).set_str("algo", algo)
    queries = (["t000 AND t001", "t002 AND NOT t000",
                "(t000 OR t007) AND t003"] if use_mask else
               ["t000 t001 t040", "t000 t002", "t001 t003 t050"])
    ref = ReferenceIndex(idx.host, idx.pipeline)
    want = ref.search_many(queries, algo=algo, limit=10 ** 9)
    for q, w in zip(queries, want):
        got = list(idx.search(q, sp))
        saved = S._use_sliced
        S._use_sliced = lambda p, s, d: False
        try:
            cand = list(idx.search(q, sp))
        finally:
            S._use_sliced = saved
        assert w
        for name, res in (("routed", got), ("candidate", cand)):
            err = compare_results(res, w, 30, 1e-5)
            assert err is None, (q, name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", [0, 1])
def test_candidate_and_dense_on_card(gpu, algo):
    """At a real width (1M slots, ~2M postings) on the card, both
    executors agree with the float64 reference."""
    rng = random.Random(5)
    n_slots = 1 << 20
    dev, host = make_index(rng, n_slots=n_slots, n_terms=6,
                           max_len=400_000, p_pad=1 << 22)
    prog = PROGRAMS[3][1]
    for use_mask in (False, True):
        want = reference_topk(host, prog, use_mask, algo, 30.0, 1000)
        cand, dense = _run_both(dev, prog, use_mask, algo, 1024, n_slots,
                                1 << 22)
        for name, got in (("candidate", cand), ("dense", dense)):
            err = compare_results(got, want, 1024, 1e-5)
            assert err is None, (name, use_mask, err)


def test_reference_idf_matches_host_formula():
    """The reference's BM25 idf is the ranking.c formula."""
    from nxsearch_tpu.ops.scoring import ALGO_BM25, host_idf
    ref = ReferenceIndex.__new__(ReferenceIndex)
    ref.df = np.asarray([3, 90], np.int64)
    ref.n_docs = 100
    for t, df in ((1, 3), (2, 90)):
        assert ref._idf("BM25", t) == pytest.approx(
            host_idf(ALGO_BM25, 100, df), rel=1e-12)
        assert ref._idf("TF-IDF", t) == pytest.approx(
            math.log(100 / df) + 1.0, rel=1e-12)
