"""Fuzzy matching: Myers bit-parallel DP parity + selection behavior.

The device path must compute exact Levenshtein distances (property-
tested against the single-row Wagner-Fischer reference implementation,
levdist.c semantics) and the lookup must select the most-popular term
within tolerance 2, host and device paths agreeing.
"""

import functools
import random
import string

import jax.numpy as jnp
import numpy as np
import pytest

import nxsearch_tpu.fuzzy as fuzzy_mod
from nxsearch_tpu import Nxs
from nxsearch_tpu.fuzzy import FuzzyMatcher, levdist
from nxsearch_tpu.ops.levenshtein import (MAX_TERM_BYTES,
                                          fuzzy_best_region, myers_distances)


def pack_vocab(words):
    vb = np.zeros((len(words), MAX_TERM_BYTES), dtype=np.uint8)
    vl = np.zeros(len(words), dtype=np.int32)
    for i, w in enumerate(words):
        enc = w.encode()
        vb[i, : len(enc)] = np.frombuffer(enc, dtype=np.uint8)
        vl[i] = len(enc)
    return jnp.asarray(vb), jnp.asarray(vl)


def pack_query(q):
    enc = q.encode()
    qb = np.zeros(MAX_TERM_BYTES, dtype=np.uint8)
    qb[: len(enc)] = np.frombuffer(enc, dtype=np.uint8)
    return jnp.asarray(qb), jnp.int32(len(enc))


def test_myers_exact_small_cases():
    vocab = ["kitten", "sitting", "dog", "dogs", "doggy", "cat", "",
             "a", "ab", "abcdefghijklmnopqrstuvwxyz012345"]
    vocab = [v for v in vocab if v]
    vb, vl = pack_vocab(vocab)
    for q in ("kitten", "dog", "smitten", "x", "abcdefghijklmnop"):
        qb, ql = pack_query(q)
        dists = np.asarray(myers_distances(vb, vl, qb, ql))
        for i, w in enumerate(vocab):
            assert dists[i] == levdist(q.encode(), w.encode()), (q, w)


def test_myers_property_fuzz():
    rng = random.Random(13)
    alphabet = string.ascii_lowercase[:6]
    vocab = ["".join(rng.choice(alphabet)
                     for _ in range(rng.randint(1, MAX_TERM_BYTES)))
             for _ in range(200)]
    vb, vl = pack_vocab(vocab)
    for _ in range(30):
        q = "".join(rng.choice(alphabet)
                    for _ in range(rng.randint(1, MAX_TERM_BYTES)))
        qb, ql = pack_query(q)
        dists = np.asarray(myers_distances(vb, vl, qb, ql))
        for i, w in enumerate(vocab):
            want = levdist(q.encode(), w.encode())
            assert dists[i] == want, (q, w, dists[i], want)


def test_fuzzy_best_selection():
    vocab = ["dog", "dig", "dug", "cat"]
    vb, vl = pack_vocab(vocab)
    ids = jnp.arange(len(vocab), dtype=jnp.int32)

    def pick(query, totals):
        qb, ql = pack_query(query)
        return int(fuzzy_best_region(
            vb, vl, jnp.asarray(np.array(totals, dtype=np.uint32)), ids,
            qb[None], ql[None], jnp.int32(0), W=len(vocab), tolerance=2,
            kernel=False)[0])

    # dig (50) beats dog/dug (5); cat is within distance 2? c-a-t vs
    # d-a-g = 2 substitutions => eligible with total 100 -> wins.
    assert pick("dag", [5, 50, 5, 100]) == 3
    # Zero-total terms are never selected.
    assert pick("dag", [5, 50, 5, 0]) == 1
    # Ties on the total pick the lowest id.
    assert pick("dag", [7, 7, 7, 0]) == 0
    # Nothing within tolerance.
    assert pick("zzzzzzzz", [5, 50, 5, 0]) == -1


def test_fuzzy_end_to_end(tmp_path):
    nxs = Nxs(str(tmp_path))
    try:
        idx = nxs.index_create("fz")
        idx.add(1, "dog dog dog popular")
        idx.add(2, "dig rare")
        # "dag" is distance 1 from both dog and dig; dog is more popular.
        r = idx.search("dag")
        assert {d for d, _ in r} == {1}
        # fuzzymatch off: no results.
        from nxsearch_tpu import Params
        r = idx.search("dag", Params().set_bool("fuzzymatch", False))
        assert r.count == 0
        # Removing the popular doc flips the winner.
        idx.remove(1)
        r = idx.search("dag")
        assert {d for d, _ in r} == {2}
    finally:
        nxs.close()


def _random_vocab(rng, n, alphabet, near=()):
    """``n`` random terms of 1..32 bytes, with ``near`` spliced in at
    random rows (terms within a small edit distance of the queries)."""
    words = ["".join(rng.choice(alphabet)
                     for _ in range(rng.randint(1, MAX_TERM_BYTES)))
             for _ in range(n)]
    for w in near:
        words[rng.randrange(n)] = w
    return words


def _mutate(rng, q, alphabet, edits):
    w = list(q)
    for _ in range(edits):
        op = rng.randrange(3)
        if op == 0 and len(w) > 1:
            del w[rng.randrange(len(w))]
        elif op == 1 and len(w) < MAX_TERM_BYTES:
            w.insert(rng.randrange(len(w) + 1), rng.choice(alphabet))
        else:
            w[rng.randrange(len(w))] = rng.choice(alphabet)
    return "".join(w)


def _host_pick(q, words, totals, tol):
    best = -1
    for i, w in enumerate(words):
        if totals[i] > 0 and levdist(q.encode(), w.encode()) <= tol and (
                best < 0 or totals[i] > totals[best]):
            best = i
    return best


@pytest.mark.parametrize("width", [512, 300], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("q_len", [1, 3, 8, 17, 30, 32])
def test_kernel_matches_jnp(q_len, width):
    """The fused Pallas sweep (interpret mode) picks exactly the term
    the jnp Myers sweep and the host levdist pick, for region widths
    on and off the kernel's block grid, with a padding query row."""
    from nxsearch_tpu.ops.levenshtein import fuzzy_best_region
    from nxsearch_tpu.ops.pallas.fuzzy import BLOCK_TERMS, fuzzy_pick

    assert (width % BLOCK_TERMS == 0) == (width == 512)
    rng = random.Random(q_len * 1000 + width)
    alphabet = string.ascii_lowercase[:4]
    queries = ["".join(rng.choice(alphabet) for _ in range(q_len))
               for _ in range(5)]
    near = [_mutate(rng, q, alphabet, e) for q in queries for e in (0, 1, 2, 3)]
    words = _random_vocab(rng, width, alphabet, near)
    vb, vl = pack_vocab(words)
    ids = jnp.arange(width, dtype=jnp.int32)
    qb = np.zeros((len(queries) + 1, MAX_TERM_BYTES), np.uint8)  # + pad row
    ql = np.zeros(len(queries) + 1, np.int32)
    for i, q in enumerate(queries):
        qb[i, :q_len] = np.frombuffer(q.encode(), np.uint8)
        ql[i] = q_len
    for trial in range(3):
        totals = np.asarray([rng.randint(0, 3) for _ in words], np.uint32)
        got = np.asarray(fuzzy_pick(
            vb.T, vl, jnp.asarray(totals), ids, jnp.asarray(qb),
            jnp.asarray(ql), tolerance=2, interpret=True))
        ref = np.asarray(fuzzy_best_region(
            vb, vl, jnp.asarray(totals), ids, jnp.asarray(qb),
            jnp.asarray(ql), jnp.int32(0), W=width, tolerance=2,
            kernel=False))
        assert got[-1] == -1   # zero-length padding query picks nothing
        np.testing.assert_array_equal(got[:-1], ref[:-1])
        want = [_host_pick(q, words, totals, 2) for q in queries]
        # Ties on the total pick the lowest id in every path.
        assert list(got[:-1]) == want, (trial, queries)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_fuzzy_route_follows_platform(tmp_path, monkeypatch, platform):
    """The fused kernel serves the sweep on the GPU only; elsewhere the
    jnp path does, with the row-major snapshot.  Both agree with the
    host path (the GPU route runs the kernel interpreted here)."""
    from nxsearch_tpu.ops import levenshtein
    monkeypatch.setattr(fuzzy_mod, "_platform", lambda: platform)
    monkeypatch.setattr(fuzzy_mod, "_DEVICE_THRESHOLD", 1)
    monkeypatch.setattr(
        levenshtein, "fuzzy_best_region",
        functools.partial(levenshtein.fuzzy_best_region, interpret=True))
    rng = random.Random(3)
    words = sorted({"".join(rng.choice("abcde")
                            for _ in range(rng.randint(3, 7)))
                    for _ in range(300)})
    nxs = Nxs(str(tmp_path))
    try:
        idx = nxs.index_create("route")
        idx.add_many([(i + 1, f"{w} {w}") for i, w in enumerate(words)])
        idx.search("x")           # sync the host index
        dev = FuzzyMatcher(idx.host)
        probes = [_mutate(rng, rng.choice(words), "abcdef", 1)
                  for _ in range(12)]
        dev.prefetch(probes)
        assert dev._kernel == (platform == "gpu")
        want_shape = (MAX_TERM_BYTES, dev._t_pad) if dev._kernel \
            else (dev._t_pad, MAX_TERM_BYTES)
        assert dev._dev_bytes.shape == want_shape
        monkeypatch.setattr(fuzzy_mod, "_DEVICE_THRESHOLD", 1 << 30)
        host = FuzzyMatcher(idx.host)
        for probe in probes:
            assert dev.lookup(probe) == host.lookup(probe), probe
    finally:
        nxs.close()


@pytest.mark.gpu
def test_kernel_matches_jnp_on_card(gpu):
    """Compiled for the card at a real width (the 1M-vocabulary band):
    the kernel's picks equal the jnp sweep's exactly."""
    from nxsearch_tpu.ops.levenshtein import fuzzy_best_region

    rng = np.random.default_rng(0)
    width, m = 1 << 20, 64
    lens = rng.integers(3, 12, width).astype(np.int32)
    vb = rng.integers(97, 101, (width, MAX_TERM_BYTES)).astype(np.uint8)
    vb[np.arange(MAX_TERM_BYTES)[None, :] >= lens[:, None]] = 0
    totals = rng.integers(0, 50, width).astype(np.uint32)
    ids = rng.permutation(width).astype(np.int32)
    qb = np.zeros((m, MAX_TERM_BYTES), np.uint8)
    ql = rng.integers(1, 12, m).astype(np.int32)
    for i in range(m):
        src = vb[rng.integers(width)]
        qb[i, : ql[i]] = src[: ql[i]]
        qb[i, 0] = 100
    args = (jnp.asarray(lens), jnp.asarray(totals), jnp.asarray(ids),
            jnp.asarray(qb), jnp.asarray(ql), jnp.int32(0))
    got = fuzzy_best_region(jnp.asarray(np.ascontiguousarray(vb.T)), *args,
                            W=width, tolerance=2, kernel=True)
    ref = fuzzy_best_region(jnp.asarray(vb), *args, W=width, tolerance=2,
                            kernel=False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert (np.asarray(ref) >= 0).any()


def test_device_and_host_paths_agree(tmp_path, monkeypatch):
    rng = random.Random(99)
    words = list({
        "".join(rng.choice(string.ascii_lowercase[:8])
                for _ in range(rng.randint(3, 9)))
        for _ in range(600)})
    nxs = Nxs(str(tmp_path))
    try:
        idx = nxs.index_create("agree")
        for i in range(0, len(words), 50):
            idx.add_many([(i + j + 1, " ".join(words[i + j: i + j + 1] * 2))
                          for j in range(min(50, len(words) - i))])
        matcher_host = FuzzyMatcher(idx.host)
        monkeypatch.setattr(fuzzy_mod, "_DEVICE_THRESHOLD", 1)
        matcher_dev = FuzzyMatcher(idx.host)
        probes = ["".join(rng.choice(string.ascii_lowercase[:8])
                          for _ in range(rng.randint(3, 9)))
                  for _ in range(60)]
        for probe in probes:
            assert matcher_host.lookup(probe) == matcher_dev.lookup(probe), \
                probe
        # Batched prefetch (length-region grouped dispatches) must
        # agree with per-probe lookup.
        matcher_batch = FuzzyMatcher(idx.host)
        matcher_batch.prefetch(probes)
        for probe in probes:
            assert matcher_batch.lookup(probe) == \
                matcher_host.lookup(probe), probe
    finally:
        nxs.close()


@pytest.mark.parametrize("kernel", [False, True], ids=["jnp", "kernel"])
def test_query_rows_ladder(kernel):
    """The kernel pads a dispatch to its query chunk or to the whole
    batch (two executables per band); the jnp sweep takes rows as-is."""
    from nxsearch_tpu.ops.pallas.fuzzy import QUERY_CHUNK
    rows = {n: fuzzy_mod._query_rows(n, kernel)
            for n in (1, QUERY_CHUNK, QUERY_CHUNK + 1,
                      fuzzy_mod._KERNEL_BATCH)}
    if kernel:
        assert set(rows.values()) == {QUERY_CHUNK, fuzzy_mod._KERNEL_BATCH}
        assert all(r >= n and r % QUERY_CHUNK == 0 for n, r in rows.items())
    else:
        assert all(r == n for n, r in rows.items())
