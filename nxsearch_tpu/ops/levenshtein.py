"""Batched Levenshtein over the vocabulary: bit-parallel Myers.

The reference resolves fuzzy query tokens with a BK-tree pruned by the
triangle inequality, computing Wagner-Fischer row DP per visited node
(src/algo/bktree.c:219, src/algo/levdist.c:67).  Metric-tree pointer
chasing does not map onto a wide vector machine; the device
replacement is brute force over *every* term of the length band, made
cheap with Myers' bit-parallel algorithm (G. Myers, JACM 1999; Hyyrö
2001 formulation): for a query of at most 32 bytes the whole DP column
fits one uint32, so each term costs L=32 fused elementwise u32 steps
-- a [T]-wide sweep with no data-dependent control flow.

Distances are over UTF-8 bytes, like levdist.c operating on char.
Selection follows idxterm_fuzzysearch's intent: among terms within
tolerance with a live total > 0, the highest total wins (ties: lowest
term ID); see fuzzy.py for the note on the reference's traversal
artifact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

MAX_QUERY_BYTES = 32   # query pattern must fit the u32 bit-parallel DP
MAX_TERM_BYTES = 32    # vocab snapshot width; longer terms -> host path


@functools.partial(jax.jit, static_argnames=())
def myers_distances(vocab_bytes: jax.Array,  # uint8[T, L] zero-padded
                    vocab_len: jax.Array,    # int32[T]
                    q_bytes: jax.Array,      # uint8[Lq<=32] zero-padded
                    q_len: jax.Array,        # int32 scalar
                    ) -> jax.Array:
    """Exact Levenshtein distance of the query to every vocab term.

    Returns int32[T]; entries for vocab_len == 0 are meaningless.
    """
    n_terms, width = vocab_bytes.shape
    m = q_len.astype(jnp.uint32)

    # Peq matrix: for every (term, position) the bitmask of query
    # positions matching that character.  One fused [T, L, 32] compare
    # + weighted sum, exact in integer arithmetic.
    shifts = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    q_valid = jnp.arange(32) < q_len
    # eq[t, j, i] = vocab[t, j] == q[i] (and i < q_len)
    eq = (vocab_bytes[:, :, None] == q_bytes[None, None, :]) & \
        q_valid[None, None, :]
    peq = jnp.sum(eq.astype(jnp.uint32) * shifts[None, None, :],
                  axis=2)  # uint32[T, L]

    full = jnp.uint32(0xFFFFFFFF)
    # Shift amounts must stay < 32 (XLA shift semantics); m == 32 takes
    # the full-mask branch.
    mask_m = jnp.where(m >= 32, full,
                       (jnp.uint32(1) << jnp.minimum(m, 31)) - jnp.uint32(1))
    high_bit = jnp.uint32(1) << jnp.minimum(m - jnp.uint32(1), 31)

    pv0 = jnp.full((n_terms,), mask_m, jnp.uint32)
    mv0 = jnp.zeros((n_terms,), jnp.uint32)
    score0 = jnp.full((n_terms,), q_len, jnp.int32)

    def step(carry, xs):
        pv, mv, score = carry
        eq_j, j = xs
        active = j < vocab_len  # beyond the term's end: freeze state

        xv = eq_j | mv
        xh = (((eq_j & pv) + pv) ^ pv) | eq_j
        ph = mv | ~(xh | pv)
        mh = pv & xh

        inc = ((ph & high_bit) != 0).astype(jnp.int32)
        dec = ((mh & high_bit) != 0).astype(jnp.int32)
        new_score = score + jnp.where(active, inc - dec, 0)

        ph = (ph << 1) | jnp.uint32(1)
        mh = mh << 1
        new_pv = (mh | ~(xv | ph)) & mask_m
        new_mv = (ph & xv) & mask_m

        pv = jnp.where(active, new_pv, pv)
        mv = jnp.where(active, new_mv, mv)
        return (pv, mv, new_score), None

    (pv, mv, score), _ = lax.scan(
        step, (pv0, mv0, score0),
        (peq.T, jnp.arange(width, dtype=jnp.int32)))
    return score


def select_best_ids(dist, vocab_len, term_total, term_ids, tolerance):
    """Pick the winning term of a PERMUTED vocab region.

    Eligible: distance <= tolerance and live total > 0.  Highest total
    wins; the length-sorted snapshot (fuzzy.py) no longer encodes term
    age in row order, so ties pick the lowest ORIGINAL 0-based term
    index, carried explicitly in ``term_ids`` (padding rows:
    INT32_MAX).  Exact without 64-bit arithmetic: one max reduction
    over totals, then a min over ids at that total.  Returns the
    winning original index, or -1."""
    eligible = (vocab_len > 0) & (dist <= tolerance) & (term_total > 0)
    best_total = jnp.max(jnp.where(eligible, term_total, jnp.uint32(0)))
    at_best = eligible & (term_total == best_total)
    big = jnp.int32(0x7FFFFFFF)
    best_id = jnp.min(jnp.where(at_best, term_ids, big))
    found = (best_total > 0) & (best_id < big)
    return jnp.where(found, best_id, -1).astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("W", "tolerance", "kernel", "interpret"))
def fuzzy_best_region(vocab: jax.Array,      # [32, T_pad] or [T_pad, L]
                      vocab_len: jax.Array,  # int32[T_pad]
                      term_total: jax.Array,  # uint32[T_pad]
                      term_ids: jax.Array,   # int32[T_pad] original ids
                      q_bytes: jax.Array,    # uint8[M, 32]
                      q_len: jax.Array,      # int32[M]
                      lo: jax.Array,         # int32: region start row
                      *, W: int, tolerance: int, kernel: bool,
                      interpret: bool = False):
    """Batched fuzzy match over a contiguous vocab region [lo, lo+W).

    The device snapshot is LENGTH-SORTED (fuzzy.py), so the rows whose
    byte length lies within the tolerance band of the query length
    form one contiguous region -- the device equivalent of the
    BK-tree's triangle-inequality pruning at its cheapest
    (|len(q) - len(t)| <= tolerance, src/algo/bktree.c:219).  Sweeping
    a SUPERSET region is always correct: rows outside the band have
    distance > tolerance by construction and are discarded by the
    selection, so ``lo``/``W`` may be clamped or padded freely.

    ``kernel`` selects the fused Pallas sweep (ops/pallas/fuzzy.py),
    which takes the position-major [32, T_pad] layout; otherwise the
    vmapped jnp sweep runs over the row-major [T_pad, L] matrix.
    ``interpret`` runs the kernel in the Pallas interpreter (tests).
    """
    vl = lax.dynamic_slice(vocab_len, (lo,), (W,))
    tt = lax.dynamic_slice(term_total, (lo,), (W,))
    ti = lax.dynamic_slice(term_ids, (lo,), (W,))
    if kernel:
        from .pallas.fuzzy import fuzzy_pick
        vb = lax.dynamic_slice(vocab, (0, lo), (vocab.shape[0], W))
        return fuzzy_pick(vb, vl, tt, ti, q_bytes, q_len,
                          tolerance=tolerance, interpret=interpret)
    vb = lax.dynamic_slice(vocab, (lo, 0), (W, vocab.shape[1]))
    dist = jax.vmap(
        lambda qb, ql: myers_distances(vb, vl, qb, ql))(q_bytes, q_len)
    return jax.vmap(select_best_ids,
                    in_axes=(0, None, None, None, None))(
        dist, vl, tt, ti, tolerance)

