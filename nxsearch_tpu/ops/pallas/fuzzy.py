"""Pallas kernel (Triton route): fused Myers sweep + fuzzy pick.

The plain path (ops/levenshtein.py, vmapped ``myers_distances``) builds
an [M, W, 32] u32 Peq tensor in device memory -- 128 B per (query,
term) -- and then writes [M, W] int32 distances for the selection.
This kernel reads the vocabulary region once per query chunk and keeps
the Peq row, the DP column and the running pick in registers:

- Grid (term block, query chunk).  Each program owns a position-major
  [32, BLK] uint8 tile (row j holds byte j of BLK terms, so every row
  load is one coalesced read) and loops over its chunk's queries.
- Per query, the Myers steps run over term positions and stop at the
  tile's longest term; step j builds its Peq row from the query bytes
  (one compare per query byte), so nothing of size [W, 32] exists.
- The selection of ``select_best_ids`` (distance <= tolerance, live
  total > 0, highest total, lowest original id) is reduced inside the
  program to one (key, id) pair per (block, query); XLA takes the
  maximum over blocks.  Outputs are [blocks, M] instead of [M, W].

All DP arithmetic is int32 (the bit patterns of the u32 reference, and
its wrapping add); totals enter as an order-preserving int32 key
(u32 ^ 0x80000000), so the pick equals the reference exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

QUERY_WIDTH = 32        # query and term bytes per row (u32 DP column)
BLOCK_TERMS = 512       # terms per program (power of two)
QUERY_CHUNK = 8         # queries per program (power of two)
NUM_WARPS = 2
NUM_STAGES = 1

_NO_KEY = -(1 << 31)    # key of "no eligible term" (below every live key)
_NO_ID = (1 << 31) - 1


def _kernel(q_ref, ql_ref, voc_ref, vlen_ref, key_ref, ids_ref,
            okey_ref, oid_ref, *, tolerance: int):
    """q_ref int32[QC, 32], ql_ref int32[QC], voc_ref uint8[32, BLK],
    vlen_ref / key_ref / ids_ref int32[BLK]; writes okey_ref / oid_ref
    int32[1, QC]: per query the best key and its lowest id."""
    chunk = ql_ref.shape[0]
    blk = vlen_ref.shape[0]
    vlen = vlen_ref[...]
    key = key_ref[...]
    ids = ids_ref[...]
    vmax = jnp.max(vlen)
    slot = lax.broadcasted_iota(jnp.int32, (chunk,), 0)
    zeros = jnp.zeros((blk,), jnp.int32)
    one = jnp.int32(1)

    def one_query(m, carry):
        best_key, best_id = carry
        qlen = ql_ref[m]
        mask = jnp.where(qlen >= 32, jnp.int32(-1),
                         (one << jnp.minimum(qlen, 31)) - one)
        high = one << jnp.clip(qlen - 1, 0, 31)

        def step(j, state):
            pv, mv, score = state
            row = voc_ref[j, :].astype(jnp.int32)

            def match(i, acc):
                return acc | jnp.where(row == q_ref[m, i], one << i, 0)

            eq = lax.fori_loop(0, qlen, match, zeros)
            xv = eq | mv
            xh = (((eq & pv) + pv) ^ pv) | eq
            ph = mv | ~(xh | pv)
            mh = pv & xh
            active = j < vlen
            inc = ((ph & high) != 0).astype(jnp.int32)
            dec = ((mh & high) != 0).astype(jnp.int32)
            score = score + jnp.where(active, inc - dec, 0)
            ph = (ph << 1) | one
            mh = mh << 1
            pv = jnp.where(active, (mh | ~(xv | ph)) & mask, pv)
            mv = jnp.where(active, (ph & xv) & mask, mv)
            return pv, mv, score

        init = (jnp.full((blk,), mask, jnp.int32), zeros,
                jnp.full((blk,), qlen, jnp.int32))
        _, _, dist = lax.fori_loop(0, vmax, step, init)
        ok = (vlen > 0) & (dist <= tolerance) & (key > _NO_KEY) & (qlen > 0)
        bk = jnp.max(jnp.where(ok, key, _NO_KEY))
        bi = jnp.min(jnp.where(ok & (key == bk), ids, _NO_ID))
        return (jnp.where(slot == m, bk, best_key),
                jnp.where(slot == m, bi, best_id))

    best_key, best_id = lax.fori_loop(
        0, chunk, one_query,
        (jnp.full((chunk,), _NO_KEY, jnp.int32),
         jnp.full((chunk,), _NO_ID, jnp.int32)))
    okey_ref[0, :] = best_key
    oid_ref[0, :] = best_id


def _pad_to(x, n: int, axis: int, value=0):
    extra = n - x.shape[axis]
    if extra == 0:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, extra)
    return jnp.pad(x, pads, constant_values=value)


@functools.partial(
    jax.jit, static_argnames=("tolerance", "block", "chunk", "num_warps",
                              "num_stages", "interpret"))
def fuzzy_pick(vocab_t: jax.Array,     # uint8[32, W] position-major
               vocab_len: jax.Array,   # int32[W] (0 = padding row)
               term_total: jax.Array,  # uint32[W] clipped live totals
               term_ids: jax.Array,    # int32[W] original 0-based ids
               q_bytes: jax.Array,     # int32[M, 32] zero-padded
               q_len: jax.Array,       # int32[M] (0 = padding query)
               *, tolerance: int, block: int = BLOCK_TERMS,
               chunk: int = QUERY_CHUNK, num_warps: int = NUM_WARPS,
               num_stages: int = NUM_STAGES, interpret: bool = False):
    """int32[M]: per query the winning original term index, or -1.

    Same result as ``select_best_ids`` over ``myers_distances`` for
    every query (ops/levenshtein.py).  W and M need not be multiples of
    ``block`` / ``chunk``: both pad here (padding terms have length 0,
    padding queries length 0, and neither can be picked)."""
    w, m = vocab_t.shape[1], q_bytes.shape[0]
    w_pad = -(-w // block) * block
    m_pad = -(-m // chunk) * chunk
    voc = _pad_to(vocab_t, w_pad, 1)
    vlen = _pad_to(vocab_len.astype(jnp.int32), w_pad, 0)
    key = lax.bitcast_convert_type(
        term_total.astype(jnp.uint32) ^ jnp.uint32(0x80000000), jnp.int32)
    key = _pad_to(key, w_pad, 0, _NO_KEY)
    ids = _pad_to(term_ids.astype(jnp.int32), w_pad, 0, _NO_ID)
    qb = _pad_to(q_bytes.astype(jnp.int32), m_pad, 0)
    ql = _pad_to(q_len.astype(jnp.int32), m_pad, 0)
    n_blocks = w_pad // block
    out_shape = jax.ShapeDtypeStruct((n_blocks, m_pad), jnp.int32)
    okey, oid = pl.pallas_call(
        functools.partial(_kernel, tolerance=tolerance),
        grid=(n_blocks, m_pad // chunk),
        in_specs=[
            pl.BlockSpec((chunk, QUERY_WIDTH), lambda t, c: (c, 0)),
            pl.BlockSpec((chunk,), lambda t, c: (c,)),
            pl.BlockSpec((QUERY_WIDTH, block), lambda t, c: (0, t)),
            pl.BlockSpec((block,), lambda t, c: (t,)),
            pl.BlockSpec((block,), lambda t, c: (t,)),
            pl.BlockSpec((block,), lambda t, c: (t,)),
        ],
        out_specs=[pl.BlockSpec((1, chunk), lambda t, c: (t, c))] * 2,
        out_shape=[out_shape, out_shape],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages),
        interpret=interpret,
        name="myers_fuzzy_pick",
    )(qb, ql, voc, vlen, key, ids)
    best = jnp.max(okey, axis=0)
    best_id = jnp.min(jnp.where(okey == best[None, :], oid, _NO_ID), axis=0)
    return jnp.where(best > _NO_KEY, best_id, -1)[:m]
