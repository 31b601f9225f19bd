"""Boolean query algebra as packed-bitmap set operations on device.

The reference evaluates the query AST recursively over roaring64
bitmaps (src/query/search.c:118-174: AND/OR/ANDNOT in-place merges).
On the device the same algebra runs over *dense packed bitmaps*: one uint32
word per 32 document slots, elementwise AND / OR / AND-NOT on the device.

To avoid recompiling per query *shape*, the AST is lowered host-side to
a fixed-width postfix program (``compile_program``) interpreted on
device by a ``lax.scan`` over a small mask stack (``eval_program``):

    PUSH t   -- push term t's document bitmap (t == Q pushes the empty
                bitmap: the reference's unresolved-leaf empty set,
                search.c:133-141)
    AND/OR/ANDNOT -- pop two, push the combination
    NOP      -- padding

Program length and stack depth are static bucket sizes; the program
contents are data, so all queries with the same bucket reuse one
compiled executable.  Nesting is bounded by the reference's limit of
100 (search.c:70) and by the static stack depth here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

from ..errors import ErrorCode, NxsError
from ..query.ast import (EXPR_OP_AND, EXPR_OP_NOT, EXPR_OP_OR,
                         EXPR_VAL_TOKEN, Expr)

OP_NOP = 0
OP_PUSH = 1
OP_AND = 2
OP_OR = 3
OP_ANDNOT = 4

# Reference limit: query nesting <= 100 (search.c:70).  The device
# stack depth only needs to cover the *evaluation* stack of the postfix
# program, which for binary trees is bounded by the tree depth + 1;
# the executor picks a bucket size >= the program's actual need.
QUERY_NESTING_LIMIT = 100

_OP_FOR_EXPR = {
    EXPR_OP_AND: OP_AND,
    EXPR_OP_OR: OP_OR,
    EXPR_OP_NOT: OP_ANDNOT,
}


def compile_program(root: Expr, term_slot_of_token) -> tuple[np.ndarray,
                                                             np.ndarray, int]:
    """Lower the AST to a postfix program.

    ``term_slot_of_token(token) -> int`` maps a leaf's resolved token to
    its query-term row (the row in the term-mask matrix); unresolved
    leaves (token None) map to the empty row.

    Returns (ops int32[L], args int32[L], max_stack_depth).  The
    program is *not* padded; the caller pads to its bucket size.
    """
    ops: list[int] = []
    args: list[int] = []

    # Iterative postfix emission; stack entries are (expr, visited).
    stack: list[tuple[Expr, bool]] = [(root, False)]
    while stack:
        expr, visited = stack.pop()
        if expr.type == EXPR_VAL_TOKEN:
            ops.append(OP_PUSH)
            args.append(term_slot_of_token(expr.token))
            continue
        if visited:
            ops.append(_OP_FOR_EXPR[expr.type])
            args.append(0)
            continue
        stack.append((expr, True))
        # Children evaluated left then right (search.c evaluates
        # elements[0] first): push right first so left pops first.
        stack.append((expr.elements[1], False))
        stack.append((expr.elements[0], False))

    # Simulate to find the required stack depth.
    depth = max_depth = 0
    for op in ops:
        depth += 1 if op == OP_PUSH else -1
        max_depth = max(max_depth, depth)
    return (np.asarray(ops, dtype=np.int32),
            np.asarray(args, dtype=np.int32), max_depth)


def check_nesting(root: Expr) -> None:
    """Enforce the reference's recursion limit (search.c:66-75)."""
    def depth(expr: Expr, r: int) -> int:
        if r > QUERY_NESTING_LIMIT:
            raise NxsError(
                ErrorCode.LIMIT,
                f"query nesting limit reached ({QUERY_NESTING_LIMIT} levels)")
        if expr.type == EXPR_VAL_TOKEN:
            return r
        return max(depth(e, r + 1) for e in expr.elements)
    depth(root, 0)


def build_term_masks(slot, qid, valid, *, n_terms: int, n_words: int):
    """Scatter query-term postings into packed per-term doc bitmaps.

    Inputs are the flat gather plan of ops/scoring.flatten_ranges.
    Returns uint32[n_terms + 1, n_words]; the last row stays zero (the
    empty bitmap for unresolved leaves).  Each (term, slot) pair is
    unique in the postings, so scatter-add of distinct bits == OR.
    """
    word = slot >> 5
    bit = (jnp.uint32(1) << (slot & 31).astype(jnp.uint32))
    rows = jnp.where(valid, qid, n_terms)
    masks = jnp.zeros((n_terms + 1, n_words), jnp.uint32)
    masks = masks.at[rows, word].add(jnp.where(valid, bit, jnp.uint32(0)),
                                     mode="drop")
    # Re-zero the spill row: padded entries may have landed there.
    return masks.at[n_terms].set(jnp.uint32(0))


def eval_program(term_masks: jax.Array, ops: jax.Array, args: jax.Array,
                 *, depth: int = 8):
    """Interpret the postfix program over packed bitmaps.

    term_masks: uint32[Q+1, W]; ops/args: int32[L] (NOP-padded);
    ``depth`` is the static evaluation-stack bucket (>= the program's
    simulated max depth).  Returns the final uint32[W] document mask.
    """
    n_words = term_masks.shape[1]
    stack0 = jnp.zeros((depth, n_words), jnp.uint32)

    def step(carry, oparg):
        stack, sp = carry
        op, arg = oparg

        def do_nop(stack, sp):
            return stack, sp

        def do_push(stack, sp):
            row = lax.dynamic_index_in_dim(term_masks, arg, 0,
                                           keepdims=False)
            return lax.dynamic_update_index_in_dim(stack, row, sp, 0), sp + 1

        def do_binary(stack, sp, fn):
            a = lax.dynamic_index_in_dim(stack, sp - 2, 0, keepdims=False)
            b = lax.dynamic_index_in_dim(stack, sp - 1, 0, keepdims=False)
            out = fn(a, b)
            return (lax.dynamic_update_index_in_dim(stack, out, sp - 2, 0),
                    sp - 1)

        stack, sp = lax.switch(
            op,
            [
                do_nop,
                do_push,
                lambda s, p: do_binary(s, p, jnp.bitwise_and),
                lambda s, p: do_binary(s, p, jnp.bitwise_or),
                lambda s, p: do_binary(s, p, lambda a, b: a & ~b),
            ],
            stack, sp,
        )
        return (stack, sp), None

    (stack, _sp), _ = lax.scan(step, (stack0, jnp.int32(0)), (ops, args))
    return stack[0]


# Sentinel PUSH argument for an unresolved (empty-set) leaf in the
# presence-bits evaluator: any value >= 32 pushes constant False.
EMPTY_LEAF_BIT = 32


def eval_program_bits(present_bits: jax.Array, ops: jax.Array,
                      args: jax.Array, *, depth: int = 8) -> jax.Array:
    """Interpret the postfix program over per-candidate presence bits.

    The candidate-scoring executor aggregates, for every candidate
    document, a uint32 whose bit q says "query term q occurs in this
    document".  Boolean evaluation then needs no packed doc bitmaps at
    all: each leaf is a bit test and AND/OR/ANDNOT are elementwise
    boolean ops over the [B] candidate axis -- O(candidates) work
    instead of O(all documents).  Limited to 32 query terms; wider
    queries use the packed-bitmap path (eval_program).

    present_bits: uint32[B]; ops/args: int32[L] NOP-padded.
    Returns bool[B]: which candidates survive the boolean expression.
    """
    n = present_bits.shape[0]
    stack0 = jnp.zeros((depth, n), jnp.bool_)

    def step(carry, oparg):
        stack, sp = carry
        op, arg = oparg

        def do_nop(stack, sp):
            return stack, sp

        def do_push(stack, sp):
            shift = jnp.minimum(arg, 31).astype(jnp.uint32)
            bit = (present_bits >> shift) & 1
            row = jnp.where(arg >= EMPTY_LEAF_BIT, False,
                            bit.astype(jnp.bool_))
            return lax.dynamic_update_index_in_dim(stack, row, sp, 0), sp + 1

        def do_binary(stack, sp, fn):
            a = lax.dynamic_index_in_dim(stack, sp - 2, 0, keepdims=False)
            b = lax.dynamic_index_in_dim(stack, sp - 1, 0, keepdims=False)
            return (lax.dynamic_update_index_in_dim(stack, fn(a, b),
                                                    sp - 2, 0), sp - 1)

        return lax.switch(
            op,
            [
                do_nop,
                do_push,
                lambda s, p: do_binary(s, p, jnp.logical_and),
                lambda s, p: do_binary(s, p, jnp.logical_or),
                lambda s, p: do_binary(s, p, lambda a, b: a & ~b),
            ],
            stack, sp,
        ), None

    (stack, _sp), _ = lax.scan(step, (stack0, jnp.int32(0)), (ops, args))
    return stack[0]
