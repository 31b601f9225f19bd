"""Property test: the three boolean-program evaluators agree.

The same NOP-padded postfix program is interpreted by three backends:
the packed-bitmap device evaluator (``eval_program``), the per-candidate
presence-bits device evaluator (``eval_program_bits``), and the host
numpy twin used for delta docs (``search._eval_program_np``).  An
unpinned numpy twin is a parity risk; this pins all
three to each other over randomly generated valid programs.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nxsearch_tpu.ops.boolean import (
    EMPTY_LEAF_BIT,
    OP_AND,
    OP_ANDNOT,
    OP_NOP,
    OP_OR,
    OP_PUSH,
    eval_program,
    eval_program_bits,
)
from nxsearch_tpu.search import _eval_program_np

MAX_DEPTH = 8


def random_program(rng, n_terms: int, target_leaves: int):
    """A random valid postfix program: PUSH pushes, binaries pop two.

    Simulated stack depth stays within MAX_DEPTH (the static bucket
    used by the device evaluators) and the program ends with depth 1,
    exactly like compiler output.  ~1 in 8 leaves is the empty-set
    sentinel (an unresolved term).
    """
    ops, args = [], []
    depth = 0
    leaves = 0
    while leaves < target_leaves or depth > 1:
        can_push = leaves < target_leaves and depth < MAX_DEPTH
        can_binop = depth >= 2
        if can_push and (not can_binop or rng.random() < 0.55):
            arg = EMPTY_LEAF_BIT if rng.random() < 0.125 \
                else int(rng.integers(0, n_terms))
            ops.append(OP_PUSH)
            args.append(arg)
            depth += 1
            leaves += 1
        else:
            ops.append(int(rng.choice([OP_AND, OP_OR, OP_ANDNOT])))
            args.append(0)
            depth -= 1
    # NOP-pad to a bucketed length like the plan compiler does.
    pad = 4 - (len(ops) % 4 or 4)
    ops += [OP_NOP] * pad
    args += [0] * pad
    return (np.asarray(ops, dtype=np.int32),
            np.asarray(args, dtype=np.int32))


@pytest.mark.parametrize("seed", range(24))
def test_three_evaluators_agree(seed):
    rng = np.random.default_rng(seed)
    n_terms = int(rng.integers(1, 9))
    n_docs = int(rng.integers(1, 200))
    ops, args = random_program(rng, n_terms, int(rng.integers(1, 7)))

    present = rng.random((n_terms, n_docs)) < 0.3  # bool[R, n]

    # 1. Host numpy twin.
    got_np = _eval_program_np(present, ops, args)

    # 2. Presence-bits evaluator: bit q of doc d == present[q, d].
    bits = np.zeros(n_docs, dtype=np.uint32)
    for q in range(n_terms):
        bits |= present[q].astype(np.uint32) << q
    got_bits = np.asarray(eval_program_bits(
        jnp.asarray(bits), jnp.asarray(ops), jnp.asarray(args)))

    # 3. Packed-bitmap evaluator: row q is the doc bitmap of term q,
    #    row n_terms is the empty bitmap (EMPTY_LEAF_BIT >= n_terms
    #    lands there after clamping, mirroring the dense-path arg map).
    n_words = (n_docs + 31) // 32
    masks = np.zeros((n_terms + 1, n_words), dtype=np.uint32)
    for q in range(n_terms):
        docs = np.nonzero(present[q])[0]
        np.bitwise_or.at(masks[q], docs >> 5,
                         np.uint32(1) << (docs & 31).astype(np.uint32))
    mask_args = np.where((ops == OP_PUSH) & (args >= n_terms),
                         n_terms, args).astype(np.int32)
    out_words = np.asarray(eval_program(
        jnp.asarray(masks), jnp.asarray(ops), jnp.asarray(mask_args)))
    got_masks = ((out_words[np.arange(n_docs) >> 5]
                  >> (np.arange(n_docs) & 31)) & 1).astype(bool)

    np.testing.assert_array_equal(got_np, got_bits)
    np.testing.assert_array_equal(got_np, got_masks)
