"""Doc-sharded search over a JAX device mesh.

The reference's only parallelism is multi-process index sharing on one
node via mmap + flock (SURVEY §2.8).  The device scale-out story is
*document sharding*: the doc-slot space is partitioned contiguously
across the mesh's ``docs`` axis, each GPU holds its shard of the
postings (its rows of every term's posting list) and its shard of the
document table, and a query executes as:

    shard-local score -> boolean mask -> shard-local top-k
                                              (pure local compute)
    -> all_gather of the per-shard top-k      (one small collective)
    -> global top-k merge                     (replicated)

The only cross-device traffic is ``n_dev * k`` candidate (score, slot)
pairs -- the collective (NCCL over NVLink on a multi-GPU host) never
moves the postings.  The cards of one host reach each other all to
all at one rate, so the mesh is 1-D.  This mirrors the classic
distributed-search scatter/gather but expressed as a single SPMD
program under ``shard_map``.

The shard-local body picks the same executors as a single device
(ops/executor.py), INCLUDING the flagship serving plan: pure-OR BM25
queries run the impact-prefix executor per shard
(``sharded_search_prefix_batch`` -> prefix_topk, R = 0 complete
planes -- doc sharding windows each shard's rows of every term in
full, so exactness holds by construction with no impact regions or
certification); windowed/masked sliced plans run ``sliced_topk``; the
dense packed-bitmap path >32-term boolean queries (``use_dense``), and
the candidate gather/sort core the rest -- so several devices scale
the fast path, not a fallback.  Correctness
of the merge follows from every global top-k document being in its
own shard's local top-k.

Incremental refresh mirrors index.device.DeviceIndex: removals flip
bits in the per-shard alive bitmaps (one small re-upload), additions
stay host-side as the delta until the budget forces a full rebuild --
a mutation no longer re-uploads the postings across the mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.hostindex import HostIndex
from ..ops.executor import candidate_topk, dense_topk, sliced_topk


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis: str = "docs") -> Mesh:
    """A 1-D mesh over the available devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "T", "k", "algo", "use_mask", "single",
                     "alive_all", "depth", "n_run", "T_head",
                     "use_rows"),
)
def sharded_search_sliced_batch(
    postings_pack: jax.Array,   # f32[n_dev, Ps_pad+guard, 3]
    alive_mask: jax.Array,      # uint32[n_dev, Ss/32]
    doc_len: jax.Array,         # f32[n_dev, Ss]
    q_start: jax.Array,         # int32[n_dev, N, Qs] per-shard starts
    q_len: jax.Array,           # int32[n_dev, N, Qs]
    q_idf: jax.Array,           # float32[N, Qs] (replicated)
    adl: jax.Array,             # float32 scalar (replicated)
    prog_ops: jax.Array,        # int32[N, L] (replicated)
    prog_args: jax.Array,
    sl_rows: jax.Array = None,  # int32[N, Qs] (replicated; windowed
                                # masked plans: token row per column)
    h_start: jax.Array = None,  # int32[n_dev, N] (T_head > 0)
    h_len: jax.Array = None,    # int32[n_dev, N]
    h_idf: jax.Array = None,    # float32[N] (replicated)
    h_row: jax.Array = None,    # int32[N] (replicated)
    h_pass: jax.Array = None,   # bool[N] (replicated)
    dense_rows: jax.Array = None,  # f32[n_dev, H, Ss] (use_rows)
    d_row: jax.Array = None,    # int32[N, D] (replicated)
    d_idf: jax.Array = None,    # float32[N, D] (replicated)
    *,
    mesh: Mesh,
    T: int,
    k: int,
    algo: int,
    use_mask: bool,
    single: bool,
    alive_all: bool,
    depth: int = 8,
    n_run: int = 0,
    T_head: int = 0,
    use_rows: bool = False,
):
    """Batched doc-sharded search through the sliced executor: the
    shard-local body is ops/executor.sliced_topk (contiguous per-term
    windows, variadic sort, shifted-pass aggregation), the cross-device
    traffic is one all_gather of n_dev * k candidates.
    Windowed plans (``n_run`` > 0) and head-term merges (``T_head`` >
    0, per-shard head ranges) run per shard exactly like a single
    device: the column -> token-row map and logical term count are
    shard-invariant by construction (search.py builds windows on the
    max per-shard length).  Returns replicated (scores f32[N, k'],
    global slots i32[N, k'])."""
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    slots_per_shard = doc_len.shape[1]
    k_local = min(k, slots_per_shard) if use_rows \
        else min(k, q_start.shape[2] * T + T_head)
    k_final = min(k, n_dev * k_local)
    if sl_rows is None:
        sl_rows = jnp.zeros(q_idf.shape, jnp.int32)
    n_q = q_idf.shape[0]
    if h_start is None:
        h_start = jnp.zeros((n_dev, n_q), jnp.int32)
        h_len = jnp.zeros((n_dev, n_q), jnp.int32)
        h_idf = jnp.zeros(n_q, jnp.float32)
        h_row = jnp.zeros(n_q, jnp.int32)
        h_pass = jnp.zeros(n_q, jnp.bool_)
    if dense_rows is None:
        dense_rows = jnp.zeros((n_dev, 1, slots_per_shard), jnp.float32)
        d_row = jnp.full((n_q, 1), -1, jnp.int32)
        d_idf = jnp.zeros((n_q, 1), jnp.float32)

    def shard_body(pack, am, dlen, qs, qlen, qidf, adl_s, pops, pargs,
                   srows, hs, hl, hi, hr, hp, dr, drow, didf):
        head = dict(h_start=hs[0], h_len=hl[0], h_idf=hi, h_row=hr,
                    h_pass=hp) if T_head else {}
        packed = sliced_topk(
            pack[0], am[0], dlen[0], qs[0], qlen[0], qidf, adl_s,
            pops, pargs,
            dr[0] if use_rows else None,
            drow if use_rows else None,
            didf if use_rows else None,
            sl_rows=srows if (use_mask and n_run) else None,
            T=T, k=k_local, algo=algo, n_slots=slots_per_shard,
            use_mask=use_mask, single=single, alive_all=alive_all,
            use_rows=use_rows, depth=depth, n_run=n_run, T_head=T_head,
            **head)
        local_scores = packed[:, 0, :]
        local_slots = (packed[:, 1, :].astype(jnp.int32)
                       + lax.axis_index(axis) * slots_per_shard)
        # Dead local results (score 0) must not alias a real global
        # slot after the offset shift; score filtering downstream
        # handles them, matching the other executors.
        all_scores = lax.all_gather(local_scores, axis, axis=1)
        all_slots = lax.all_gather(local_slots, axis, axis=1)
        n = all_scores.shape[0]
        all_scores = all_scores.reshape(n, -1)
        all_slots = all_slots.reshape(n, -1)
        m_scores, m_idx = lax.top_k(all_scores, k_final)
        return m_scores, jnp.take_along_axis(all_slots, m_idx, axis=1)

    sharded = P(mesh.axis_names[0], None)
    sharded3 = P(mesh.axis_names[0], None, None)
    repl = P()
    return jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(sharded3, sharded, sharded, sharded3, sharded3,
                  repl, repl, repl, repl, repl,
                  sharded, sharded, repl, repl, repl,
                  sharded3, repl, repl),
        out_specs=(repl, repl),
        check_vma=False,
    )(postings_pack, alive_mask, doc_len, q_start, q_len,
      q_idf, adl, prog_ops, prog_args, sl_rows,
      h_start, h_len, h_idf, h_row, h_pass,
      dense_rows, d_row, d_idf)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "T", "k", "algo", "alive_all", "n_run",
                     "k_ret"),
)
def sharded_search_prefix_batch(
    postings_pack: jax.Array,   # f32[n_dev, Ps_pad+guard, 3]
    alive_mask: jax.Array,      # uint32[n_dev, Ss/32]
    q_start: jax.Array,         # int32[n_dev, N, Qs] per-shard windows
    q_len: jax.Array,           # int32[n_dev, N, Qs]
    q_idf: jax.Array,           # float32[N, Qs] (replicated)
    adl: jax.Array,             # float32 scalar (replicated)
    *,
    mesh: Mesh,
    T: int,
    k: int,
    algo: int,
    alive_all: bool,
    n_run: int,
    k_ret: int = 0,
):
    """Doc-sharded impact-prefix executor: the flagship single-device
    serving plan (ops/executor.prefix_topk, R = 0 complete planes) run
    per shard under ``shard_map`` -- so a mesh serves the same fast
    path as one device (reference analogue: every mmap reader runs the
    same hot loop, src/query/search.c:285).

    Doc sharding makes R = 0 the natural multi-device shape: each
    shard's windows cover its own rows of every query term's postings
    IN FULL (the per-shard df is a fraction of the global df), so the
    per-shard plane is complete and the result exact by construction
    -- no impact-prefix regions, tail bounds, or certification are
    needed on the mesh.  Cross-device traffic is one all_gather of
    n_dev * k candidates, merged replicated.

    Returns replicated (scores f32[N, k'], global slots i32[N, k'])."""
    from ..ops.executor import prefix_topk

    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    slots_per_shard = alive_mask.shape[1] * 32
    n_q, qs = q_idf.shape
    k_local = min(k, qs * T)
    k_final = min(k, n_dev * k_local)
    zf = jnp.zeros((n_q, 0), jnp.float32)
    zi = jnp.zeros((n_q, 0), jnp.int32)
    col_bit = jnp.zeros((n_q, qs), jnp.int32)

    def shard_body(pack, am, qs_a, qlen, qidf, adl_s):
        packed = prefix_topk(
            pack[0], am[0], qs_a[0], qlen[0], qidf, adl_s,
            col_bit, zf, zi, zi, zf,
            T=T, k=k_local, M=32, algo=algo,
            n_slots=slots_per_shard, alive_all=alive_all,
            n_run=n_run, k_ret=k_ret)
        local_scores = packed[:, 0, :]
        local_slots = (packed[:, 1, :].astype(jnp.int32)
                       + lax.axis_index(axis) * slots_per_shard)
        all_scores = lax.all_gather(local_scores, axis, axis=1)
        all_slots = lax.all_gather(local_slots, axis, axis=1)
        all_scores = all_scores.reshape(n_q, -1)
        all_slots = all_slots.reshape(n_q, -1)
        m_scores, m_idx = lax.top_k(all_scores, k_final)
        return m_scores, jnp.take_along_axis(all_slots, m_idx, axis=1)

    sharded = P(mesh.axis_names[0], None)
    sharded3 = P(mesh.axis_names[0], None, None)
    repl = P()
    return jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(sharded3, sharded, sharded3, sharded3, repl, repl),
        out_specs=(repl, repl),
        check_vma=False,
    )(postings_pack, alive_mask, q_start, q_len, q_idf, adl)


def _bucket(n: int, minimum: int) -> int:
    size = minimum
    while size < n:
        size <<= 1
    return size


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "budget", "k", "algo", "use_mask", "depth",
                     "use_dense"),
)
def sharded_search(
    postings_slot: jax.Array,   # int32[n_dev, Ps_pad] shard-local slots
    postings_ltf: jax.Array,    # float32[n_dev, Ps_pad]
    doc_len: jax.Array,         # float32[n_dev, Ss]
    alive_mask: jax.Array,      # uint32[n_dev, Ss/32]
    q_start: jax.Array,         # int32[n_dev, Q] per-shard CSR starts
    q_len: jax.Array,           # int32[n_dev, Q]
    q_idf: jax.Array,           # float32[Q] (replicated)
    adl: jax.Array,             # float32 scalar (replicated)
    prog_ops: jax.Array,
    prog_args: jax.Array,
    *,
    mesh: Mesh,
    budget: int,                # per-shard postings budget
    k: int,
    algo: int,
    use_mask: bool,
    depth: int = 8,
    use_dense: bool = False,
):
    """Returns replicated (scores f32[k'], global slots i32[k'])."""
    packed = sharded_search_batch(
        postings_slot, postings_ltf, doc_len, alive_mask,
        q_start[:, None, :], q_len[:, None, :], q_idf[None],
        adl, prog_ops[None], prog_args[None],
        mesh=mesh, budget=budget, k=k, algo=algo, use_mask=use_mask,
        depth=depth, use_dense=use_dense)
    scores, slots = packed
    return scores[0], slots[0]


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "budget", "k", "algo", "use_mask", "depth",
                     "use_dense"),
)
def sharded_search_batch(
    postings_slot: jax.Array,   # int32[n_dev, Ps_pad]
    postings_ltf: jax.Array,    # float32[n_dev, Ps_pad]
    doc_len: jax.Array,         # float32[n_dev, Ss]
    alive_mask: jax.Array,      # uint32[n_dev, Ss/32]
    q_start: jax.Array,         # int32[n_dev, N, Q] per-shard, per-query
    q_len: jax.Array,           # int32[n_dev, N, Q]
    q_idf: jax.Array,           # float32[N, Q] (replicated)
    adl: jax.Array,             # float32 scalar (replicated)
    prog_ops: jax.Array,        # int32[N, L] (replicated)
    prog_args: jax.Array,
    *,
    mesh: Mesh,
    budget: int,
    k: int,
    algo: int,
    use_mask: bool,
    depth: int = 8,
    use_dense: bool = False,
):
    """Batched doc-sharded search: the shard-local executor inside the
    shard_map body, one all_gather for the whole batch.
    Returns replicated (scores f32[N, k'], global slots i32[N, k'])."""
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    slots_per_shard = doc_len.shape[1]
    k_local = min(k, slots_per_shard if use_dense else budget)
    k_final = min(k, n_dev * k_local)

    def shard_body(pslot, pltf, dlen, am, qs, qlen, qidf, adl_s,
                   pops, pargs):
        def one(q_s, q_l, q_i, p_o, p_a):
            if use_dense:
                return dense_topk(
                    pslot[0], pltf[0], dlen[0], am[0], q_s, q_l,
                    q_i, adl_s, p_o, p_a, budget=budget, k=k_local,
                    algo=algo, n_slots=slots_per_shard,
                    use_mask=use_mask, depth=depth)
            return candidate_topk(
                pslot[0], pltf[0], dlen[0], am[0], q_s, q_l, q_i,
                adl_s, p_o, p_a, budget=budget, k=k_local,
                algo=algo, use_mask=use_mask, depth=depth)

        local_scores, local_slots = jax.vmap(one)(
            qs[0], qlen[0], qidf, pops, pargs)     # [N, k_local]
        global_slots = (local_slots
                        + lax.axis_index(axis) * slots_per_shard)
        all_scores = lax.all_gather(local_scores, axis, axis=1)
        all_slots = lax.all_gather(global_slots, axis, axis=1)
        n = all_scores.shape[0]
        all_scores = all_scores.reshape(n, -1)
        all_slots = all_slots.reshape(n, -1)
        m_scores, m_idx = lax.top_k(all_scores, k_final)
        return m_scores, jnp.take_along_axis(all_slots, m_idx, axis=1)

    sharded = P(mesh.axis_names[0], None)
    sharded3 = P(mesh.axis_names[0], None, None)
    repl = P()
    return jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(sharded, sharded, sharded, sharded, sharded3, sharded3,
                  repl, repl, repl, repl),
        out_specs=(repl, repl),
        check_vma=False,
    )(postings_slot, postings_ltf, doc_len, alive_mask, q_start, q_len,
      q_idf, adl, prog_ops, prog_args)


class ShardedDeviceIndex:
    """Doc-sharded device mirror of one HostIndex generation.

    Same refresh contract as index.device.DeviceIndex -- removals flip
    the alive bitmap, additions accumulate in a host-side delta, and a
    full rebuild re-shards only when the delta outgrows its budget --
    but arrays have a leading ``n_dev`` axis laid out with
    NamedSharding over the mesh, and every shard carries its own CSR
    row pointers (a term's posting list is split by the doc-slot
    partition).  Global device slot == host slot: shard d holds host
    slots [d*Ss, (d+1)*Ss).
    """

    _MIN_SLOTS = 1024       # per shard; keeps mask words warp-aligned
    _MIN_POSTINGS = 4096    # per shard

    DELTA_MAX_POSTINGS = 65536
    DELTA_MAX_REMOVALS = 65536

    def __init__(self, host: HostIndex, mesh: Mesh):
        self.host = host
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_dev = mesh.shape[self.axis]
        self.generation = -1
        self.n_slots = 0            # global padded slot count
        self.slots_per_shard = 0
        self.base_nterms = 0
        self.postings_slot = None   # [n_dev, Ps_pad] device
        self.postings_ltf = None
        self.postings_pack = None   # [n_dev, Ps_pad+guard, 3] device
        self.doc_len = None         # [n_dev, Ss] device
        self.alive_mask = None      # [n_dev, Ss/32] device
        self._alive_all = True
        self.shard_starts = None    # host int64[n_dev, T+1]
        self._arrival_mark = 0      # host postings consumed into base
        self._slots_mark = 0        # host slot count at base build
        self._alive_cached = np.zeros(0, dtype=np.bool_)
        self._removed_since_base = 0
        # Dense score rows for heavy terms (same contract as
        # DeviceIndex): eligibility/cap use GLOBAL df and slot count,
        # rows live per shard as f32[n_dev, H, Ss].
        self.dense_rows = None
        self.dense_row_of: dict = {}
        self.dense_row_lookup = None

    # -- live aggregates (host-authoritative; search syncs first) ------

    @property
    def doc_count(self) -> int:
        return self.host.doc_count

    @property
    def token_count(self) -> int:
        return self.host.token_count

    @property
    def doc_ids(self) -> np.ndarray:
        return self.host.doc_ids.view()

    def term_live_df(self, term_id: int) -> int:
        return int(self.host.term_df.a[term_id - 1])

    @property
    def adl(self) -> float:
        if self.doc_count == 0:
            return 0.0
        return float(self.token_count // self.doc_count)

    @property
    def slice_t_cap(self) -> int:
        """Largest slice tier the per-shard guard rows can absorb
        (same contract as DeviceIndex.slice_t_cap, per shard)."""
        from ..index.device import DeviceIndex
        if self.postings_pack is None or self.postings_slot is None:
            return DeviceIndex.SLICE_MAX_T
        return (int(self.postings_pack.shape[1])
                - int(self.postings_slot.shape[1]))

    # -- refresh -------------------------------------------------------

    def refresh(self) -> bool:
        """Bring the mesh view up to the host generation.  Returns
        True when device state changed (rebuild or bitmap flip)."""
        if self.generation == self.host.generation:
            return False
        host = self.host
        if self.postings_slot is None:
            return self._full_rebuild()

        delta_postings = host.p_term.n - self._arrival_mark
        host_alive = host.doc_alive.view()
        newly_dead = self._alive_cached & ~host_alive[: self._slots_mark]
        n_newly_dead = int(np.count_nonzero(newly_dead))
        if (delta_postings > self.DELTA_MAX_POSTINGS
                or self._removed_since_base + n_newly_dead
                > self.DELTA_MAX_REMOVALS):
            return self._full_rebuild()

        if n_newly_dead:
            self._alive_cached &= host_alive[: self._slots_mark]
            self._removed_since_base += n_newly_dead
            self._alive_all = False
            self.alive_mask = self._put_sharded(self._packed_alive())
        self.generation = host.generation
        return n_newly_dead > 0

    @property
    def alive_all(self) -> bool:
        """True when no base-snapshot document is tombstoned."""
        return self._alive_all

    def _packed_alive(self) -> np.ndarray:
        padded = np.zeros(self.n_slots, dtype=np.bool_)
        padded[: len(self._alive_cached)] = self._alive_cached
        packed = np.packbits(padded, bitorder="little").view(np.uint32)
        return packed.reshape(self.n_dev, self.slots_per_shard // 32)

    def _put_sharded(self, arr: np.ndarray):
        return jax.device_put(
            arr, NamedSharding(self.mesh, P(self.axis, None)))

    def _full_rebuild(self) -> bool:
        snap = self.host.build_csr()
        nterms = len(snap["term_starts"]) - 1
        self.base_nterms = nterms
        n_live = len(snap["doc_ids"])
        ss = _bucket(-(-max(n_live, 1) // self.n_dev), self._MIN_SLOTS)
        self.slots_per_shard = ss
        self.n_slots = ss * self.n_dev

        slots = snap["postings_slot"].astype(np.int64)
        counts = np.diff(snap["term_starts"])
        term_of = np.repeat(np.arange(nterms, dtype=np.int64), counts)
        shard_of = slots // ss

        # Per-(shard, term) histogram -> per-shard CSR row pointers.
        per = np.zeros((self.n_dev, nterms), dtype=np.int64)
        np.add.at(per, (shard_of, term_of), 1)
        starts = np.zeros((self.n_dev, nterms + 1), dtype=np.int64)
        np.cumsum(per, axis=1, out=starts[:, 1:])
        self.shard_starts = starts

        ps_pad = _bucket(int(starts[:, -1].max()) if self.n_dev else 0,
                         self._MIN_POSTINGS)
        pslot = np.zeros((self.n_dev, ps_pad), dtype=np.int32)
        pltf = np.zeros((self.n_dev, ps_pad), dtype=np.float32)
        ltf_all = np.log(snap["postings_tf"].astype(np.float64) + 1.0)
        # Stable partition by shard preserves the term grouping inside
        # each shard, so per-shard CSR pointers index it directly.
        order = np.argsort(shard_of, kind="stable")
        sizes = starts[:, -1]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        for d in range(self.n_dev):
            sel = order[offs[d]: offs[d + 1]]
            pslot[d, : sizes[d]] = (slots[sel] - d * ss).astype(np.int32)
            pltf[d, : sizes[d]] = ltf_all[sel]

        dlen = np.ones((self.n_dev, ss), dtype=np.float32)
        flat = dlen.reshape(-1)
        flat[:n_live] = snap["doc_len"]  # slots are contiguous per shard

        # Interleaved (slot, ltf, dl) rows for the sliced executor
        # (same layout as index.device.DeviceIndex.postings_pack, per
        # shard); guard rows keep dynamic_slice starts from clamping.
        from ..index.device import DeviceIndex
        guard = min(DeviceIndex.SLICE_MAX_T,
                    max(int(per.max()) if per.size else 0, 1))
        pack = np.zeros((self.n_dev, ps_pad + guard, 3), dtype=np.float32)
        for d in range(self.n_dev):
            n_d = int(sizes[d])
            pack[d, :n_d, 0] = pslot[d, :n_d]
            pack[d, n_d:, 0] = float(ss)
            pack[d, :n_d, 1] = pltf[d, :n_d]
            pack[d, :n_d, 2] = dlen[d, pslot[d, :n_d]]
        self.postings_pack = self._put_sharded(pack)

        # Dense rows for the heaviest terms: GLOBAL df decides the
        # (shard-invariant) row set; each shard scatters its own
        # postings into f32[H, Ss] rows on device, exactly like
        # DeviceIndex (the searchsorted row mapping needs ascending
        # per-row starts, hence np.sort after the df-ordered cap).
        term_df_base = counts
        heavy = np.nonzero(
            term_df_base > self.n_slots // DeviceIndex.DENSE_DF_DIV)[0]
        row_cap = min(DeviceIndex.MAX_DENSE_ROWS,
                      max(int(DeviceIndex.DENSE_ROWS_MAX_BYTES
                              // (4 * max(self.n_slots, 1))), 1))
        if len(heavy) > row_cap:
            heavy = np.sort(
                heavy[np.argsort(-term_df_base[heavy], kind="stable")
                      [: row_cap]])
        self.dense_row_of = {int(t) + 1: i for i, t in enumerate(heavy)}
        lookup = np.full(nterms + 1, -1, dtype=np.int32)
        lookup[heavy + 1] = np.arange(len(heavy), dtype=np.int32)
        self.dense_row_lookup = lookup
        if len(heavy):
            from ..index.device import _dense_rows_dev
            h_starts = starts[:, heavy].astype(np.int64)
            h_lens = per[:, heavy].astype(np.int64)
            n_rows = len(heavy)
            chunk = min(ps_pad, 1 << 22)

            def rows_body(pk, st, ln):
                return _dense_rows_dev(
                    pk[0], st[0], ln[0], s_pad=ss, p_pad=ps_pad,
                    n_rows=n_rows, chunk=chunk)[None]

            ax = self.axis
            self.dense_rows = jax.shard_map(
                rows_body, mesh=self.mesh,
                in_specs=(P(ax, None, None), P(ax, None), P(ax, None)),
                out_specs=P(ax, None, None),
                check_vma=False,
            )(self.postings_pack, self._put_sharded(h_starts),
              self._put_sharded(h_lens))
        else:
            self.dense_rows = None

        self.postings_slot = self._put_sharded(pslot)
        self.postings_ltf = self._put_sharded(pltf)
        self.doc_len = self._put_sharded(dlen)
        self._alive_cached = snap["doc_alive"].copy()
        self._alive_all = bool(self._alive_cached.all())
        self.alive_mask = self._put_sharded(self._packed_alive())
        self._arrival_mark = self.host.p_term.n
        self._slots_mark = self.host.doc_ids.n
        self._removed_since_base = 0
        self.generation = snap["generation"]
        return True

    # -- query-side metadata (per-shard ranges) ---------------------------

    def term_ranges(self, term_id: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard (start, length) of a 1-based term's base postings.
        Terms born after the base snapshot live in the delta."""
        if term_id > self.base_nterms:
            z = np.zeros(self.n_dev, dtype=np.int64)
            return z, z
        start = self.shard_starts[:, term_id - 1]
        end = self.shard_starts[:, term_id]
        return start, end - start

    # -- delta (host-side postings past the base watermark) ---------------

    @property
    def has_delta(self) -> bool:
        return self.host.p_term.n > self._arrival_mark

    @property
    def delta_slot0(self) -> int:
        """First host doc slot not covered by the base snapshot."""
        return self._slots_mark

    def delta_postings(self):
        """(term_ids, counts, slots) numpy views of the delta."""
        host = self.host
        mark = self._arrival_mark
        return (host.p_term.a[mark: host.p_term.n],
                host.p_count.a[mark: host.p_count.n],
                host.p_slot.a[mark: host.p_slot.n])

    def delta_lookup(self, term_id: int):
        """(counts, slots) of one term's delta postings via a
        term-sorted index (same contract as DeviceIndex.delta_lookup)."""
        mark = self._arrival_mark
        n = self.host.p_term.n
        if getattr(self, "_dx_key", None) != (mark, n):
            d_term, d_count, d_slot = self.delta_postings()
            order = np.argsort(d_term, kind="stable")
            self._dx_terms = d_term[order]
            self._dx_count = d_count[order]
            self._dx_slot = d_slot[order]
            self._dx_key = (mark, n)
        lo = np.searchsorted(self._dx_terms, term_id, side="left")
        hi = np.searchsorted(self._dx_terms, term_id, side="right")
        return self._dx_count[lo:hi], self._dx_slot[lo:hi]
