"""Device snapshot of the host index with incremental refresh.

The reference's in-memory search state (per-term roaring bitmaps +
mmap-backed counts, src/index/idxterm.c, idxdoc.c) is derived state
rebuilt from the journals.  The device analogue is a *base snapshot*:
the host-authoritative :class:`HostIndex` transposed to term-grouped
CSR (HostIndex.build_csr) and uploaded as immutable device arrays.

XLA wants immutable arrays, but the engine must keep the reference's
read-your-writes behavior (search syncs before every query,
search.c:309-310) without re-uploading the index on every mutation.
The incremental scheme:

- **Removals** flip bits in a packed alive bitmap (uint32[S_pad/32],
  4 KB per million documents) that the executors test per candidate;
  only that tiny array re-uploads.
- **Additions** stay host-side as the *delta*: the arrival-ordered
  postings appended after the base watermark.  Queries score the delta
  on the host with the same formulas and merge it with the device
  top-k (search.py).  Document/term aggregates (df, totals, counts)
  always come from the live host index, so IDF/adl are exact.
- A **full rebuild** happens when the delta outgrows its budget.

Device arrays (strings and the term dictionary never leave the host):

    postings_slot int32[P_pad]   doc slots grouped by term, slot-sorted
    postings_ltf  float32[P_pad] log(tf + 1), host-f64 precomputed
    doc_len       float32[S_pad]
    alive_mask    uint32[S_pad/32]
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import numpy as np

from ..utils.log import get_logger
from .hostindex import HostIndex

_log = get_logger(__name__)


def _bucket(n: int, minimum: int) -> int:
    """Smallest power-of-two >= max(n, minimum)."""
    size = minimum
    while size < n:
        size <<= 1
    return size


# Above this size, padded array growth switches from powers of two
# (whose worst case doubles HBM -- fatal at hundreds of millions of
# postings) to 1 MiB-element granularity: <= ~25% waste at the
# switchover, and slot counts stay multiples of the 1024-slot kernel
# block.  Must sit WELL below 2**24: slot counts at exactly 2**24
# lose f32 exactness and would disqualify every fast executor (an
# 8.8M-doc corpus once bucketed to exactly 2**24 slots and fell all
# the way to the sort-based candidate path).
_POW2_LIMIT = 1 << 22


def _pad_size(n: int, minimum: int) -> int:
    """Padded allocation size: power-of-two up to _POW2_LIMIT, then
    the next multiple of 2**20."""
    if n <= _POW2_LIMIT:
        return _bucket(n, minimum)
    grain = 1 << 20
    return -(-n // grain) * grain


def _pack_alive(alive: np.ndarray, s_pad: int) -> np.ndarray:
    """bool[n] -> little-bit-order uint32[s_pad/32] bitmap."""
    padded = np.zeros(s_pad, dtype=np.bool_)
    padded[: len(alive)] = alive
    return np.packbits(padded, bitorder="little").view(np.uint32)


import functools

import jax.numpy as jnp


# Rows per pack-build chunk: 4M rows = 16 MB slot + 8 MB tf per
# upload.  Chunking keeps the transient HBM at (pack + one chunk)
# instead of (pack + full compact columns): a 3 GB transient at the
# 8.8M-doc tier fragmented the heap enough to OOM later allocations.
_PACK_CHUNK = 1 << 22


@functools.partial(jax.jit, static_argnames=("n",))
def _pack_init_dev(*, n: int):
    return jnp.zeros((n, 3), jnp.float32)


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("from_tf",))
def _pack_update_dev(pack, slot_c, vals_c, dlen, off, *, from_tf: bool):
    """Write one chunk of (slot, ltf, dl) rows into the donated pack.

    ``slot_c`` int32[C] (guard rows pre-set to the s_pad sentinel),
    ``vals_c`` uint16 occurrence counts (or float32 ltf when from_tf
    is False), ``dlen`` f32[s_pad].  Uploading the compact columns and
    deriving the f32 pack device-side moves ~half the bytes of
    shipping the pack itself (the host->device link bounds large-index
    opens: 6.2 GB of pack against 3.2 GB of slot+tf at the 8.8M tier).
    The pack is donated: updates are in place.
    """
    from jax import lax

    slot_f = slot_c.astype(jnp.float32)
    if from_tf:
        ltf = jnp.log(vals_c.astype(jnp.float32) + 1.0)
    else:
        ltf = vals_c
    dl = dlen[jnp.minimum(slot_c, dlen.shape[0] - 1)]
    block = jnp.stack([slot_f, ltf, dl], axis=1)
    return lax.dynamic_update_slice(pack, block, (off, 0))


@functools.partial(jax.jit, donate_argnums=(),
                   static_argnames=("s_pad", "p_pad", "n_rows", "chunk"))
def _dense_rows_dev(pack, starts, lens, *, s_pad: int, p_pad: int,
                    n_rows: int, chunk: int):
    """Scatter the heavy terms' (slot, ltf) postings into dense score
    rows ON DEVICE, streaming the pack in fixed chunks.  A posting at
    global index g belongs to heavy row r iff starts[r] <= g <
    starts[r] + lens[r] (starts ascending: CSR order).  Replaces a
    host-side build + ~GB upload over the host->device link."""
    from jax import lax

    n_chunks = max((p_pad + chunk - 1) // chunk, 1)
    # int32 throughout: postings counts and the flattened rows index
    # (<= DENSE_ROWS_MAX_BYTES/4 elements) both stay below 2**31.
    h_starts = starts.astype(jnp.int32)
    h_lens = lens.astype(jnp.int32)

    def body(c, rows_flat):
        g0 = c * chunk
        win = lax.dynamic_slice(pack, (g0, 0), (chunk, 3))
        g = g0 + jnp.arange(chunk, dtype=jnp.int32)
        r = jnp.searchsorted(h_starts, g, side="right") - 1
        r_c = jnp.clip(r, 0, max(n_rows - 1, 0))
        ok = ((r >= 0) & (g < h_starts[r_c] + h_lens[r_c])
              & (g < p_pad))
        slot = win[:, 0].astype(jnp.int32)
        flat = jnp.where(ok, r_c * s_pad + slot, n_rows * s_pad)
        return rows_flat.at[flat].add(
            jnp.where(ok, win[:, 1], 0.0), mode="drop")

    rows0 = jnp.zeros((max(n_rows, 1) * s_pad,), jnp.float32)
    if n_rows == 0:
        return rows0.reshape(1, s_pad)
    out = lax.fori_loop(0, n_chunks, body, rows0)
    return out.reshape(n_rows, s_pad)


def _prefix_tier(df: int, cap: int) -> int:
    """Power-of-two read-window tier for an impact-prefix build over a
    term of ``df`` postings (df > cap).  Starting at the first power of
    two above cap keeps top_k(cap + 1) within every tier."""
    t = _bucket(cap + 1, 2)
    while t < df:
        t <<= 1
    return t


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("tier", "cap"))
def _prefix_build_dev(pack, starts, lens, dest, c1, c2, *,
                      tier: int, cap: int):
    """Impact-prefix build for one tier chunk of wide terms, ON DEVICE.

    For each term (CSR ``starts``/``lens``, every len <= tier), selects
    its top postings by BM25 impact part
    g = ltf / (ltf + c1 + c2*dl) (evaluated at the snapshot adl),
    writes them SLOT-SORTED into the pack's prefix region at per-term
    row ``dest`` (donated scatter; padding terms carry an out-of-range
    dest and drop), and returns per term the tail bound plus the
    TIE-FREE cut length: the prefix covers the top ``cut <= cap``
    impacts where ``cut`` is the last strict impact decrease within
    the cap window, so the tail (the max excluded impact) is STRICTLY
    below every included impact.  Cutting at the cap itself would
    routinely land inside a run of tied impacts -- (tf, dl) pairs are
    quantized, so thousands of postings share one impact value -- and
    a tied bound can never certify (prefix_topk requires kth > tail
    strictly).  idf multiplies at query time, so contribution bounds
    are idf * tail; removals only shrink true maxima, so the bound
    survives alive-bitmap drift."""
    from jax import lax

    def one(s, ln):
        win = lax.dynamic_slice(pack, (s, 0), (tier, 3))
        part = win[:, 1] / (win[:, 1] + c1 + c2 * win[:, 2])
        pos = jnp.arange(tier, dtype=jnp.int32)
        part = jnp.where(pos < ln, part, -jnp.inf)
        vals, ix = lax.top_k(part, cap + 1)
        idxs = jnp.arange(cap + 1, dtype=jnp.int32)
        # cut = last position with a strict decrease vals[i-1] >
        # vals[i]; ranks [0, cut) are included, tail = vals[cut].
        strict = jnp.concatenate(
            [jnp.zeros((1,), jnp.bool_), vals[1:] < vals[:-1]])
        cut = jnp.max(jnp.where(strict, idxs, 0))
        tail = vals[cut]
        rows = win[ix[:cap]]
        # Slot-sort the included ranks first; excluded boundary ties
        # sink past the cut (the planner windows only [0, cut)).
        keep = idxs[:cap] < cut
        order = jnp.argsort(jnp.where(keep, rows[:, 0], jnp.inf))
        return rows[order], tail, cut

    rows, tails, cuts = jax.vmap(one)(starts, lens)
    flat_ix = (dest[:, None]
               + jnp.arange(cap, dtype=dest.dtype)[None, :]).reshape(-1)
    pack = pack.at[flat_ix].set(rows.reshape(-1, 3), mode="drop")
    return pack, tails, cuts


@functools.partial(jax.jit, static_argnames=("p_pad",))
def _pack_slot_column(pack, *, p_pad: int):
    return pack[:p_pad, 0].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("p_pad",))
def _pack_ltf_column(pack, *, p_pad: int):
    return pack[:p_pad, 1]


class DeviceIndex:
    """Base device snapshot + host delta for one HostIndex."""

    # S_pad is a multiple of 1024 so the packed bitmap width (S_pad/32)
    # is a multiple of 32 words -- a whole number of 32-lane warps.
    _MIN_SLOTS = 1024
    _MIN_POSTINGS = 4096

    # Delta budgets before a full rebuild: host-side scoring of the
    # delta is O(delta) per query, so keep it small relative to a
    # device dispatch; removal flips are nearly free but unbounded
    # accumulation would strand dead postings in HBM.
    DELTA_MAX_POSTINGS = 65536
    DELTA_MAX_REMOVALS = 65536

    # Dense-row tier: terms with base df > n_slots // DENSE_DF_DIV
    # (capped at MAX_DENSE_ROWS and DENSE_ROWS_MAX_BYTES of HBM,
    # highest-df first).
    DENSE_DF_DIV = 16
    MAX_DENSE_ROWS = 128
    # 1.25 GB (~35 rows at the 8.8M tier).  Dense rows are how
    # monster terms (df in the millions) avoid the sort plane: their
    # contribution is an elementwise sweep + one top_k over n_slots
    # where the windowed sort pays per posting -- and the damped
    # serving mix hits a top-25-rank term in ~0.3% of queries, ~6 rows
    # per 2048 batch.  The budget was sized for a 16 GB device (pack
    # 6.3 GB + rows 1.25 GB + ~3 GB transient planes) and keeps its
    # value on the H100's 80 GB: unmeasured there.
    DENSE_ROWS_MAX_BYTES = int(
        os.environ.get("NXS_DENSE_ROWS_MB", "1280")) << 20

    # Guard padding past the CSR postings so the sliced executor's
    # per-term dynamic slices (length <= SLICE_MAX_T, contiguous HBM
    # reads) never clamp their start offset: XLA clamps out-of-range
    # dynamic_slice starts, which would silently shift the fetched
    # window.  Terms with base df > SLICE_MAX_T take the dense-row,
    # candidate or dense path instead.
    SLICE_MAX_T = 1 << 20

    # Impact-prefix pruning (the device MaxScore analogue; reference's
    # matching-docs-only scoring loop is search.c:236-271): terms with
    # base df above WIDE_MIN_DF get their top-PREFIX_CAP postings by
    # BM25 impact appended to the pack (slot-sorted) plus a tail
    # bound, so pure-OR queries can score a bounded plane and certify
    # exactness (ops/executor.prefix_topk).  PREFIX_CAP = 0 disables.
    #
    # The threshold sits at 64k, NOT at the prefix depth: certifying
    # an R > 0 plane almost never succeeds (every near-tied plane doc
    # is granted the full missing-term tail, so u_out ~ kth + tail --
    # 0-3% certification among R > 0 rows at ANY rescore
    # depth M), which made every wide-term query a classic re-run.
    # Windowing 4k-64k-df terms in FULL (up to 64 sort-plane columns)
    # turns ~85% -> ~97% of damped-Zipf rows exact-by-construction
    # (R = 0), and the few true monsters (~700 terms at the 8.8M
    # tier) cut 4x deeper for smaller tails.
    PREFIX_CAP = int(os.environ.get("NXS_PREFIX_CAP", "16384"))
    WIDE_MIN_DF = int(os.environ.get("NXS_WIDE_MIN_DF", str(1 << 16)))

    def __init__(self, host: HostIndex, device: Optional[jax.Device] = None):
        self.host = host
        self.device = device
        self.generation = -1
        # Base snapshot metadata (host side).
        self.term_starts = np.zeros(1, dtype=np.int64)
        self.base_nterms = 0
        self.n_slots = 0            # padded slot count (S_pad)
        self.n_postings = 0         # padded postings count (P_pad)
        self._arrival_mark = 0      # host postings consumed into base
        self._slots_mark = 0        # host slot count at base build
        self._alive_cached = np.zeros(0, dtype=np.bool_)
        self._removed_since_base = 0
        # Device arrays.  postings_pack is the primary postings store
        # (the sliced executor reads only it); the slot/ltf columns
        # derive from it lazily on device for the fallback executors
        # (candidate/dense) -- at hundreds of millions of
        # postings a standing copy would double HBM for paths that
        # large-corpus query mixes rarely touch.
        self._slot_dev = None
        self._ltf_dev = None
        self.postings_pack = None   # f32[P_pad + guard, 3]: (slot, ltf, dl)
        self.doc_len = None
        self.alive_mask = None
        self._alive_all = True      # no dead slot in the base snapshot
        # Device slot -> host slot (device order is dl-ascending; see
        # _full_rebuild).  None until the first rebuild.
        self.slot_perm = None
        # Dense score rows for heavy terms (df > n_slots/DENSE_DF_DIV):
        # f32[H, S_pad] log-tf by device slot.  Scoring them is pure
        # elementwise work (one row read per query term) instead of
        # sorting their postings -- the Zipf head owns most posting
        # mass.  Exact: same ltf values, same formula.
        self.dense_rows = None          # device f32[max(H,1), S_pad]
        self.dense_row_of = {}          # term_id -> row index
        # Vectorized twin of dense_row_of for the batch planner:
        # int32[base_nterms + 1], row index by 1-based term id, -1
        # for terms without a dense row (built in _finish_rebuild).
        self.dense_row_lookup = None
        # Impact-prefix metadata (PREFIX_CAP): pack offset of each wide
        # term's slot-sorted top-CAP impact postings (int32 by 1-based
        # term id, -1 for non-wide), the tail bound (f32, max impact of
        # the excluded postings), and the adl the impacts were built at
        # (the bound is only valid while the live adl matches).
        self.prefix_start_lookup = None
        self.prefix_tail = None
        self.prefix_len = None      # tie-free cut per wide term
        self.prefix_cap = 0
        self.adl_built = -1.0
        self._guard_len = 0

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
    def postings_slot(self):
        """int32[P_pad] device column (derived from the pack on first
        use: no host->device transfer, slot rides in the pack as f32,
        exact below 2**24 which the routers gate on)."""
        if self._slot_dev is None and self.postings_pack is not None:
            self._slot_dev = _pack_slot_column(
                self.postings_pack, p_pad=self.n_postings)
        return self._slot_dev

    @property
    def postings_ltf(self):
        """float32[P_pad] device column (derived from the pack on
        first use; see postings_slot)."""
        if self._ltf_dev is None and self.postings_pack is not None:
            self._ltf_dev = _pack_ltf_column(
                self.postings_pack, p_pad=self.n_postings)
        return self._ltf_dev

    def drop_legacy_cols(self) -> None:
        """Release the derived slot/ltf columns (3.9 GB at the 8.8M
        tier).  Called after a batch dispatched a candidate/dense
        group: XLA keeps the buffers alive until the queued work
        completes, and the next batch re-derives them in ~2 device ops
        -- transient HBM instead of a permanent second postings copy
        beside the pack."""
        if self.postings_pack is not None and self.n_postings > (1 << 26):
            self._slot_dev = None
            self._ltf_dev = None

    @property
    def slice_t_cap(self) -> int:
        """Largest slice tier the pack's guard rows can absorb: a
        per-term dynamic_slice window of T <= this never reads past
        the pack (starts are <= n_postings; everything beyond carries
        the sentinel slot).  Always >= the largest sliceable df, so
        clamping a coarse tier to it never drops postings."""
        if self.postings_pack is None:
            return self.SLICE_MAX_T
        if self._guard_len > 0:
            # Conservative when an impact-prefix region sits between
            # the CSR postings and the guard: reads starting inside the
            # prefix region only have the trailing guard to absorb.
            return self._guard_len
        return int(self.postings_pack.shape[0]) - self.n_postings

    @property
    def alive_all(self) -> bool:
        """True when no base-snapshot document is tombstoned: the
        executors may skip per-candidate alive masking entirely."""
        return self._alive_all

    @property
    def adl(self) -> float:
        """Average document length with the reference's integer
        division (ranking.c:160: unsigned long / unsigned long)."""
        if self.doc_count == 0:
            return 0.0
        return float(self.token_count // self.doc_count)

    @property
    def adl_dev(self):
        """Device-resident adl scalar, cached per value: building a
        fresh jnp scalar per dispatch is one host->device transfer
        each, a host->device round trip."""
        a = self.adl
        if getattr(self, "_adl_dev_val", None) != a:
            self._adl_dev = jnp.asarray(a, jnp.float32)
            self._adl_dev_val = a
        return self._adl_dev

    # -- refresh -------------------------------------------------------

    def refresh(self) -> bool:
        """Bring the device view up to the host generation.  Returns
        True when the device state changed (rebuild or bitmap flip)."""
        if self.generation == self.host.generation:
            return False
        host = self.host
        if self.postings_pack is None:
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
            self.alive_mask = self._put(
                _pack_alive(self._alive_cached[self.slot_perm],
                            self.n_slots))
        self.generation = host.generation
        return n_newly_dead > 0

    def _put(self, arr):
        return jax.device_put(arr, self.device) if self.device \
            else jax.device_put(arr)

    # The CSR transpose (a lexsort of every live posting) dominates
    # large-index opens -- ~15 min single-core at 8.8M docs / 500M
    # postings -- and is fully derived state.  Indexes above this many
    # postings persist the sorted layout beside the journals and
    # restarts load it back keyed by generation (stale = ignored).
    CSR_CACHE_MIN_POSTINGS = 1 << 24
    # v1 stored f32 ltf; v2 stores raw u16 counts (25% smaller file,
    # and the device computes ltf anyway).  Both load.
    _CSR_CACHE_VERSIONS = (1, 2)

    @property
    def _csr_cache_path(self) -> str:
        return os.path.join(self.host.idxdir, "csr_cache.npz")

    def _load_csr_cache(self):
        try:
            z = np.load(self._csr_cache_path, allow_pickle=False)
            if (int(z["version"]) not in self._CSR_CACHE_VERSIONS
                    or int(z["generation"]) != self.host.generation):
                return None
            return z
        except (OSError, KeyError, ValueError):
            return None

    def _save_csr_cache(self, term_starts, slot_real, tf16, ltf_real,
                        perm) -> None:
        tmp = self._csr_cache_path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                if tf16 is not None:
                    np.savez(f, version=np.int64(2),
                             generation=np.int64(self.host.generation),
                             term_starts=term_starts,
                             slot=slot_real, tf16=tf16, perm=perm)
                else:  # pragma: no cover - >64k tf fallback
                    np.savez(f, version=np.int64(1),
                             generation=np.int64(self.host.generation),
                             term_starts=term_starts,
                             slot=slot_real, ltf=ltf_real, perm=perm)
            os.replace(tmp, self._csr_cache_path)
        except OSError:  # pragma: no cover - best-effort cache
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _full_rebuild(self) -> bool:
        cached = self._load_csr_cache()
        if cached is not None:
            return self._rebuild_from_cache(cached)
        # Device slots are assigned by ASCENDING doc length, not host
        # arrival order.  BM25's dominant static score factor is dl,
        # so length-ordering concentrates each term's strongest
        # contributions (and short co-occurring docs) in the
        # lowest-numbered slot blocks -- which is what makes block-max
        # pruning discriminate: in arrival order every block looks the
        # same and the exactness check can never certify.  Classic IR
        # engines get the analogous effect from quality-ordered doc-id
        # assignment.  Host slots stay stable (the delta/alive
        # bookkeeping is host-ordered); ``slot_perm`` maps device slot
        # -> host slot for response building.  The permutation is
        # computed up front and handed to build_csr so the postings
        # come out directly in (term, device-slot) order -- one
        # composite-key sort instead of two full lexsorts (f32 doc_len
        # keys keep the ordering identical to the prior two-pass path).
        t_phase = time.monotonic()
        n_slots_host = self.host.doc_ids.n
        dl_host = np.asarray(self.host.doc_len.view()[:n_slots_host],
                             dtype=np.float32)
        perm = np.argsort(dl_host, kind="stable").astype(np.int64)
        inv = np.empty(n_slots_host, dtype=np.int64)
        inv[perm] = np.arange(n_slots_host)

        snap = self.host.build_csr(slot_remap=inv)
        _log.debug("rebuild: build_csr %.1fs (%d postings)",
                   time.monotonic() - t_phase, len(snap["postings_slot"]))
        t_phase = time.monotonic()
        self.term_starts = snap["term_starts"]
        self.base_nterms = len(snap["term_starts"]) - 1

        n_post = len(snap["postings_slot"])
        s_pad = _pad_size(n_slots_host, self._MIN_SLOTS)
        p_pad = _pad_size(n_post, self._MIN_POSTINGS)
        counts = np.diff(snap["term_starts"])

        slot_real = np.ascontiguousarray(snap["postings_slot"],
                                         dtype=np.int32)
        tf_f = snap["postings_tf"]
        tf16 = ltf_real = None
        if not len(tf_f) or tf_f.max() < 65536:
            tf16 = tf_f.astype(np.uint16)
        else:  # pragma: no cover - >64k occurrences of one term
            ltf_real = np.log(tf_f.astype(np.float64) + 1.0).astype(
                np.float32)
        # Padding doc_len with 1.0 keeps dl/adl finite for padded slots
        # (their contributions are masked out regardless).
        dlen = np.ones(s_pad, dtype=np.float32)
        dlen[:n_slots_host] = snap["doc_len"][perm]

        _log.debug("rebuild: tf/pad %.1fs", time.monotonic() - t_phase)
        if n_post >= self.CSR_CACHE_MIN_POSTINGS:
            t_phase = time.monotonic()
            self._save_csr_cache(snap["term_starts"], slot_real, tf16,
                                 ltf_real, perm)
            _log.debug("rebuild: csr cache save %.1fs",
                       time.monotonic() - t_phase)

        return self._finish_rebuild(
            term_starts=snap["term_starts"], counts=counts,
            slot_real=slot_real, tf16=tf16, ltf_real=ltf_real,
            dlen=dlen, perm=perm, n_post=n_post,
            n_slots_host=n_slots_host, s_pad=s_pad, p_pad=p_pad,
            doc_alive=snap["doc_alive"].copy(),
            doc_count=snap["doc_count"], token_count=snap["token_count"],
            generation=snap["generation"])

    def _rebuild_from_cache(self, z) -> bool:
        """Assemble the device snapshot from the persisted CSR layout:
        skips build_csr's lexsort of every live posting (the dominant
        cost of large-index opens).  The cache is generation-checked,
        so the arrays equal what build_csr would produce."""
        host = self.host
        term_starts = np.asarray(z["term_starts"])
        slot_real = np.asarray(z["slot"])
        # v2 stores raw u16 counts (half the bytes of v1's f32 ltf);
        # both assemble identically via _finish_rebuild.
        tf16 = np.asarray(z["tf16"]) if "tf16" in z else None
        ltf_real = np.asarray(z["ltf"]) if tf16 is None else None
        perm = np.asarray(z["perm"])
        if tf16 is None and ltf_real is not None and len(ltf_real):
            # One-time v1 -> v2 conversion: counts are exactly
            # recoverable from f32 ltf (round(expm1(ltf)) errs by
            # < 0.5 up to tf ~8e6), and v2 halves the upload and the
            # cache file.
            tf_rec = np.rint(np.expm1(ltf_real.astype(np.float64)))
            if len(tf_rec) and 1.0 <= tf_rec.min() \
                    and tf_rec.max() < 65536.0:
                tf16 = tf_rec.astype(np.uint16)
                ltf_real = None
                self._save_csr_cache(term_starts, slot_real, tf16,
                                     None, perm)
        self.term_starts = term_starts
        self.base_nterms = len(term_starts) - 1

        n_slots_host = host.doc_ids.n
        n_post = len(slot_real)
        s_pad = _pad_size(n_slots_host, self._MIN_SLOTS)
        p_pad = _pad_size(n_post, self._MIN_POSTINGS)
        dlen = np.ones(s_pad, dtype=np.float32)
        dlen[:n_slots_host] = \
            host.doc_len.view()[:n_slots_host].astype(np.float32)[perm]
        counts = np.diff(term_starts)
        return self._finish_rebuild(
            term_starts=term_starts, counts=counts, slot_real=slot_real,
            tf16=tf16, ltf_real=ltf_real,
            dlen=dlen, perm=perm, n_post=n_post,
            n_slots_host=n_slots_host, s_pad=s_pad, p_pad=p_pad,
            doc_alive=host.doc_alive.view()[:n_slots_host].copy(),
            doc_count=host.doc_count, token_count=host.token_count,
            generation=host.generation)

    def _finish_rebuild(self, *, term_starts, counts, slot_real,
                        dlen, perm, n_post, n_slots_host, s_pad, p_pad,
                        doc_alive, doc_count, token_count, generation,
                        tf16=None, ltf_real=None) -> bool:
        """Publish the device snapshot.  Postings arrive UNPADDED as
        ``slot_real`` int32[n_post] plus either ``tf16`` uint16 counts
        (preferred: half the upload bytes; ltf computed on device) or
        ``ltf_real`` float32 (when a count overflows u16, or from a
        v1 layout cache)."""
        def ltf_range(lo: int, hi: int) -> np.ndarray:
            if ltf_real is not None:
                return ltf_real[lo:hi]
            return np.log(tf16[lo:hi].astype(np.float64) + 1.0).astype(
                np.float32)

        t_phase = time.monotonic()
        # Column device arrays derive lazily from the pack (no upload,
        # no standing HBM until a fallback executor needs them).
        self._slot_dev = None
        self._ltf_dev = None
        # Interleaved (slot, ltf, dl) rows for the sliced executor: ONE
        # contiguous per-term dynamic slice fetches everything a
        # posting contributes (one sequential read instead of random
        # per-posting gathers).  Slots ride as
        # f32 by value -- exact below 2**24, which the router gates on.
        # Guard rows past p_pad keep dynamic_slice starts from
        # clamping (which would silently shift the fetched window);
        # their slot is the n_slots sentinel so clamped-tail lanes
        # could never alias a real document even if unmasked.  The f32
        # pack itself is assembled ON DEVICE from the compact columns
        # (_build_pack_dev): the host->device link is the bottleneck.
        guard = min(self.SLICE_MAX_T,
                    max(int(counts.max()) if len(counts) else 0, 1))
        # Impact-prefix region: wide terms' top-PREFIX_CAP impact
        # postings live between the CSR postings and the guard
        # (_build_prefix fills them after the pack upload).  The build
        # reads each wide term through a power-of-two tier window, so
        # the allocation must absorb the largest read overhang
        # (start + tier past the data end).
        cap = int(self.PREFIX_CAP)
        wide_min = max(cap, int(self.WIDE_MIN_DF))
        wide = (np.nonzero(counts > wide_min)[0]
                if cap > 0 and doc_count > 0 else
                np.zeros(0, dtype=np.int64))
        prefix_len = len(wide) * cap
        tail_min = p_pad + prefix_len + guard
        if len(wide):
            w_starts = term_starts[wide].astype(np.int64)
            w_tiers = np.asarray(
                [_prefix_tier(int(c), cap) for c in counts[wide]],
                dtype=np.int64)
            tail_min = max(tail_min, int((w_starts + w_tiers).max()))
        assert tail_min < (1 << 31), "pack offsets must stay int32"
        # Rounding the pack up to whole chunks keeps every update the
        # same shape (one compiled executable); rows past the CSR
        # postings are zero (slot 0, ltf 0: contribution 0 even if a
        # window's masked tail lanes read them) until the prefix build
        # overwrites its region.
        chunk = min(_PACK_CHUNK, _pad_size(tail_min, 1 << 12))
        n_round = -(-tail_min // chunk) * chunk
        upload_hi = min(n_round, -(-p_pad // chunk) * chunk)
        slot_g = np.zeros(upload_hi, dtype=np.int32)
        slot_g[:n_post] = slot_real
        slot_g[p_pad:] = s_pad
        if tf16 is not None:
            vals = np.zeros(upload_hi, dtype=np.uint16)
            vals[:n_post] = tf16
            from_tf = True
        else:
            vals = np.zeros(upload_hi, dtype=np.float32)
            vals[:n_post] = ltf_real
            from_tf = False
        dlen_dev = self._put(dlen)
        pack = _pack_init_dev(n=n_round)
        for off in range(0, upload_hi, chunk):
            pack = _pack_update_dev(
                pack, self._put(slot_g[off: off + chunk]),
                self._put(vals[off: off + chunk]),
                dlen_dev, np.int32(off), from_tf=from_tf)
        pack.block_until_ready()
        _log.debug("rebuild: pack upload+build %.1fs (%.1f GB shipped)",
                   time.monotonic() - t_phase,
                   (slot_g.nbytes + vals.nbytes) / 1e9)
        t_phase = time.monotonic()

        adl_build = float((token_count // doc_count) if doc_count else 1.0)
        pack = self._build_prefix(pack, wide, term_starts, counts,
                                  cap=cap, p_pad=p_pad,
                                  adl_build=adl_build)
        self.postings_pack = pack
        self.postings_pack.block_until_ready()
        self._guard_len = n_round - p_pad - prefix_len
        _log.debug("rebuild: impact prefixes %.1fs (%d wide terms)",
                   time.monotonic() - t_phase, len(wide))
        t_phase = time.monotonic()

        # Dense rows for the heaviest terms (device-slot indexed),
        # scattered from the pack ON DEVICE (no host build, no upload).
        term_df_base = counts  # base postings per term (live rows)
        heavy = np.nonzero(term_df_base > s_pad // self.DENSE_DF_DIV)[0]
        row_cap = min(self.MAX_DENSE_ROWS,
                      max(int(self.DENSE_ROWS_MAX_BYTES // (4 * s_pad)), 1))
        if len(heavy) > row_cap:
            # Keep the highest-df terms, then restore ascending term
            # order: _dense_rows_dev maps postings to rows with a
            # searchsorted over h_starts, which MUST be monotone (an
            # unsorted cap selection silently scatters the wrong rows).
            heavy = np.sort(
                heavy[np.argsort(-term_df_base[heavy], kind="stable")
                      [: row_cap]])
        self.dense_row_of = {int(t) + 1: i for i, t in enumerate(heavy)}
        lookup = np.full(self.base_nterms + 1, -1, dtype=np.int32)
        lookup[heavy + 1] = np.arange(len(heavy), dtype=np.int32)
        self.dense_row_lookup = lookup
        h_starts = term_starts[heavy].astype(np.int64)
        h_lens = term_df_base[heavy].astype(np.int64)
        self.dense_rows = _dense_rows_dev(
            self.postings_pack, self._put(h_starts), self._put(h_lens),
            s_pad=s_pad, p_pad=p_pad, n_rows=len(heavy),
            chunk=min(p_pad, 1 << 22))
        _log.debug("rebuild: dense rows %.1fs (%d rows, on device)",
                   time.monotonic() - t_phase, len(heavy))
        t_phase = time.monotonic()
        self.doc_len = dlen_dev
        self.slot_perm = perm
        self._alive_cached = doc_alive
        self._alive_all = bool(self._alive_cached.all())
        self.alive_mask = self._put(
            _pack_alive(self._alive_cached[perm], s_pad))
        self.n_slots = s_pad
        self.n_postings = p_pad
        self._arrival_mark = self.host.p_term.n
        self._slots_mark = self.host.doc_ids.n
        self._removed_since_base = 0
        self.generation = generation
        return True

    def _build_prefix(self, pack, wide, term_starts, counts, *,
                      cap: int, p_pad: int, adl_build: float):
        """Fill the pack's impact-prefix region and publish the
        planner-side metadata (prefix_start_lookup / prefix_tail /
        adl_built).  Wide terms are processed per read-tier in fixed
        nt-per-dispatch chunks (padding terms scatter out of range and
        drop), one executable per tier.  Returns the (donated) pack."""
        from ..ops.scoring import BM25_B, BM25_K1

        lookup = np.full(self.base_nterms + 1, -1, dtype=np.int32)
        tails = np.zeros(self.base_nterms + 1, dtype=np.float32)
        plens = np.zeros(self.base_nterms + 1, dtype=np.int32)
        self.prefix_start_lookup = lookup
        self.prefix_tail = tails
        self.prefix_len = plens
        self.adl_built = adl_build
        self.prefix_cap = cap
        if not len(wide):
            return pack

        lens_w = counts[wide].astype(np.int64)
        tiers = np.asarray([_prefix_tier(int(x), cap) for x in lens_w],
                           dtype=np.int64)
        order = np.lexsort((wide, tiers))
        wide = wide[order]
        lens_w = lens_w[order]
        tiers = tiers[order]
        starts_w = term_starts[wide].astype(np.int64)
        dest = (p_pad + np.arange(len(wide), dtype=np.int64) * cap
                ).astype(np.int32)
        tails_w = np.zeros(len(wide), dtype=np.float32)
        cuts_w = np.zeros(len(wide), dtype=np.int32)
        c1 = np.float32(BM25_K1 * (1.0 - BM25_B))
        c2 = np.float32(BM25_K1 * BM25_B / max(adl_build, 1e-9))
        pack_len = int(pack.shape[0])

        at = 0
        while at < len(wide):
            tier = int(tiers[at])
            hi = at
            while hi < len(wide) and int(tiers[hi]) == tier:
                hi += 1
            # Per-dispatch term count: bound lanes (~2**26) AND the
            # scatter block (nt * cap rows).
            nt = max(1, min((1 << 26) // tier, (1 << 22) // cap))
            for g in range(at, hi, nt):
                ge = min(g + nt, hi)
                n = ge - g
                s_c = np.zeros(nt, dtype=np.int32)
                l_c = np.zeros(nt, dtype=np.int32)
                d_c = np.full(nt, pack_len, dtype=np.int32)
                s_c[:n] = starts_w[g:ge]
                l_c[:n] = lens_w[g:ge]
                d_c[:n] = dest[g:ge]
                pack, t_d, c_d = _prefix_build_dev(
                    pack, self._put(s_c), self._put(l_c),
                    self._put(d_c), c1, c2, tier=tier, cap=cap)
                tails_w[g:ge] = np.asarray(t_d)[:n]
                cuts_w[g:ge] = np.asarray(c_d)[:n]
            at = hi

        lookup[wide + 1] = dest
        tails[wide + 1] = tails_w
        plens[wide + 1] = cuts_w
        return pack

    @property
    def prefix_ready(self) -> bool:
        """True when impact-prefix metadata matches the base snapshot
        (the planner additionally gates on live adl == adl_built)."""
        return (self.prefix_start_lookup is not None
                and self.prefix_cap > 0)

    # -- query-side metadata ----------------------------------------------

    def term_range(self, term_id: int) -> tuple[int, int]:
        """Base-CSR (start, length) of a 1-based term's postings.
        Terms born after the base snapshot have no base postings (their
        occurrences live in the delta)."""
        if term_id > self.base_nterms:
            return 0, 0
        start = int(self.term_starts[term_id - 1])
        end = int(self.term_starts[term_id])
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
        """(counts, slots) of the delta postings of one term.

        Backed by a term-sorted index built once per delta watermark:
        a batched query previously re-scanned the whole delta with a
        boolean mask per (query, term) -- O(batch * terms * delta)
        host work with a warm delta."""
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
