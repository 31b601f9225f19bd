"""Fuzzy term matching: Levenshtein tolerance 2 + popularity pick.

The reference resolves unmatched query tokens via a BK-tree over all
terms searched within Levenshtein tolerance 2 (src/index/idxterm.c:210-
249, src/algo/bktree.c:219, LEVDIST_TOLERANCE src/index/index.h:26) and
selects "the most popular term" among candidates by total occurrence
count (idxterm.c:236-242; only terms with a non-zero live total are
eligible).  Distances are measured over UTF-8 *bytes*, matching
src/algo/levdist.c operating on char.

Two execution paths, identical results:

- **Device** (vocabularies >= _DEVICE_THRESHOLD): bit-parallel Myers
  edit distance over the vocabulary snapshot's length band in one
  sweep (ops/levenshtein.py; on the GPU the fused Pallas kernel of
  ops/pallas/fuzzy.py) -- the device replacement for BK-tree pruning.
  Terms longer than 32 bytes are excluded from the device snapshot;
  they can only match queries >= 31 bytes, which are scanned on the
  host.
- **Host** (small vocabularies or >32-byte query tokens): length-pruned
  banded Wagner-Fischer, mirroring levdist.c.

Ties on the total count pick the lowest (oldest) term ID; the
reference's pick among equals is a BK-tree traversal artifact
(idxterm.c:238 never updates its running max, so the traversal's first
candidate wins) that is not meaningful to reproduce.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .index.hostindex import HostIndex

TOLERANCE = 2

_DEVICE_THRESHOLD = 4096   # below this, host DP beats a device dispatch
_MAX_DEVICE_BYTES = 32


def _platform() -> str:
    import jax
    return jax.devices()[0].platform


# Misses per kernel dispatch.  The kernel keeps Peq and the DP state
# in registers and writes one (key, id) pair per block and query, so a
# large batch costs no device memory.
_KERNEL_BATCH = 64


def _query_rows(n: int, kernel: bool) -> int:
    """Padded query-row count of one device dispatch.  The kernel takes
    a two-rung ladder (its query chunk, or the whole batch), so a
    vocabulary band compiles at most two executables: a padding query
    costs a few loop trips, a compile mid-serving costs the batch.  The
    jnp sweep takes the rows as they are."""
    if not kernel:
        return n
    from .ops.pallas.fuzzy import QUERY_CHUNK
    return QUERY_CHUNK if n <= QUERY_CHUNK else _KERNEL_BATCH


def levdist(a: bytes, b: bytes, cutoff: Optional[int] = None) -> int:
    """Levenshtein distance over bytes (levdist.c semantics).

    With ``cutoff``, returns cutoff+1 early once the distance provably
    exceeds it (band minimum test).
    """
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if cutoff is not None and abs(n - m) > cutoff:
        return cutoff + 1
    # Single-row DP (Wagner-Fischer), row indexed by b.
    row = list(range(m + 1))
    for i in range(1, n + 1):
        prev_diag = row[0]
        row[0] = i
        best = row[0]
        ai = a[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ai == b[j - 1] else 1
            cur = min(row[j] + 1,          # deletion
                      row[j - 1] + 1,      # insertion
                      prev_diag + cost)    # substitution
            prev_diag = row[j]
            row[j] = cur
            if cur < best:
                best = cur
        if cutoff is not None and best > cutoff:
            return cutoff + 1
    return row[m]


class FuzzyMatcher:
    """Per-index fuzzy resolver over the term dictionary."""

    def __init__(self, host: HostIndex, tolerance: int = TOLERANCE):
        self.host = host
        self.tolerance = tolerance
        self._gen = -1
        self._encoded: list[bytes] = []
        self._lengths = np.zeros(0, dtype=np.int32)
        # Device snapshot (built lazily past the threshold).
        self._dev_gen = -1
        self._dev_bytes = None
        self._dev_len = None
        self._dev_total = None

    def _refresh(self) -> None:
        if self._gen == self.host.generation:
            return
        values = self.host.term_values
        start = len(self._encoded)
        if start > len(values):  # pragma: no cover - dictionary never shrinks
            start, self._encoded = 0, []
        self._encoded.extend(v.encode("utf-8") for v in values[start:])
        self._lengths = np.fromiter(
            (len(e) for e in self._encoded), dtype=np.int32,
            count=len(self._encoded))
        self._gen = self.host.generation

    def _refresh_device(self) -> None:
        """Refresh the device vocab snapshot for this generation.

        The snapshot is LENGTH-SORTED: rows ascend by byte length
        (excluded >32-byte terms and padding sink past the end), with
        a per-length offsets table and an original-index column, so a
        query's tolerance band |len(q) - len(t)| <= 2 sweeps ONE
        contiguous region (ops/levenshtein.fuzzy_best_region) instead
        of the whole vocabulary -- the triangle inequality's cheapest
        special case, replacing the BK-tree's child pruning
        (src/algo/bktree.c:219).  The term dictionary is append-only:
        new rows are encoded incrementally into the host cache, and
        the sorted layout rebuilds (host argsort + gather) only when
        terms were added; totals re-upload every generation (a single
        vectorized clip + gather)."""
        import jax

        if self._dev_gen == self._gen:
            return
        n = len(self._encoded)
        t_pad = 1 << max(12, (n - 1).bit_length())
        vb = getattr(self, "_vb_cache", None)
        filled = getattr(self, "_vb_filled", 0)
        if vb is None or len(vb) < t_pad:
            grown = np.zeros((t_pad, _MAX_DEVICE_BYTES), dtype=np.uint8)
            grown_l = np.zeros(t_pad, dtype=np.int32)
            if vb is not None:
                grown[: len(vb)] = vb
                grown_l[: len(vb)] = self._vl_cache
            self._vb_cache, self._vl_cache = grown, grown_l
            vb = grown
        for i in range(filled, n):
            enc = self._encoded[i]
            if len(enc) <= _MAX_DEVICE_BYTES:
                vb[i, : len(enc)] = np.frombuffer(enc, dtype=np.uint8)
                self._vl_cache[i] = len(enc)
        new_terms = n > filled
        self._vb_filled = n

        # The fused kernel is compiled for the GPU only; every other
        # platform sweeps with the jnp path.
        self._kernel = _platform() == "gpu"
        if new_terms or self._dev_bytes is None \
                or getattr(self, "_t_pad", 0) != t_pad:
            # Sort key: byte length for device-eligible rows; >32-byte
            # terms (length 0 in the cache) key past every band.
            lens = self._vl_cache[:n].astype(np.int64)
            key = np.where(lens > 0, lens, 99)
            order = np.argsort(key, kind="stable")
            # off[L] = first sorted row of length >= L (L in 0..34);
            # off[33] ends the device-eligible rows.
            self._len_off = np.searchsorted(key[order], np.arange(35))
            self._dev_order = order
            vb_s = np.zeros((t_pad, _MAX_DEVICE_BYTES), dtype=np.uint8)
            vb_s[:n] = vb[:n][order]
            vl_s = np.zeros(t_pad, dtype=np.int32)
            vl_s[:n] = np.where(key[order] <= _MAX_DEVICE_BYTES,
                                lens[order], 0)
            ids = np.full(t_pad, 0x7FFFFFFF, dtype=np.int32)
            ids[:n] = order.astype(np.int32)
            # The kernel reads the position-major layout (one coalesced
            # row per byte position); the jnp sweep the row-major one.
            if self._kernel:
                self._dev_bytes = jax.device_put(
                    np.ascontiguousarray(vb_s.T))
            else:
                self._dev_bytes = jax.device_put(vb_s)
            self._dev_len = jax.device_put(vl_s)
            self._dev_ids = jax.device_put(ids)
            self._t_pad = t_pad
        totals = np.clip(self.host.term_total.view(), 0,
                         0xFFFFFFFF).astype(np.uint32)
        vt = np.zeros(t_pad, dtype=np.uint32)
        vt[:n] = totals[self._dev_order]
        self._dev_total = jax.device_put(vt)
        self._dev_gen = self._gen

    def _region(self, q_len: int) -> tuple[int, int]:
        """Sorted-row region covering the tolerance band of a query
        length: (lo, W) with W a static pow2 bucket.  Any superset is
        correct (out-of-band rows are beyond tolerance by
        construction), so clamping and pow2 padding are free."""
        tol = self.tolerance
        lo = int(self._len_off[max(q_len - tol, 1)])
        hi = int(self._len_off[min(q_len + tol, _MAX_DEVICE_BYTES) + 1])
        need = max(hi - lo, 1)
        from .ops.pallas.fuzzy import BLOCK_TERMS
        w = BLOCK_TERMS          # floor: one kernel block
        while w < need:
            w <<= 1
        w = min(w, self._t_pad)
        lo = max(min(lo, self._t_pad - w), 0)
        return lo, w

    # -- host path ---------------------------------------------------------

    def _host_best(self, q: bytes, indexes) -> tuple[Optional[int], int]:
        """(best_term_id, best_total) over the given candidate rows."""
        tol = self.tolerance
        totals = self.host.term_total.view()
        best_id = None
        best_total = 0
        for idx in indexes:
            total = int(totals[idx])
            if total <= 0:
                continue  # no live occurrences: never selected
            if best_id is not None and (
                    total < best_total or
                    (total == best_total and idx + 1 > best_id)):
                continue  # cannot beat the current pick; skip the DP
            if levdist(q, self._encoded[idx], cutoff=tol) <= tol:
                best_id = int(idx) + 1
                best_total = total
        return best_id, best_total

    # -- public ------------------------------------------------------------

    def prefetch(self, values) -> None:
        """Resolve many tokens with one batched device dispatch.

        Results land in a per-generation memo consulted by lookup(),
        so a batch pays one dispatch per length-band chunk instead of
        one per token.  Tokens outside the device snapshot's limits
        resolve through the host path as usual.
        """
        self._refresh()
        memo = self._memo()
        pending = []
        for value in values:
            if value in memo:
                continue
            q = value.encode("utf-8")
            if (len(self._encoded) >= _DEVICE_THRESHOLD
                    and 0 < len(q) <= _MAX_DEVICE_BYTES
                    and len(q) < _MAX_DEVICE_BYTES - self.tolerance + 1):
                pending.append((value, q))
            else:
                memo[value] = self.lookup(value)
        if not pending:
            return
        import jax.numpy as jnp

        from .ops.levenshtein import fuzzy_best_region
        from .utils.trace import phase
        with phase("fuzzy.refresh_device"):
            self._refresh_device()
        # Chunked.  The jnp sweep's vmapped Peq matrix is M x W x 32
        # u32 (1 GB at M=8 over a 1M-row region), capping its chunk at
        # 8; the kernel takes whole batches (_KERNEL_BATCH).
        chunk = _KERNEL_BATCH if self._kernel else 8
        # Group misses by their length band's sorted-row region: each
        # group sweeps only rows within tolerance of its query length.
        regions: dict[tuple[int, int], list] = {}
        for value, q in pending:
            regions.setdefault(self._region(len(q)), []).append(
                (value, q))
        # Dispatch every chunk first (async), then fetch all results
        # in one consolidated transfer (one device->host copy per
        # batch, not one per chunk).
        launched: list = []
        import time as _time
        _t0 = _time.perf_counter()
        for (lo, w), group in regions.items():
            for at in range(0, len(group), chunk):
                part = group[at: at + chunk]
                rows = _query_rows(len(part), self._kernel)
                qb = np.zeros((rows, _MAX_DEVICE_BYTES), dtype=np.uint8)
                ql = np.zeros(rows, dtype=np.int32)
                for i, (_, q) in enumerate(part):
                    qb[i, : len(q)] = np.frombuffer(q, dtype=np.uint8)
                    ql[i] = len(q)
                idxs = fuzzy_best_region(
                    self._dev_bytes, self._dev_len, self._dev_total,
                    self._dev_ids, jnp.asarray(qb), jnp.asarray(ql),
                    jnp.int32(lo), W=w, tolerance=self.tolerance,
                    kernel=self._kernel)
                launched.append((part, idxs))
        _t1 = _time.perf_counter()
        if len(launched) == 1:
            parts_idxs = [np.asarray(launched[0][1])]
        else:
            flat = np.asarray(jnp.concatenate(
                [ix for _, ix in launched]))
            parts_idxs = []
            at = 0
            for part, ix in launched:
                parts_idxs.append(flat[at: at + ix.shape[0]])
                at += ix.shape[0]
        from .utils.log import get_logger
        _log = get_logger("trace")
        if _log.isEnabledFor(10):
            _log.debug("fuzzy.prefetch: %d misses, %d chunks, "
                       "dispatch %.1f ms, fetch %.1f ms",
                       len(pending), len(launched),
                       (_t1 - _t0) * 1e3,
                       (_time.perf_counter() - _t1) * 1e3)
        for (part, _), idxs in zip(launched, parts_idxs):
            for i, (value, _) in enumerate(part):
                best = int(idxs[i])
                memo[value] = best + 1 if best >= 0 else None

    def _memo(self) -> dict:
        memo = getattr(self, "_memo_cache", None)
        if memo is None or self._memo_gen != self._gen:
            memo = {}
            self._memo_cache = memo
            self._memo_gen = self._gen
        return memo

    def lookup(self, value: str) -> Optional[int]:
        """Best term within tolerance, or None (idxterm_fuzzysearch)."""
        self._refresh()
        if not self._encoded:
            return None
        memo = self._memo()
        if value in memo:
            return memo[value]
        q = value.encode("utf-8")
        tol = self.tolerance

        use_device = (len(self._encoded) >= _DEVICE_THRESHOLD
                      and len(q) <= _MAX_DEVICE_BYTES)
        if use_device:
            import jax.numpy as jnp

            from .ops.levenshtein import fuzzy_best_region
            self._refresh_device()
            lo, w = self._region(len(q))
            rows = _query_rows(1, self._kernel)
            qb = np.zeros((rows, _MAX_DEVICE_BYTES), dtype=np.uint8)
            ql = np.zeros(rows, dtype=np.int32)
            qb[0, : len(q)] = np.frombuffer(q, dtype=np.uint8)
            ql[0] = len(q)
            idxs = fuzzy_best_region(
                self._dev_bytes, self._dev_len, self._dev_total,
                self._dev_ids, jnp.asarray(qb), jnp.asarray(ql),
                jnp.int32(lo), W=w, tolerance=tol, kernel=self._kernel)
            best_idx = int(np.asarray(idxs)[0])
            best_id = best_idx + 1 if best_idx >= 0 else None
            best_total = int(self.host.term_total.view()[best_idx]) \
                if best_idx >= 0 else 0
            # Terms wider than the device snapshot can only be within
            # tolerance of queries >= 31 bytes: host-scan just those.
            if len(q) >= _MAX_DEVICE_BYTES - tol + 1:
                long_rows = np.nonzero(
                    self._lengths > _MAX_DEVICE_BYTES)[0]
                if len(long_rows):
                    h_id, h_total = self._host_best(q, long_rows)
                    if h_id is not None and (
                            best_id is None or h_total > best_total or
                            (h_total == best_total and h_id < best_id)):
                        best_id = h_id
            memo[value] = best_id
            return best_id

        near = np.nonzero(np.abs(self._lengths - len(q)) <= tol)[0]
        best_id, _total = self._host_best(q, near)
        memo[value] = best_id
        return best_id
