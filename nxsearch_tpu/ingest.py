"""Parallel bulk ingest: N writer processes over one index.

The journal protocol is multi-process safe by construction (flock +
commit-pointer publish, index/storage.py; the same protocol the
reference exercises with t_stress_terms.c / t_stress_dtmap.c), so
ingest parallelism needs no new machinery: each worker opens its OWN
handle over the shared basedir and streams ``add_many`` batches.
Tokenization (the CPU-bound phase) runs genuinely in parallel; journal
appends serialize briefly under the file lock.

Document *texts never cross process boundaries*: the caller supplies a
picklable ``source(lo, hi) -> iterable[(doc_id, text)]`` callable and
each worker materializes only its own range -- the natural shape for
corpus files, databases, or generators.

No reference equivalent (the C engine has no bulk API; its multi-
process story is concurrent independent writers, nxs.c:490).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback
from typing import Callable, Iterable, Optional, Tuple

DocSource = Callable[[int, int], Iterable[Tuple[int, str]]]


def _worker(basedir: str, index_name: str, source: DocSource,
            ranges: list, chunk: int, errq) -> None:
    try:
        # Workers never need an accelerator, and a worker that opened
        # the parent's GPU would reserve its memory: pin the CPU
        # outright (the parent set JAX_PLATFORMS for the spawn too).
        import jax
        jax.config.update("jax_platforms", "cpu")
        from .nxs import Nxs
        from .utils.malloc import tune_host_allocator
        tune_host_allocator(prefault_mb=128)

        nxs = Nxs(basedir)
        idx = nxs.index_open(index_name)
        try:
            for lo, hi in ranges:
                batch = []
                for doc in source(lo, hi):
                    batch.append(doc)
                    if len(batch) >= chunk:
                        idx.add_many(batch)
                        batch.clear()
                if batch:
                    idx.add_many(batch)
        finally:
            nxs.close()
    except BaseException:  # surfaced in the parent
        errq.put(traceback.format_exc())
        raise


def parallel_ingest(basedir: str, index_name: str, source: DocSource,
                    n_docs: int, *, workers: Optional[int] = None,
                    chunk: int = 2048, stripe: int = 16_384) -> None:
    """Ingest ``n_docs`` documents with ``workers`` processes.

    ``source(lo, hi)`` yields the ``(doc_id, text)`` pairs of the
    half-open range ``[lo, hi)`` in the caller's numbering; ranges are
    striped across workers so skewed document lengths balance.  The
    batch-atomicity unit is ``chunk`` documents (one journal lock
    round-trip each, like add_many).  Raises if any worker fails; the
    journals then contain every batch committed before the failure
    (append-before-publish -- partial ingest is visible, never torn).
    """
    if workers is None:
        workers = min(max(os.cpu_count() or 1, 1), 8)
    if n_docs <= 0:
        return
    if workers <= 1 or n_docs <= chunk:
        from .nxs import Nxs

        nxs = Nxs(basedir)
        idx = nxs.index_open(index_name)
        try:
            batch = []
            for doc in source(0, n_docs):
                batch.append(doc)
                if len(batch) >= chunk:
                    idx.add_many(batch)
                    batch.clear()
            if batch:
                idx.add_many(batch)
        finally:
            nxs.close()
        return

    per = [list() for _ in range(workers)]
    at = 0
    i = 0
    while at < n_docs:
        hi = min(at + stripe, n_docs)
        per[i % workers].append((at, hi))
        at = hi
        i += 1

    ctx = mp.get_context("spawn")
    errq = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(basedir, index_name, source, ranges,
                               chunk, errq))
             for ranges in per if ranges]
    # Spawned children copy this environment: JAX_PLATFORMS=cpu is in
    # place before their first JAX import, so no worker opens the GPU
    # that this process may hold (one JAX process per card).
    saved = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        for p in procs:
            p.start()
    finally:
        if saved is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = saved
    for p in procs:
        p.join()
    failures = []
    while not errq.empty():
        failures.append(errq.get())
    if failures or any(p.exitcode != 0 for p in procs):
        detail = ("\n".join(failures)
                  or f"exit codes {[p.exitcode for p in procs]}")
        raise RuntimeError(f"parallel ingest failed:\n{detail}")
