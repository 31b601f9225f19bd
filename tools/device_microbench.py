"""Device primitive microbenchmarks for executor design decisions.

Measures on the GPU (or the CPU with JAX_PLATFORMS=cpu):
  - dispatch + fetch round-trip floor (tiny jitted fn)
  - lax.sort ns/lane at executor-relevant plane shapes, 2 and 3 operands
  - lax.top_k ns/lane at head-plane shapes
  - vmapped searchsorted (the head-merge primitive) ns/lane
  - contiguous window fetch bandwidth (_sliced_fetch shape)
  - sliced_topk end-to-end at the measured 8.8M-mix group shapes

Every timing is min-of-3 after a warmup call; arrays are passed as
arguments, never closed over.  Every line of output is a time on the
device named in the first lines (with the card's name and power limit
from nvidia-smi when there is one).  Run alone -- one JAX process per
card.

Usage: python tools/device_microbench.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from nxsearch_tpu.utils.malloc import tune_host_allocator

tune_host_allocator(prefault_mb=2048)

import jax
import jax.numpy as jnp
from jax import lax

from nxsearch_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


def timed(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import subprocess

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {getattr(dev, 'device_kind', '?')}",
          flush=True)
    if dev.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout
        print(f"card: {card.splitlines()[0].strip()}", flush=True)
    rng = np.random.default_rng(7)

    # 1. dispatch+fetch floor
    one = jnp.ones((8, 8), jnp.float32)
    f_tiny = jax.jit(lambda x: x + 1.0)
    t = timed(f_tiny, one)
    print(f"tiny dispatch+sync: {t * 1e3:.2f} ms", flush=True)
    # fetch (device->host) of a k-sized result
    r = f_tiny(one)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    np.asarray(r)
    print(f"tiny fetch: {(time.perf_counter() - t0) * 1e3:.2f} ms",
          flush=True)

    # 2. sort ns/lane
    f_sort2 = jax.jit(lambda k, v: lax.sort((k, v), dimension=1,
                                            num_keys=1))
    f_sort3 = jax.jit(lambda k, v, b: lax.sort((k, v, b), dimension=1,
                                               num_keys=1))
    for n_rows, width in [(664, 16384), (115, 32768), (64, 131072),
                          (8, 1048576)]:
        k = jnp.asarray(rng.random((n_rows, width), np.float32))
        v = jnp.asarray(rng.random((n_rows, width), np.float32))
        b = jnp.asarray(rng.integers(0, 2**31, (n_rows, width)),
                        dtype=jnp.uint32)
        lanes = n_rows * width
        t2 = timed(f_sort2, k, v)
        t3 = timed(f_sort3, k, v, b)
        print(f"sort [{n_rows},{width}]: 2-op {t2 * 1e3:.2f} ms "
              f"({t2 / lanes * 1e9:.2f} ns/lane), 3-op {t3 * 1e3:.2f} ms "
              f"({t3 / lanes * 1e9:.2f} ns/lane)", flush=True)

    # 3. top_k ns/lane
    f_topk = jax.jit(lambda x: lax.top_k(x, 16))
    for n_rows, width in [(664, 65536), (40, 1048576), (664, 16384)]:
        x = jnp.asarray(rng.random((n_rows, width), np.float32))
        t = timed(f_topk, x)
        lanes = n_rows * width
        print(f"top_k16 [{n_rows},{width}]: {t * 1e3:.2f} ms "
              f"({t / lanes * 1e9:.2f} ns/lane)", flush=True)

    # 4. vmapped searchsorted: tail plane into head slice
    f_ss = jax.jit(jax.vmap(
        lambda a, v: jnp.searchsorted(a, v, side="left")))
    for n_rows, t_head, flat in [(664, 65536, 16384), (40, 1048576, 16384),
                                 (664, 8192, 4096)]:
        a = jnp.asarray(np.sort(rng.random((n_rows, t_head), np.float32)))
        v = jnp.asarray(rng.random((n_rows, flat), np.float32))
        t = timed(f_ss, a, v)
        lanes = n_rows * flat
        print(f"searchsorted [{n_rows},{flat}]->[{t_head}]: "
              f"{t * 1e3:.2f} ms ({t / lanes * 1e9:.2f} ns/lane)",
              flush=True)

    # 5. contiguous window fetch (the _sliced_fetch shape)
    P = 64 << 20
    pack = jnp.asarray(rng.random((P, 3), np.float32))

    def fetch(pack_, starts):
        def one(s):
            return lax.dynamic_slice(pack_, (s, 0), (4096, 3))
        return jax.vmap(jax.vmap(one))(starts)

    f_fetch = jax.jit(fetch)
    starts = jnp.asarray(
        rng.integers(0, P - 4096, (664, 4), dtype=np.int32))
    t = timed(f_fetch, pack, starts)
    gb = 664 * 4 * 4096 * 12 / 1e9
    print(f"window fetch [664,4]x4096x3: {t * 1e3:.2f} ms "
          f"({gb / t:.0f} GB/s)", flush=True)

    # 6. sliced executor at the measured 8.8M-mix bulk shapes
    from nxsearch_tpu.ops.executor import (device_search_sliced_packed,
                                           pack_sliced_group)
    S_pad = 9_437_184
    alive = jnp.full((S_pad // 32,), 0xFFFFFFFF, jnp.uint32)
    doc_len = jnp.asarray(rng.random(S_pad, np.float32) * 100 + 5)
    adl = jnp.float32(60.0)
    shapes = [
        ("bulk qs4 h0", 664, 4, 0, 2),
        ("qs8 h0", 128, 8, 0, 4),
        ("qs16 h0", 32, 16, 0, 4),
        ("qs4 h1M", 40, 4, 1 << 20, 2),
        # 2-term sort-free alternative for the bulk group: bigger term
        # as head (65536 plane), smaller as a single sorted window
        # column -- n_run 1 skips the plane sort entirely.
        ("2term qs1 h64k", 664, 1, 65536, 1),
        ("2term qs1 h8k", 664, 1, 8192, 1),
    ]
    for label, n, qs, h_T, n_run in shapes:
        n_pad = n
        sl_start = rng.integers(0, P - (1 << 20) - 4096,
                                (n_pad, qs)).astype(np.int32)
        sl_len = np.full((n_pad, qs), 4096, np.int32)
        sl_idf = np.ones((n_pad, qs), np.float32)
        hargs = {}
        if h_T:
            hs = rng.integers(0, P - (1 << 20) - 4096, n_pad
                              ).astype(np.int32)
            hargs = dict(h_start=hs,
                         h_len=np.full(n_pad, h_T // 2, np.int32),
                         h_idf=np.ones(n_pad, np.float32),
                         h_row=np.zeros(n_pad, np.int32),
                         h_pass=np.ones(n_pad, np.bool_))
        buf = pack_sliced_group(sl_start, sl_len, sl_idf, **hargs)

        def run(pack_, alive_, dl_, buf_, adl_, qs=qs, h_T=h_T,
                n_run=n_run):
            return device_search_sliced_packed(
                pack_, alive_, dl_, buf_, adl_, None,
                qs=qs, L=1, D=4, T=4096, k=16, algo=0,
                n_slots=S_pad, use_mask=False, single=False,
                alive_all=True, use_rows=False, depth=4,
                T_head=h_T, n_run=n_run)

        t = timed(run, pack, alive, doc_len, jnp.asarray(buf), adl)
        print(f"sliced {label} [{n} rows]: {t * 1e3:.2f} ms "
              f"({t / n * 1e6:.0f} us/row)", flush=True)


if __name__ == "__main__":
    main()
