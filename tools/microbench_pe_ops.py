"""Microbench of the exact op mix inside one PE expansion chunk.

Sizes mirror the bench workload chunk: E = MV*nfl = 16.7M candidates,
MV = 1.5M mate1 rows, nfl = 11.  Answers: where do the ~2 s/chunk go —
the 2D row-contiguous gather, the 3-operand sort, the cumulative scans,
the E-driven scatters, or dispatch overhead?
"""
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp

from emsar_jax.utils import jitcache
jitcache.enable()

NFL = 11
MV = 1 << 20 + 0
MV = 1526 * 1024 // 1024 * 1024  # ~1.5M
MV = 1_526_784  # multiple of 128
E = MV * NFL
LP = 1 << 24


def sync(out):
    leaf = jax.tree_util.tree_leaves(out)[0]
    return np.asarray(leaf.ravel()[:1])


rng = np.random.default_rng(0)
ready = jnp.zeros(8, jnp.int32)
sync(ready)
t0 = time.perf_counter()
for _ in range(10):
    sync(ready)
RTT = (time.perf_counter() - t0) / 10
print(f"RTT: {RTT*1e3:.1f} ms  E={E/1e6:.1f}M", flush=True)


def timeit(name, fn, *args, reps=3, n=E):
    sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        sync(out)
    dt = (time.perf_counter() - t0) / reps - RTT
    print(f"{name}: {dt*1e3:.1f} ms  ({n/max(dt,1e-9)/1e6:.0f} M elems/s)",
          flush=True)


R = jnp.asarray(rng.integers(0, 1 << 24, LP, dtype=np.uint32))
base = jnp.asarray(np.sort(rng.integers(0, LP - NFL - 1, MV,
                                        dtype=np.int32)))
dd = jnp.arange(NFL, dtype=jnp.int32)


@jax.jit
def gather2d(R, base):
    return R[base[:, None] + dd[None, :]]


timeit("2D row-contig gather [1.5M,11]", gather2d, R, base)


@jax.jit
def gather_flat(R, idx):
    return R[idx]


flatidx = jnp.asarray(rng.integers(0, LP, E, dtype=np.int32))
timeit("flat random gather E", gather_flat, R, flatidx)

k1 = jnp.asarray(rng.integers(0, 1 << 20, E, dtype=np.uint32))
k2 = jnp.asarray(rng.integers(0, 1 << 24, E, dtype=np.uint32))
pay = jnp.asarray(rng.integers(0, 1 << 31, E, dtype=np.uint32))


@jax.jit
def sort3(a, b, c):
    return jax.lax.sort((a, b, c), num_keys=2, is_stable=False)


timeit("sort3 E (2keys+payload)", sort3, k1, k2, pay)


@jax.jit
def cumsum1(x):
    return jnp.cumsum(x.astype(jnp.int32))


timeit("cumsum E i32", cumsum1, pay)


@jax.jit
def cummax1(x):
    return jax.lax.cummax(x.astype(jnp.int32))


timeit("cummax E i32", cummax1, pay)


@jax.jit
def runbounds(start):
    E_ = start.shape[0]
    i = jnp.arange(E_, dtype=jnp.int32)
    my_start = jax.lax.cummax(jnp.where(start, i, -1))
    incl = jax.lax.cummin(jnp.where(start, i, jnp.int32(E_)), reverse=True)
    next_start = jnp.concatenate([incl[1:], jnp.full(1, E_, jnp.int32)])
    return my_start, next_start


startf = jnp.asarray(rng.random(E) < 0.4)
timeit("_run_bounds E", runbounds, startf)


@jax.jit
def scatter_drop(idx, val):
    return jnp.zeros(1 << 22, jnp.int32).at[idx].set(
        val, mode="drop", unique_indices=True)


scidx = jnp.asarray(rng.integers(0, 1 << 22, E, dtype=np.int32))
vals = jnp.asarray(rng.integers(0, 1 << 30, E, dtype=np.int32))
timeit("E-driven scatter (set, drop) -> 4M", scatter_drop, scidx, vals)


@jax.jit
def scatter_add_small(idx):
    return jnp.zeros(1 << 18, jnp.int32).at[idx].add(1, mode="drop")


scidx2 = jnp.asarray(rng.integers(0, 1 << 18, E, dtype=np.int32))
timeit("E-driven scatter-add -> 256K", scatter_add_small, scidx2)


@jax.jit
def lanes3(tid):
    from emsar_jax.index.device_build import _sig_lanes
    l1, l2, l3 = _sig_lanes(tid)
    return l1 + l2 + l3


timeit("3x sig lanes E (elementwise)", lanes3, pay)


@jax.jit
def elementwise20(x):
    y = x
    for _ in range(20):
        y = y * jnp.uint32(0x9E3779B1) ^ (y >> jnp.uint32(13))
    return y


timeit("20 fused elementwise E", elementwise20, pay)


# a full-chunk composite: gather + sort + run machinery, fused in one jit
@jax.jit
def composite(R, base, pay):
    rw = R[base[:, None] + dd[None, :]]
    ckey = jnp.broadcast_to(base.astype(jnp.uint32)[:, None],
                            (MV, NFL)).reshape(-1)
    rkey = rw.reshape(-1)
    sck, srk, spay = jax.lax.sort((ckey, rkey, pay), num_keys=2,
                                  is_stable=False)
    startf = jnp.concatenate(
        [jnp.ones(1, bool), (sck[1:] != sck[:-1]) | (srk[1:] != srk[:-1])])
    my_start, next_start = runbounds(startf)
    i = jnp.arange(E, dtype=jnp.int32)
    cntr = next_start - i
    rec = startf & (cntr > 1) & (cntr < 100)
    return jnp.sum(rec, dtype=jnp.int32), spay[0]


timeit("composite gather+sort+runs", composite, R, base, pay)
print("done", flush=True)
