"""Sub-stage timing of _postsort_accumulate at chunk shape (E=16.8M,
U=8.4M): which of the E-scatters / ST4 row-gathers / claims / winner ops
hold the remaining ~1.6 s."""
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

E = 16_777_216
U = 8_388_608
CLAIM = 1 << 25
NTID = 167_490
NFL = 300

rng = np.random.default_rng(0)


def sync(x):
    return np.asarray(jax.tree_util.tree_leaves(x)[0].ravel()[:1])


ready = jnp.zeros(8, jnp.int32)
sync(ready)
t0 = time.perf_counter()
for _ in range(10):
    sync(ready)
RTT = (time.perf_counter() - t0) / 10
print(f"RTT {RTT*1e3:.0f} ms", flush=True)


def timeit(name, fn, *args, reps=3):
    sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        sync(fn(*args))
    dt = (time.perf_counter() - t0) / reps - RTT
    print(f"{name}: {dt*1e3:.1f} ms", flush=True)


start = jnp.asarray(rng.random(E) < 0.6)
d_ind = jnp.asarray(rng.integers(0, NFL, E, dtype=np.int32))
tid = jnp.asarray(rng.integers(0, NTID, E, dtype=np.uint32))
rec = jnp.asarray(rng.random(E) < 0.28)
sgu = jnp.arange(E, dtype=jnp.uint32)
rec_idx = jnp.asarray(np.sort(rng.integers(0, E, U, dtype=np.int32)))
rend = jnp.minimum(rec_idx + 3, E - 1)
r1 = jnp.asarray(rng.integers(0, 1 << 32, U, dtype=np.uint64)
                 .astype(np.uint32))
r2 = jnp.asarray(rng.integers(0, 1 << 32, U, dtype=np.uint64)
                 .astype(np.uint32))
rsg = jnp.asarray(rng.integers(0, E, U, dtype=np.int64).astype(np.uint32))
sync(rsg)


@jax.jit
def e_scans(start, d_ind, tid):
    from emsar_jax.index.device_build import _run_bounds, _sig_lanes
    i = jnp.arange(E, dtype=jnp.int32)
    my_start, next_start = _run_bounds(start)
    cntr = next_start - i
    prev_d = jnp.concatenate([jnp.zeros(1, d_ind.dtype), d_ind[:-1]])
    bad_pair = (~start) & (d_ind != prev_d)
    badS = jnp.cumsum(bad_pair.astype(jnp.uint32), dtype=jnp.uint32)
    l1, l2, l3 = _sig_lanes(tid.astype(jnp.int32))
    ST4 = jnp.concatenate([
        jnp.zeros((1, 4), jnp.uint32),
        jnp.stack([badS, jnp.cumsum(l1, dtype=jnp.uint32),
                   jnp.cumsum(l2, dtype=jnp.uint32),
                   jnp.cumsum(l3, dtype=jnp.uint32)], axis=1)])
    return ST4, cntr


timeit("E scans + ST4 build", e_scans, start, d_ind, tid)
ST4, _ = e_scans(start, d_ind, tid)
sync(ST4)


@jax.jit
def e_scatter1(rec, sgu):
    rdst = jnp.where(rec, jnp.cumsum(rec.astype(jnp.int32)) - 1, U)
    return jnp.zeros(U, jnp.uint32).at[rdst].set(sgu, mode="drop",
                                                 unique_indices=True)


timeit("1 E-driven compaction scatter", e_scatter1, rec, sgu)


@jax.jit
def e_dense_scatter(rec, tid, d_ind):
    return jnp.zeros(NTID * NFL, jnp.int32).at[
        jnp.where(rec, tid.astype(jnp.int32) * NFL + d_ind,
                  NTID * NFL)].add(1, mode="drop")


timeit("dense E-scatter-add", e_dense_scatter, rec, tid, d_ind)


@jax.jit
def row_gathers(ST4, rec_idx, rend):
    return ST4[rend + 1], ST4[rec_idx]


timeit("2x [U,4] row gathers", row_gathers, ST4, rec_idx, rend)


@jax.jit
def claims_block(r1, r2, rsg):
    claim_mask = CLAIM - 1
    c1 = jnp.full(CLAIM, 0xFFFFFFFF, jnp.uint32)
    c2 = jnp.full(CLAIM, 0xFFFFFFFF, jnp.uint32)
    c3 = jnp.full(CLAIM, 0xFFFFFFFF, jnp.uint32)
    r12 = (r1 >> jnp.uint32(16)) | (r2 << jnp.uint32(16))
    s1 = (r1 & jnp.uint32(claim_mask)).astype(jnp.int32)
    s2 = (r2 & jnp.uint32(claim_mask)).astype(jnp.int32)
    s3 = (r12 & jnp.uint32(claim_mask)).astype(jnp.int32)
    c1 = c1.at[s1].min(rsg, mode="drop")
    c2 = c2.at[s2].min(rsg, mode="drop")
    c3 = c3.at[s3].min(rsg, mode="drop")
    win = ((c1[s1] == rsg) | (c2[s2] == rsg) | (c3[s3] == rsg))
    return jnp.sum(win, dtype=jnp.int32)


timeit("claims block (3 scatter-min + 3 gathers)", claims_block, r1, r2,
       rsg)


@jax.jit
def win_scatter(rec_idx):
    win = rec_idx % 17 == 0
    wdst = jnp.where(win, jnp.cumsum(win.astype(jnp.int32)) - 1, U)
    return jnp.full(U, U - 1, jnp.int32).at[wdst].set(
        jnp.arange(U, dtype=jnp.int32), mode="drop", unique_indices=True)


timeit("winner compaction scatter (U)", win_scatter, rec_idx)


@jax.jit
def append_block4(r1, r2):
    buf = jnp.zeros(1 << 26, jnp.uint32)
    o1 = jax.lax.dynamic_update_slice(buf, r1, (0,))
    o2 = jax.lax.dynamic_update_slice(buf, r2, (0,))
    return o1[0] + o2[0]


timeit("2x U contiguous appends", append_block4, r1, r2)
print("done", flush=True)
