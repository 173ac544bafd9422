"""Device kernels for index construction.

The hot operation is "group N read-length windows by sequence identity" —
the device replacement for the reference's strncmp quicksort + linear
scan (reference src/emsar_functions.c:1108-1149, 1758-1819).

Design: the packed 16-mer array P16 lives on the device; window keys are
gathered per chunk, reduced to a 128-bit multilinear hash (4 x uint32
lanes, 32-bit arithmetic), and grouped with a 5-operand
``jax.lax.sort`` — cost independent of read length.  Two windows collide
only if all four independent 32-bit hashes collide (< 2^-128 per pair, far
below hardware error rates); the byte-exact golden tests against the
reference binary falsify any collision on test data.

Everything data-sized stays on device; only the sorted position order and
run ids return to the host.

A NumPy path with identical semantics is kept for differential testing.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import pack

# fixed random odd multipliers for the 4 hash lanes (position-dependent)
_HASH_SEED = 0x9E3779B97F4A7C15
_MAX_WORDS = 64  # supports read lengths up to 1024


def _multipliers() -> np.ndarray:
    rng = np.random.default_rng(_HASH_SEED)
    m = rng.integers(0, 1 << 32, size=(4, _MAX_WORDS), dtype=np.uint32)
    return m | 1  # odd


_MULT = _multipliers()


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------
# device-side window keys + hashes
# --------------------------------------------------------------------------


def _gather_words(p16, positions, n_words: int, readlength: int):
    """[N, W] uint32 window key words from the device-resident P16."""
    cols = []
    for w in range(n_words):
        cols.append(p16[positions + 16 * w])
    words = jnp.stack(cols, axis=1)
    rem = readlength - 16 * (n_words - 1)
    if rem < 16:
        shift = jnp.uint32(2 * (16 - rem))
        words = words.at[:, n_words - 1].set(words[:, n_words - 1] >> shift)
    return words


def _lexmin(a, b):
    """Row-wise lexicographic min of two [N, W] uint32 word matrices and
    the comparison sign (a vs b) in {-1, 0, 1}."""
    cmp = jnp.zeros(a.shape[0], jnp.int8)
    for w in range(a.shape[1]):
        c = (a[:, w] > b[:, w]).astype(jnp.int8) - \
            (a[:, w] < b[:, w]).astype(jnp.int8)
        cmp = jnp.where(cmp == 0, c, cmp)
    return cmp, jnp.where((cmp <= 0)[:, None], a, b)


def _hash4(words, mult):
    """[N, 4] uint32 multilinear hashes of [N, W] word rows."""
    W = words.shape[1]
    out = []
    for lane in range(4):
        acc = jnp.zeros(words.shape[0], jnp.uint32)
        for w in range(W):
            acc = acc + words[:, w] * mult[lane, w]
            acc = acc ^ (acc >> jnp.uint32(16)) * jnp.uint32(0x85EBCA6B)
        out.append(acc)
    return jnp.stack(out, axis=1)


@functools.partial(jax.jit,
                   static_argnames=("n_words", "readlength", "stranded"))
def _se_hash_jax(p16, positions, mult, flip_base,
                 n_words: int, readlength: int, stranded: bool):
    """Hash-only variant: returns ([N,4] uint32 hashes, canon flags) with
    no device sort — grouping happens in the host C++ hash table."""
    pos = positions.astype(jnp.int64)
    fw = _gather_words(p16, pos, n_words, readlength)
    if stranded:
        words = fw
        canon = jnp.ones(pos.shape[0], jnp.int32)
    else:
        rc = _gather_words(p16, flip_base - pos, n_words, readlength)
        cmp, words = _lexmin(fw, rc)
        canon = (cmp <= 0).astype(jnp.int32)
    return _hash4(words, mult), canon


@functools.partial(jax.jit,
                   static_argnames=("n_words", "readlength", "stranded"))
def _se_group_jax(p16, positions, valid, mult, flip_base,
                  n_words: int, readlength: int, stranded: bool):
    """Group windows by (canonical) sequence.  positions int32 [Np]
    (padded), valid bool [Np].  Returns (sorted positions, run_id,
    fw_is_canonical flags sorted)."""
    pos = positions.astype(jnp.int64)
    fw = _gather_words(p16, pos, n_words, readlength)
    if stranded:
        words = fw
        canon = jnp.ones(pos.shape[0], jnp.int32)
    else:
        rc = _gather_words(p16, flip_base - pos, n_words, readlength)
        cmp, words = _lexmin(fw, rc)
        canon = (cmp <= 0).astype(jnp.int32)
    h = _hash4(words, mult)
    padkey = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))
    operands = (padkey,) + tuple(h[:, k] for k in range(4)) + \
        (positions, canon)
    out = jax.lax.sort(operands, num_keys=5, is_stable=True)
    keys = jnp.stack(out[:5], axis=1)
    diff = jnp.any(keys[1:] != keys[:-1], axis=1)
    run_id = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(diff.astype(jnp.int32))])
    return out[5], run_id, out[6]


def se_group(p16_dev, positions: np.ndarray, seqlength: int,
             readlength: int, stranded: bool, backend: str = "jax"
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group window positions by (canonical) window sequence.

    Returns (positions sorted by group, run_id, fw_is_canonical flags).
    """
    N = positions.shape[0]
    if N == 0:
        z = np.zeros(0, dtype=np.int32)
        return positions, z, z
    W = pack.n_words(readlength)
    if backend == "hybrid":
        # device hashes + host C++ hash-table grouping (no device sort)
        from ..ingest import native

        Np = _next_pow2(N)
        ppad = np.zeros(Np, dtype=np.int32)
        ppad[:N] = positions
        h, canon = _se_hash_jax(p16_dev, jnp.asarray(ppad),
                                jnp.asarray(_MULT), seqlength - readlength,
                                n_words=W, readlength=readlength,
                                stranded=stranded)
        h = np.asarray(h)[:N]
        canon = np.asarray(canon)[:N].astype(bool)
        h64 = np.ascontiguousarray(h).view(np.uint64)  # [N, 2]
        perm, run_id, _ = native.group_rows(h64[:, 0], h64[:, 1])
        return (positions[perm].astype(np.int64), run_id, canon[perm])
    if backend == "jax":
        Np = _next_pow2(N)
        ppad = np.zeros(Np, dtype=np.int32)
        ppad[:N] = positions
        vpad = np.zeros(Np, dtype=bool)
        vpad[:N] = True
        spos, rid, canon = _se_group_jax(
            p16_dev, jnp.asarray(ppad), jnp.asarray(vpad),
            jnp.asarray(_MULT), seqlength - readlength,
            n_words=W, readlength=readlength, stranded=stranded)
        return (np.asarray(spos)[:N].astype(np.int64),
                np.asarray(rid)[:N].astype(np.int64),
                np.asarray(canon)[:N].astype(bool))
    # NumPy reference path: full keys, no hashing
    p16 = np.asarray(p16_dev)
    fw = pack.window_words_np(p16, positions, readlength)
    if stranded:
        words = fw
        canon = np.ones(N, dtype=bool)
    else:
        rc = pack.window_words_np(p16, seqlength - positions - readlength,
                                  readlength)
        cmp, words = pack.lexmin_words_np(fw, rc)
        canon = cmp <= 0
    order = np.lexsort(tuple(words[:, w] for w in range(W - 1, -1, -1)))
    sw = words[order]
    diff = np.any(sw[1:] != sw[:-1], axis=1)
    run_id = np.concatenate([np.zeros(1, np.int64),
                             np.cumsum(diff.astype(np.int64))])
    return positions[order].astype(np.int64), run_id, canon[order]


# --------------------------------------------------------------------------
# PE candidate expansion
# --------------------------------------------------------------------------


@functools.partial(jax.jit,
                   static_argnames=("n_words", "readlength", "stranded",
                                    "n_d"))
def _pe_block_jax(p16, bad, cuml, positions, cluster, valid_pos, mult,
                  d0, borderpos, seqlength,
                  n_words: int, readlength: int, stranded: bool, n_d: int):
    """Expand a block of mate1 clusters over d offsets and group candidate
    (cluster, mate2-sequence) pairs.

    positions/cluster int32/int64 [B] (padded with valid_pos=False).
    Returns sorted (cluster, d, tid, run_id, valid) flattened arrays.
    """
    B = positions.shape[0]
    rl = readlength
    pos = positions.astype(jnp.int64)
    ds = d0 + jnp.arange(n_d, dtype=jnp.int64)

    cand = pos[:, None] + ds[None, :]  # [B, n_d]
    in_range = cand <= seqlength - rl
    cand_c = jnp.clip(cand, 0, seqlength - rl)
    # canonical mate2 window: zero bad chars in [cand, cand+rl)
    okwin = (bad[cand_c + rl] - bad[cand_c]) == 0
    # same transcript in the same half (sf_i equality + border guard)
    def tid_of(k):
        flipped = jnp.where(k + rl > borderpos, seqlength - k - rl, k)
        return jnp.searchsorted(cuml, flipped, side="right") - 1
    tid1 = tid_of(pos)
    tid2 = tid_of(cand_c)
    same_half = ~((pos[:, None] < borderpos) & (cand_c > borderpos))
    valid = valid_pos[:, None] & in_range & okwin & \
        (tid2 == tid1[:, None]) & same_half

    flat_pos = jnp.repeat(pos, n_d)
    flat_cand = cand_c.reshape(-1)
    flat_valid = valid.reshape(-1)

    if not stranded:
        # canonical pair orientation (reference :2863-2869)
        k_m1 = _gather_words(p16, flat_pos, n_words, rl)
        k_m1f = _gather_words(p16, seqlength - flat_cand - rl, n_words, rl)
        cmp1, _ = _lexmin(k_m1, k_m1f)
        k_m2 = _gather_words(p16, flat_cand, n_words, rl)
        k_m2f = _gather_words(p16, seqlength - flat_pos - rl, n_words, rl)
        cmp2, _ = _lexmin(k_m2, k_m2f)
        cmp = jnp.where(cmp1 == 0, cmp2, cmp1)
        keep = jnp.where(flat_pos < borderpos, cmp <= 0, cmp < 0)
        flat_valid = flat_valid & keep

    m2w = _gather_words(p16, flat_cand, n_words, rl)
    h = _hash4(m2w, mult)
    flat_cluster = jnp.repeat(cluster.astype(jnp.int64), n_d)

    # cluster key with the invalid flag folded into the top bit; the only
    # payload is the flat candidate index (host recovers position and d
    # as idx // n_d and idx % n_d)
    cl32 = (flat_cluster - flat_cluster.min()).astype(jnp.uint32)
    clpad = cl32 | jnp.where(flat_valid, jnp.uint32(0),
                             jnp.uint32(0x80000000))
    idx = jax.lax.broadcasted_iota(jnp.int32, (B * n_d, 1), 0)[:, 0]
    operands = (clpad,) + tuple(h[:, k] for k in range(4)) + (idx,)
    out = jax.lax.sort(operands, num_keys=5, is_stable=True)
    keys = jnp.stack(out[:5], axis=1)
    diff = jnp.any(keys[1:] != keys[:-1], axis=1)
    run_id = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(diff.astype(jnp.int32))])
    n_valid = jnp.sum(flat_valid.astype(jnp.int32))
    return out[5], run_id, n_valid


def run_lengths(run_id: np.ndarray) -> np.ndarray:
    """Lengths of each run given 0-based increasing run ids."""
    if run_id.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    return np.bincount(run_id, minlength=int(run_id[-1]) + 1).astype(np.int64)


# --------------------------------------------------------------------------
# generic full-key sort (differential tests / host tooling)
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_key_cols",))
def _sort_runs_jax(flag, words, aux, n_key_cols: int):
    operands = (flag,) + tuple(words[:, w] for w in range(words.shape[1])) + \
        tuple(aux[:, a] for a in range(aux.shape[1]))
    out = jax.lax.sort(operands, num_keys=1 + n_key_cols, is_stable=True)
    W = words.shape[1]
    sw = jnp.stack(out[1:1 + W], axis=1)
    sa = jnp.stack(out[1 + W:], axis=1) if aux.shape[1] else aux
    key = sw[:, :n_key_cols]
    diff = jnp.any(key[1:] != key[:-1], axis=1) | (out[0][1:] != out[0][:-1])
    run_id = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(diff.astype(jnp.int32))])
    return sw, sa, run_id


def sort_runs(words: np.ndarray, aux: np.ndarray, n_key_cols: int,
              backend: str = "jax") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lexicographic sort of full [N, W] uint32 keys carrying [N, A] int32
    payload; returns (sorted_words, sorted_aux, run_id)."""
    N = words.shape[0]
    if N == 0:
        return words, aux, np.zeros(0, dtype=np.int32)
    if backend == "jax":
        Np = _next_pow2(N)
        flag = np.zeros(Np, dtype=np.uint32)
        flag[N:] = 1
        wpad = np.zeros((Np, words.shape[1]), dtype=np.uint32)
        wpad[:N] = words
        apad = np.zeros((Np, aux.shape[1]), dtype=aux.dtype)
        apad[:N] = aux
        sw, sa, rid = _sort_runs_jax(jnp.asarray(flag), jnp.asarray(wpad),
                                     jnp.asarray(apad), n_key_cols)
        return (np.asarray(sw)[:N], np.asarray(sa)[:N],
                np.asarray(rid)[:N].astype(np.int32))
    order = np.lexsort(tuple(words[:, w] for w in range(n_key_cols - 1, -1, -1)))
    sw = words[order]
    sa = aux[order]
    key = sw[:, :n_key_cols]
    diff = np.any(key[1:] != key[:-1], axis=1)
    run_id = np.concatenate([np.zeros(1, np.int32),
                             np.cumsum(diff.astype(np.int32))]).astype(np.int32)
    return sw, sa, run_id
