"""Device-resident rsh index construction.

The host-orchestrated builders in ``build.py`` move sorted candidate arrays
device->host every chunk.  This module keeps the entire construction on
the device and transfers only aggregated results:

* a *rank* pass groups every read-length window by sequence once
  (one 128-bit-hash sort); the rank array R turns every later sequence
  comparison into an integer compare and every mate2-window key into a
  contiguous 1-element gather,
* candidate runs are detected on sorted (cluster, rank) keys; per-run
  statistics (size, d-range, 3-lane multiset hash of the member tids) come
  from one fused segmented scan,
* single-transcript runs are scatter-added into a dense [ntid, nFraglen]
  device table (reference update_rshbucket_single,
  src/emsar_functions.c:1514-1537),
* multi-transcript runs append one (hash, fraglen) record per *run* to a
  device buffer; identical signatures are aggregated in one final device
  sort, so the host receives one row per distinct (signature, fraglen)
  instead of one row per candidate (the reference's rshbucket insert,
  update_rshbucket :1542-1625, keyed here by a 87-bit multiset hash),
* the actual tid multisets are recovered from *exemplar* runs: the first
  run to claim a hash slot in three independent claim tables has its
  members compacted out (a few KB per build); the host verifies every
  resolved multiset against its hash, and a signature losing all three
  slots (probability ~(load)^3 per signature) aborts to the fallback
  backend rather than guessing.

Orientation / canonicalization (reference strcmp-based rules,
src/emsar_functions.c:1005, 2863-2869) are evaluated on ranks instead of
lexicographic string order.  Any total order with exact equality yields the
same kept-candidate *multiset* per (mate1-seq, mate2-seq) group — flipped
pairs flip consistently, tids and fragment lengths are flip-invariant — so
the resulting .rsh is byte-identical (pinned by tests/test_build_golden.py).

Unsupported configurations raise :class:`DeviceBuildUnsupported` and the
dispatcher in ``build.py`` falls back to the host-orchestrated builder.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import BuildConfig
from ..io.fasta import Transcriptome
from ..io.rsh import RshIndex
from ..utils.timing import phase
from . import pack
from .kernels import _MULT, _hash4

# sentinels
BIG_RANK = np.int32(0x3FFFFFFF)      # invalid-window rank
KEY_PAD = np.uint32(0xFFFFFFFF)      # sort key for padding / invalid
CLAIM_EMPTY = np.uint32(0xFFFFFFFF)

# 3 multiset-hash lanes: identity = (h1, h2, h3>>9) = 87 bits; lane 3's low
# 9 bits carry the fraglen index.  Collision risk across ~1e6 signatures is
# ~2^-40; the host verifies every *resolved* exemplar against its hash.
_LANE_MUL = np.uint32([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D])
_LANE_ADD = np.uint32([0x27D4EB2F, 0x165667B1, 0x9E3779B9])
MAX_NFL_PACKED = 512  # fraglen bits packed into lane 3


class DeviceBuildUnsupported(RuntimeError):
    """Configuration the device-resident builder does not support (yet)."""


class DeviceBuildOverflow(RuntimeError):
    """A fixed-capacity device buffer overflowed; retry with other backend."""


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def sig_lanes_np(tids: np.ndarray) -> np.ndarray:
    """[N, 3] uint32 per-tid hash lanes (host dual of ``_sig_lanes``)."""
    t = np.asarray(tids, dtype=np.uint32)
    with np.errstate(over="ignore"):
        return np.stack([_mix32_np(t * m + a)
                         for m, a in zip(_LANE_MUL, _LANE_ADD)], axis=1)


def multiset_hash_np(tids: np.ndarray) -> Tuple[int, int, int]:
    """(h1, h2, h3) of a tid multiset — order-independent sums."""
    lanes = sig_lanes_np(tids)
    with np.errstate(over="ignore"):
        s = lanes.sum(axis=0, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    return int(s[0]), int(s[1]), int(s[2])


def _mix32(x):
    x = x.astype(jnp.uint32)
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> jnp.uint32(16))
    return x


def _sig_lanes(tids):
    t = tids.astype(jnp.uint32)
    return [_mix32(t * jnp.uint32(m) + jnp.uint32(a))
            for m, a in zip(_LANE_MUL, _LANE_ADD)]


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _quantize_size(n: int) -> int:
    """Round up to a multiple of 2^ceil(log2 n)/8 (4 shapes per octave,
    under a quarter pad).  Device buffers sized this way share compiled
    executables across transcriptomes of similar scale instead of
    compiling each kernel afresh per build."""
    if n <= 4096:
        return _next_pow2(n)
    return _pad_to(n, _next_pow2(n) // 8)


def _launch_base(chunk_id: int, E: int) -> int:
    """Monotone per-launch run-id offset: chunk_id << ceil_log2(E),
    saturated so base + E stays within int32 (see _postsort_accumulate
    on steal suppression)."""
    shift = max((E - 1).bit_length(), 1)
    cap = ((1 << 31) - 1 - E) >> shift
    return min(int(chunk_id), cap) << shift


def _psync(*arrays):
    """Block on device work under EMSAR_DEVBUILD_PROFILE so phase timers
    attribute async dispatches to the phase that issued them."""
    if os.environ.get("EMSAR_DEVBUILD_PROFILE"):
        jax.block_until_ready(arrays)


def _pad_to(n: int, q: int) -> int:
    return ((n + q - 1) // q) * q


# --------------------------------------------------------------------------
# segmented scans
# --------------------------------------------------------------------------


def _run_bounds(start):
    """(my_start, next_start) per element of a run-start flag vector.

    Native cumulative ops only — a tuple ``associative_scan`` at 8M+
    elements takes tens of minutes to XLA-compile on this backend, while
    ``cummax``/``cummin``/``cumsum`` are single HLO ops."""
    E = start.shape[0]
    i = jnp.arange(E, dtype=jnp.int32)
    my_start = jax.lax.cummax(jnp.where(start, i, -1))
    # next_start[i] = first start index > i (E if none)
    incl = jax.lax.cummin(jnp.where(start, i, jnp.int32(E)), reverse=True)
    next_start = jnp.concatenate([incl[1:], jnp.full(1, E, jnp.int32)])
    return my_start, next_start


def _run_sum_at_start(vals, next_start):
    """Sum of ``vals`` over [i, next_start) — correct at run starts."""
    S = jnp.cumsum(vals, dtype=vals.dtype)
    E = vals.shape[0]
    i = jnp.arange(E, dtype=jnp.int32)
    end = jnp.clip(next_start - 1, 0, E - 1)
    return S[end] - S[i] + vals


# --------------------------------------------------------------------------
# device reference model
# --------------------------------------------------------------------------


@functools.partial(jax.jit,
                   static_argnames=("Lp", "borderpos", "out_pk", "out_bb"))
def _mirror_ref_dev(fwp, fwbb, Lp: int, borderpos: int, out_pk: int,
                    out_bb: int):
    """Full packed-code and bad-bit tables from the forward half only.

    Layout (io/fasta.py, reference read_raw_fasta semantics): positions
    [0, borderpos) are the fw transcripts ('@'-joined), borderpos is the
    central '$', [borderpos+1, 2*borderpos+1) the reverse complement of
    the fw half, 2*borderpos+1 the final '$'.  Code-wise the rc half is
    flip(fw) ^ 3 (complement; non-ACGT positions are garbage either way
    and masked by the mirrored bad bits)."""
    B1 = borderpos + 1
    B1p = _pad_to(B1, 256)
    i = jnp.arange(B1p, dtype=jnp.int32)
    b = jnp.repeat(fwp[:B1p // 4].astype(jnp.uint8), 4)
    cfw = (b >> (6 - 2 * (i & 3)).astype(jnp.uint8)) & 3
    b8 = jnp.repeat(fwbb[:B1p // 8].astype(jnp.uint8), 8)
    badfw = ((b8 >> (7 - (i & 7)).astype(jnp.uint8)) & 1).astype(bool)
    rc = jnp.flip(cfw[:borderpos]) ^ jnp.uint8(3)
    rcb = jnp.flip(badfw[:borderpos])
    tail = Lp - B1 - borderpos
    cfull = jnp.concatenate([cfw[:B1], rc,
                             jnp.zeros(tail, jnp.uint8)])
    badfull = jnp.concatenate([badfw[:B1], rcb,
                               jnp.ones(tail, bool)])
    # flat strided slices instead of reshape(N, 4): keeps every operand 1-D
    pk = ((cfull[0::4] << 6) | (cfull[1::4] << 4) | (cfull[2::4] << 2)
          | cfull[3::4]).astype(jnp.uint8)
    bfu = badfull.astype(jnp.uint8)
    bb = bfu[0::8]
    for k in range(1, 8):
        bb = (bb << 1) | bfu[k::8]
    pko = jax.lax.dynamic_update_slice(jnp.zeros(out_pk, jnp.uint8), pk,
                                       (0,))
    bbo = jax.lax.dynamic_update_slice(
        jnp.full(out_bb, 0xFF, jnp.uint8), bb, (0,))
    return pko, bbo


class DeviceRef:
    """Device-resident transcriptome: packed 2-bit codes -> P16 key array,
    non-ACGT prefix counts, cuml.  Upload is ~1.3 bits/base (fw half
    only)."""

    def __init__(self, tx: Transcriptome):
        self.tx = tx
        L = int(tx.seqlength) + 1
        self.L = L
        Lp = _pad_to(L + 64, 256)
        self.Lp = Lp
        borderpos = int(tx.borderpos)
        codes = tx.codes
        # ship only the forward half (plus the central '$'): the rc half
        # is flip(fw) ^ 3 code-wise (io/fasta.py layout f..$..rc$) and is
        # mirrored on device (_mirror_ref_dev) — halves both the host
        # packing work and the host-to-device bytes
        B1 = borderpos + 1
        B1p = _pad_to(B1, 256)
        cfw = np.zeros(B1p, dtype=np.uint8)
        cfw[:B1] = codes[:B1] & 3
        fwp = np.zeros(_quantize_size(B1p // 4 + 8), dtype=np.uint8)
        fwp[:B1p // 4] |= cfw[0::4] << 6
        fwp[:B1p // 4] |= cfw[1::4] << 4
        fwp[:B1p // 4] |= cfw[2::4] << 2
        fwp[:B1p // 4] |= cfw[3::4]
        fwbad = np.zeros(B1p, dtype=bool)
        fwbad[:B1] = codes[:B1] >= 4
        fwbad[B1:] = True
        fb = np.full(_quantize_size(B1p // 8), 0xFF, dtype=np.uint8)
        fb[:B1p // 8] = np.packbits(fwbad)
        self._packed, self._badbits = _mirror_ref_dev(
            jnp.asarray(fwp), jnp.asarray(fb), Lp=Lp, borderpos=borderpos,
            out_pk=_quantize_size(Lp // 4 + 8),
            out_bb=_quantize_size(Lp // 8))
        self._seppos_host = np.flatnonzero(
            (tx.seq[:L] == ord("@")) | (tx.seq[:L] == ord("$"))
        ).astype(np.int32)
        cu = tx.cuml.astype(np.int32)
        # pad with an out-of-range sentinel: cuml is only ever scattered
        # with mode="drop" (_tid_forward), so pad rows are inert and the
        # device shape is quantized
        cup = np.full(_quantize_size(len(cu)), np.iinfo(np.int32).max,
                      dtype=np.int32)
        cup[:len(cu)] = cu
        self.cuml = jnp.asarray(cup)
        self._p16 = None
        self._badp = None
        self._nsep = None

    @property
    def p16(self):
        """Full [Lp] window-word table (PE rank pass).  8 bytes/base once
        badp is included — built lazily; the SE builder never materializes
        it (slab-local unpack from the 2-bit codes instead)."""
        if self._p16 is None:
            self._p16, self._badp = _unpack_ref(self._packed, self._badbits,
                                                self.Lp)
        return self._p16

    @property
    def badp(self):
        if self._badp is None:
            _ = self.p16
        return self._badp

    def release_seq(self):
        """Free the packed sequence tables (several GB at human scale)
        once hashing is done — rank-space tables don't need them.  nsep
        stays constructible (it derives from the retained separator
        positions)."""
        self._p16 = None
        self._badp = None
        self._packed = None
        self._badbits = None

    @property
    def nsep(self):
        """nsep[k] = index of the first '@'/'$' separator at or after k
        (PE only; 4 bytes/position, so built lazily).  Built from the
        ~2*ntid separator POSITIONS (a tiny scatter + one reverse
        cummin) — the old packed-bitfield expansion's repeat-by-8
        intermediate tiles to 16x its logical size at human scale."""
        if self._nsep is None:
            self._nsep = _nsep_kernel(jnp.asarray(self._seppos_host),
                                      self.Lp)
        return self._nsep

    def t32(self, readlength: int):
        """tid of every window-start position (reference sf_i,
        src/emsar_functions.c:2619-2627), device int32 [Lp]."""
        borderpos = int(self.tx.borderpos)
        seqlength = int(self.tx.seqlength)
        size = _pad_to(max(borderpos - readlength + 2,
                           seqlength - borderpos + 2), 256)
        tidf = _tid_forward(self.cuml, size=size)
        return _t32_kernel(tidf, self.Lp, borderpos, seqlength, readlength)


@functools.partial(jax.jit, static_argnames=("Lp",))
def _unpack_ref(packed, badbits, Lp: int):
    """p16[k] = 2-bit codes of bases [k, k+16), big-endian.

    The byte streams b[j][i] = packed[(i>>2)+j] are built as
    repeat(slice, 4) — a reshape/broadcast instead of a byte gather;
    likewise the badbits expansion is a repeat x8."""
    i = jnp.arange(Lp, dtype=jnp.int32)
    nb = Lp // 4

    def bytes_at(j):
        return jnp.repeat(
            jax.lax.dynamic_slice(packed, (j,), (nb,)).astype(jnp.uint32), 4)

    b = [bytes_at(j) for j in range(5)]
    W = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    sh = (2 * (i & 3)).astype(jnp.uint32)
    p16 = (W << sh) | (b[4] >> (jnp.uint32(8) - sh))
    bb8 = jnp.repeat(badbits[:Lp // 8].astype(jnp.uint8), 8)
    bb = (bb8 >> (7 - (i & 7)).astype(jnp.uint8)) & 1
    badp = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(bb.astype(jnp.int32))])
    return p16, badp


@functools.partial(jax.jit, static_argnames=("Lp",))
def _nsep_kernel(seppos, Lp: int):
    """nsep from the separator position list: positions [L, Lp) count as
    separators (sentinel floor = Lp keeps in-range slices monotone)."""
    marks = jnp.full(Lp, jnp.int32(Lp))
    last = seppos[-1] if seppos.shape[0] else jnp.int32(0)
    marks = jnp.where(jnp.arange(Lp, dtype=jnp.int32) > last,
                      jnp.arange(Lp, dtype=jnp.int32), marks)
    marks = marks.at[seppos].set(seppos, mode="drop")
    return jax.lax.cummin(marks, reverse=True)


@functools.partial(jax.jit, static_argnames=("LpE", "n1"))
def _t32_fw(tidf, LpE: int, n1: int):
    """fw-half tid table at the fast-path size: positions >= n1 are only
    ever read on masked rows (zero fill)."""
    return jnp.concatenate([jax.lax.slice(tidf, (0,), (n1,)),
                            jnp.zeros(LpE - n1, jnp.int32)])


@functools.partial(jax.jit,
                   static_argnames=("Lp", "borderpos", "seqlength",
                                    "readlength"))
def _t32_kernel(tidf, Lp: int, borderpos: int, seqlength: int,
                readlength: int):
    """tid per window-start position (reference sf_i,
    src/emsar_functions.c:2619-2627): the fw prefix of the forward tid
    table + a flipped slice for the rc half (no Lp-wide searchsorted)."""
    rl = readlength
    n1 = borderpos - rl + 1
    v0 = seqlength - rl - n1  # flipped position of k = n1
    part1 = jax.lax.dynamic_slice(tidf, (0,), (n1,))
    rcpart = jnp.flip(jax.lax.dynamic_slice(tidf, (0,), (v0 + 1,)))
    tail = jnp.full(Lp - n1 - (v0 + 1), tidf[0], jnp.int32)
    return jnp.concatenate([part1, rcpart, tail])


# --------------------------------------------------------------------------
# rank pass (PE): group every window position by exact sequence
# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# partitioned rank pass (PE builds beyond the single-sort limit)
# --------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("slab", "rc_half", "readlength"),
    donate_argnums=(0, 1, 2, 3))
def _pe_hash_slab(H1, H2, H3, PS, packed, badbits, s0, out0, n_half,
                  seqlength, slab: int, rc_half: bool, readlength: int):
    """Literal mate1 window hash + position for rank-pass indices
    [s0, s0+slab) of one strand half, written at out0.  fw half: pos = i
    ascending; rc half: pos = seqlength - rl - i descending (flipped
    slices).  Invalid windows carry the all-ones identity and pos -1.

    Window words unpack slab-locally from the 2-bit code bytes
    (_p16_range) — materializing the global p16/badp tables costs 8
    bytes/base of device memory, and the repeat-by-4 unpack trick's
    [Lp/4, 4] intermediate is fused by XLA at slab scale but may be
    materialized at full scale."""
    rl = readlength
    W = pack.n_words(rl)
    i = s0 + jnp.arange(slab, dtype=jnp.int32)
    if rc_half:
        base = seqlength - rl - s0 - (slab - 1)
        words = [jnp.flip(_p16_range(packed, base + 16 * w, slab))
                 for w in range(W)]
        pos = seqlength - rl - i
        badw = jnp.flip(_bad_win(badbits, base, slab, rl))
    else:
        words = [_p16_range(packed, s0 + 16 * w, slab) for w in range(W)]
        pos = i
        badw = _bad_win(badbits, s0, slab, rl)
    rem = rl - 16 * (W - 1)
    if rem < 16:
        words[W - 1] = words[W - 1] >> jnp.uint32(2 * (16 - rem))
    valid = (i < n_half) & (badw == 0)
    h1, h2, h3 = _hash3_cols(words)
    h1 = jnp.where(valid, h1, CLAIM_EMPTY)
    h2 = jnp.where(valid, h2, CLAIM_EMPTY)
    h3 = jnp.where(valid, h3, CLAIM_EMPTY)
    pos = jnp.where(valid, pos, -1)
    H1 = jax.lax.dynamic_update_slice(H1, h1, (out0,))
    H2 = jax.lax.dynamic_update_slice(H2, h2, (out0,))
    H3 = jax.lax.dynamic_update_slice(H3, h3, (out0,))
    PS = jax.lax.dynamic_update_slice(PS, pos, (out0,))
    return H1, H2, H3, PS, jnp.sum(valid, dtype=jnp.int32)


def _dd_pack(SP, start, valid):
    """Per sorted row: packed (next_gap << 16) | prev_gap neighbor
    distances to the nearest SAME-window position (the rank sort carries
    position as a key, so within-run positions are ascending).  65535 =
    STRICTLY no in-run neighbor on that side (real gaps clip to 65534),
    so DD[p] == 0xFFFFFFFF identifies singleton-cluster positions — no
    separate mask table; a whole-word 0 marks an invalid window.  Every
    row-local test compares against d-offsets < 512, far below the
    clip."""
    prev_gap = jnp.where(
        start, 65535,
        jnp.clip(SP - jnp.concatenate([jnp.zeros(1, SP.dtype), SP[:-1]]),
                 1, 65534)).astype(jnp.uint32)
    nxt_start = jnp.concatenate([start[1:], jnp.ones(1, bool)])
    next_gap = jnp.where(
        nxt_start, 65535,
        jnp.clip(jnp.concatenate([SP[1:], jnp.zeros(1, SP.dtype)]) - SP,
                 1, 65534)).astype(jnp.uint32)
    return jnp.where(valid, (next_gap << jnp.uint32(16)) | prev_gap,
                     jnp.uint32(0))


@functools.partial(jax.jit, static_argnames=("Lp",))
def _dd_from_stream(SP, RK, Lp: int):
    """Neighbor-distance table from the bucket-major (position, rank)
    stream of the partitioned rank pass (valid rows are a contiguous
    prefix; garbage tail rows carry BIG_RANK/-1 and are masked)."""
    valid = (RK != BIG_RANK) & (SP >= 0)
    start = jnp.concatenate([jnp.ones(1, bool), RK[1:] != RK[:-1]])
    return jnp.zeros(Lp, jnp.uint32).at[
        jnp.where(valid, SP, Lp)].set(_dd_pack(SP, start, valid),
                                      mode="drop", unique_indices=True)


@functools.partial(jax.jit, static_argnames=("Lp", "with_dd"),
                   donate_argnums=(0, 1, 2))
def _pe_rank_finish(S1, S2, S3, SP, n_valid, Lp: int, with_dd: bool = False):
    """From the identity-sorted (hash, pos) stream: per-row rank (equal
    windows share one), the position->rank table R, and cluster stats.
    Returns (R, rank, max_cluster, n_distinct, DD); SP is the sorted
    position stream (mate1 members of each cluster are contiguous).  DD
    (``with_dd``) is the packed neighbor-distance table of the fast
    singleton pass (token array otherwise)."""
    N = S1.shape[0]
    j = jnp.arange(N, dtype=jnp.int32)
    valid = j < n_valid
    diff = (S1[1:] != S1[:-1]) | (S2[1:] != S2[:-1]) | (S3[1:] != S3[:-1])
    start = jnp.concatenate([jnp.ones(1, bool), diff])
    rank = jnp.cumsum(start.astype(jnp.int32)) - 1
    n_distinct = jnp.max(jnp.where(valid, rank + 1, 0))
    rank = jnp.where(valid, rank, BIG_RANK)
    R = jnp.full(Lp, BIG_RANK, dtype=jnp.int32)
    R = R.at[jnp.where(valid, SP, Lp)].set(rank, mode="drop")
    _, ns = _run_bounds(start)
    max_cluster = jnp.max(jnp.where(start & valid, ns - j, 0))
    if with_dd:
        DD = jnp.zeros(Lp, jnp.uint32).at[
            jnp.where(valid, SP, Lp)].set(_dd_pack(SP, start, valid),
                                          mode="drop")
    else:
        DD = jnp.zeros(8, jnp.uint32)
    return R, rank, max_cluster, n_distinct, DD


def _append_block(arrays, bufs, n, count, cap, flags, flag_bit):
    """Write ``arrays`` (already compacted to the front, ``count`` real rows,
    each of static length >= cap-block) into ``bufs`` at offset ``n`` via
    dynamic_update_slice of a fixed-size block.

    The overflow flag marks *actual* data loss only: the block truncating
    real rows (count > blocksize) or the write start clamping back over
    earlier rows (n > cap - blocksize).  Maintenance cadences guarantee
    n <= cap - blocksize before every launch, so a false trigger would
    abort builds that lost nothing."""
    outs = []
    nc = jnp.clip(n, 0, None)
    for a, b in zip(arrays, bufs):
        outs.append(jax.lax.dynamic_update_slice(b, a, (nc,)))
    newn = n + jnp.minimum(count, a.shape[0])
    flags = flags.at[flag_bit].max(
        jnp.where((count > a.shape[0]) | (nc > cap - a.shape[0]),
                  jnp.int32(1), jnp.int32(0)))
    return outs, newn, flags


def _postsort_accumulate(state, start, validrow, d_ind, tid, chunk_base,
                         nfl: int, max_repeat: int, U: int,
                         chunk_id=None):
    """From sorted runs to: dense single-EUMA scatter, per-run signature
    records, and a compacted winner list for exemplar-member extraction.
    All input arrays length E (sorted).

    ``chunk_id``: launch index recorded next to extracted members; run ids
    are only unique within a launch once builds are partitioned, so the
    host groups members by (chunk, run).  ``chunk_base`` is a
    caller-chosen monotone per-launch offset (_launch_base) added to the
    local run index: claim slots keep the MINIMUM id, so monotone ids
    stop later launches from "stealing" slots already claimed for the
    same signature — steals are benign (every win still yields one
    complete real run) but each one pays a member extraction.  Once the
    prefix saturates (launch count beyond the id width) steals resume
    among the saturated launches only.

    Cost discipline: full-width (E-sized) gathers/scatters dominate a
    launch on this hardware (~120 M elem/s vs ~free elementwise/cumsum),
    so everything testable per *record* — the multi-d filter, the hash
    lanes, the claim probes — runs at record (U) scale after the cumsum+
    scatter compaction; multi-d runs become dead rows (all-ones identity,
    cnt 0) that the table aggregation drops.  Member extraction itself
    runs in a separate launch (:func:`_extract_members`) at
    winner-member scale — it used to cost ~5 E-scale random-access ops
    inside this kernel even when a single run won.

    Returns ``(state, win_row, rsg, rpk, n_win, wmem)``: the winner runs'
    RECORD-ROW indices compacted to the front of a [U] array plus the
    record id/packed-field arrays (the extraction launch re-derives run
    start and member count from them at winner scale), and the winner
    count / total member demand (device scalars) the host uses to size
    the extraction launch.

    Op-count discipline (tools/microbench_pe_ops.py: U-scale random
    gathers/scatters cost 76-127 ms each at U ~ 8M while cumsums are
    ~free): per-record fields ride ONE extra E-driven scatter as a
    packed word, the four prefix sums (multi-d counter + 3 hash lanes)
    are stacked into one [E+1, 4] table so both run endpoints resolve
    with ONE 4-wide row gather each, and the winner compaction is a
    single scatter."""
    E = start.shape[0]
    assert max_repeat < (1 << 22), "run length must fit the packed word"
    claim_mask = state["claim1"].shape[0] - 1
    i = jnp.arange(E, dtype=jnp.int32)
    my_start, next_start = _run_bounds(start)
    cntr = next_start - i
    # d uniform within run <=> no adjacent differing pair inside the run
    prev_d = jnp.concatenate([jnp.zeros(1, d_ind.dtype), d_ind[:-1]])
    bad_pair = (~start) & (d_ind != prev_d)
    badS = jnp.cumsum(bad_pair.astype(jnp.uint32), dtype=jnp.uint32)

    single = start & validrow & (cntr == 1)
    dense = state["dense"].at[
        jnp.where(single, tid * nfl + d_ind, state["dense"].shape[0])
    ].add(1, mode="drop")

    rec = (start & validrow & (cntr > 1) & (cntr < max_repeat))
    sgu = (chunk_base + i).astype(jnp.uint32)

    # stacked prefix table: ST4[k] = inclusive prefix through row k-1
    # (= exclusive prefix at k).  bad_pair is 0 at every run start, so
    # ST4[rec_idx, 0] is also badS[rec_idx] — one row serves all four
    # start-side sums, one row all four end-side sums.
    l1, l2, l3 = _sig_lanes(tid)
    ST4 = jnp.concatenate([
        jnp.zeros((1, 4), jnp.uint32),
        jnp.stack([badS,
                   jnp.cumsum(l1, dtype=jnp.uint32),
                   jnp.cumsum(l2, dtype=jnp.uint32),
                   jnp.cumsum(l3, dtype=jnp.uint32)], axis=1)])

    # compact records (one per multi run) to the front of a [Ue] buffer
    # via cumsum + scatter (an order-preserving stable partition); the
    # second scatter carries (run length, start bad_pair, fraglen) packed
    rec_cnt = jnp.sum(rec, dtype=jnp.int32)
    Ue = min(U, E)
    rec_valid = jnp.arange(Ue, dtype=jnp.int32) < rec_cnt
    rdst = jnp.where(rec, jnp.cumsum(rec.astype(jnp.int32)) - 1, Ue)
    rsg = jnp.zeros(Ue, jnp.uint32).at[rdst].set(sgu, mode="drop",
                                                 unique_indices=True)
    packed = ((cntr.astype(jnp.uint32) << jnp.uint32(10))
              | (bad_pair.astype(jnp.uint32) << jnp.uint32(9))
              | d_ind.astype(jnp.uint32))
    rpk = jnp.zeros(Ue, jnp.uint32).at[rdst].set(packed, mode="drop",
                                                 unique_indices=True)
    rec_idx = jnp.clip(rsg.astype(jnp.int32) - chunk_base, 0, E - 1)
    rfl = rpk & jnp.uint32(0x1FF)
    rcnt = (rpk >> jnp.uint32(10)).astype(jnp.int32)
    rend = jnp.clip(rec_idx + rcnt - 1, 0, E - 1)
    G_end = ST4[rend + 1]    # [Ue, 4] row gather
    G_sta = ST4[rec_idx]     # [Ue, 4] row gather
    # multi-d test at record scale (reference multi_d filter :1926): no
    # adjacent differing-d pair strictly inside (rec_idx, rend]
    sd_rec = G_end[:, 0] == G_sta[:, 0]
    rec_valid = rec_valid & sd_rec
    r1 = G_end[:, 1] - G_sta[:, 1]
    r2 = G_end[:, 2] - G_sta[:, 2]
    r3 = ((G_end[:, 3] - G_sta[:, 3]) & jnp.uint32(0xFFFFFE00)) | rfl
    use_sig = "sig_dir" in state
    if use_sig:
        # signature-keyed dense accumulation (big builds: 76 M unique
        # (sig, fl) rows at F1-400 recur forever and would drain any
        # fixed append table every epoch, but only ~294 K signatures):
        # probe an open-address directory for the record's SIGNATURE row,
        # claim-insert first occurrences, and scatter-add the count into
        # that row's dense fraglen vector.  Hash-slot collisions with a
        # different resident identity and row spill past SIGROWS fall
        # back to the (sig, fl) append table — routing is per-record and
        # each run is exactly one record, so counts merge exactly at
        # finalize no matter which path a record took.
        D = state["sig_dir"]
        SIGSLOT = D.shape[0]
        SIGROWS = state["sig_dense"].shape[0] // nfl
        id3 = r3 & jnp.uint32(0xFFFFFE00)
        idh = _mix32(r1 ^ _mix32(r2 ^ _mix32(id3)))
        slot = jnp.where(rec_valid,
                         (idh & jnp.uint32(SIGSLOT - 1)).astype(jnp.int32),
                         SIGSLOT)
        slot_c = jnp.clip(slot, 0, SIGSLOT - 1)
        g = D[slot_c]                                # [Ue, 4] row gather
        occ = g[:, 3] != 0
        hit = (rec_valid & occ & (g[:, 0] == r1) & (g[:, 1] == r2)
               & (g[:, 2] == id3))
        cand = rec_valid & ~occ

        def _insert(D):
            # claim-insert first occurrences: one winner per empty slot
            # (scatter-min of record index), rows allocated sequentially
            # from sig_n; intra-launch repeats of a fresh signature
            # resolve via a re-probe after the insert
            jj = jnp.arange(Ue, dtype=jnp.int32)
            sc = jnp.full(SIGSLOT, jnp.int32(0x7FFFFFFF)).at[
                jnp.where(cand, slot, SIGSLOT)].min(jj, mode="drop")
            winner = cand & (sc[slot_c] == jj)
            newrow = (state["sig_n"]
                      + jnp.cumsum(winner.astype(jnp.int32)) - 1)
            ins = winner & (newrow < SIGROWS)
            ins_rows = jnp.stack(
                [r1, r2, id3,
                 jnp.where(ins, (newrow + 1).astype(jnp.uint32),
                           jnp.uint32(0))], axis=1)
            # NO unique_indices here: the dropped (non-ins) rows all
            # carry the same out-of-bounds index, which breaks the
            # promise (a broken promise once silently dropped a fraction
            # of the real inserts: still byte-correct through the
            # append-table fallback, but the dense table never absorbed
            # them)
            D2 = D.at[jnp.where(ins, slot, SIGSLOT)].set(ins_rows,
                                                         mode="drop")
            g2 = D2[slot_c]
            hit2 = (cand & ~winner & (g2[:, 3] != 0)
                    & (g2[:, 0] == r1) & (g2[:, 1] == r2)
                    & (g2[:, 2] == id3))
            row_rest = jnp.where(
                ins, newrow,
                jnp.where(hit2, g2[:, 3].astype(jnp.int32) - 1, -1))
            return D2, row_rest, ins, jnp.sum(ins, dtype=jnp.int32)

        # the claim/insert/re-probe sub-path costs 4 U-scale random ops;
        # once the directory holds the workload's signatures (a few
        # chunks in) no candidates remain, so it is cond-gated on the
        # traced candidate count and steady-state chunks skip it
        D, row_rest, ins_mask, n_ins = jax.lax.cond(
            jnp.sum(cand, dtype=jnp.int32) > 0, _insert,
            lambda D: (D, jnp.full(Ue, -1, jnp.int32),
                       jnp.zeros(Ue, bool), jnp.zeros((), jnp.int32)),
            D)
        row = jnp.where(hit, g[:, 3].astype(jnp.int32) - 1, row_rest)
        sig_dense = state["sig_dense"].at[
            jnp.where(row >= 0, row * nfl + rfl.astype(jnp.int32),
                      state["sig_dense"].shape[0])].add(1, mode="drop")
        sig_n = state["sig_n"] + n_ins
        rec_tab = rec_valid & (row < 0)   # collisions + spill only
        # routing diagnostics, fetched at finalize under profile.  The
        # uint32 counters wrap past 2^32 records: diagnostic only
        sig_stats = state["sig_stats"] + jnp.stack(
            [jnp.sum(rec_valid, dtype=jnp.uint32),
             jnp.sum(hit, dtype=jnp.uint32),
             n_ins.astype(jnp.uint32),
             jnp.sum(rec_tab, dtype=jnp.uint32)])
    else:
        rec_tab = rec_valid
    # dead rows carry the all-ones identity + cnt 0 (no flag operand)
    tab_arrays = [jnp.where(rec_tab, r1, CLAIM_EMPTY),
                  jnp.where(rec_tab, r2, CLAIM_EMPTY),
                  jnp.where(rec_tab, r3, CLAIM_EMPTY),
                  jnp.where(rec_tab, jnp.uint32(1), jnp.uint32(0))]
    tab_bufs = [state["tab_h1"], state["tab_h2"],
                state["tab_h3fl"], state["tab_cnt"]]
    tabs, tab_n, flags = _append_block(tab_arrays, tab_bufs, state["tab_n"],
                                       rec_cnt, state["tab_h1"].shape[0],
                                       state["flags"], 0)

    # claim tables on the compacted records: the first run (globally, by
    # start-id order) to claim a slot becomes the signature's exemplar.
    # With the signature table, dense-routed records don't need claims —
    # the directory INSERT winner is the signature's first run globally
    # and becomes its exemplar directly (exactly one extraction per
    # signature, no cross-launch steals) — so only append-path residue
    # participates, and the 3 scatter-min + 3 gather claim ops run at
    # the (tiny) residue's slot pressure
    part = rec_tab if use_sig else rec_valid

    def _claims(c1, c2, c3):
        r12 = (r1 >> jnp.uint32(16)) | (r2 << jnp.uint32(16))
        slot1 = jnp.where(part, (r1 & jnp.uint32(claim_mask))
                          .astype(jnp.int32), claim_mask + 1)
        slot2 = jnp.where(part, (r2 & jnp.uint32(claim_mask))
                          .astype(jnp.int32), claim_mask + 1)
        slot3 = jnp.where(part, (r12 & jnp.uint32(claim_mask))
                          .astype(jnp.int32), claim_mask + 1)
        c1 = c1.at[slot1].min(rsg, mode="drop")
        c2 = c2.at[slot2].min(rsg, mode="drop")
        c3 = c3.at[slot3].min(rsg, mode="drop")
        won = part & ((c1[jnp.clip(slot1, 0, claim_mask)] == rsg) |
                      (c2[jnp.clip(slot2, 0, claim_mask)] == rsg) |
                      (c3[jnp.clip(slot3, 0, claim_mask)] == rsg))
        return c1, c2, c3, won

    # cond-gated like the insert path: a dropped-index scatter still
    # pays full U-scale cost, so sig-table chunks with no residue (the
    # steady state) must skip the 3 scatter-min + 3 gather claim ops
    # outright, not just mask them
    claim1, claim2, claim3, win_rec = jax.lax.cond(
        jnp.sum(part, dtype=jnp.int32) > 0, _claims,
        lambda c1, c2, c3: (c1, c2, c3, jnp.zeros(Ue, bool)),
        state["claim1"], state["claim2"], state["claim3"])
    if use_sig:
        win_rec = win_rec | ins_mask
    n_win = jnp.sum(win_rec, dtype=jnp.int32)

    # compact the winner runs' RECORD ROWS to the front (one scatter);
    # the extraction launch re-derives (id, start, count) at winner scale
    wdst = jnp.where(win_rec, jnp.cumsum(win_rec.astype(jnp.int32)) - 1, Ue)
    win_row = jnp.full(Ue, Ue - 1, jnp.int32).at[wdst].set(
        i[:Ue], mode="drop", unique_indices=True)
    wmem = jnp.sum(jnp.where(win_rec, rcnt, 0), dtype=jnp.int32)

    state = dict(state, dense=dense, tab_h1=tabs[0], tab_h2=tabs[1],
                 tab_h3fl=tabs[2], tab_cnt=tabs[3],
                 tab_n=tab_n, claim1=claim1, claim2=claim2, claim3=claim3,
                 flags=flags)
    if use_sig:
        state.update(sig_dir=D, sig_dense=sig_dense, sig_n=sig_n,
                     sig_stats=sig_stats)
    return state, win_row, rsg, rpk, n_win, wmem


@functools.partial(
    jax.jit, static_argnames=("W", "tid_shift"), donate_argnums=(0,))
def _extract_members(state, win_row, rsg, rpk, n_win, tids_sorted, src0,
                     chunk_id, chunk_base, W: int, tid_shift: int):
    """Append the members of this launch's winner runs to the state's
    exemplar-member buffers — all work at winner/member scale.

    ``win_row``: winner RECORD rows compacted to the front (host-sliced
    to a small power of two >= n_win); id / start / count re-derive from
    ``rsg``/``rpk`` via winner-scale gathers.  ``tids_sorted``: the
    launch's sorted payload; member tid = tids_sorted[src0 + row] >>
    tid_shift (PE packs (tid, d) — tid_shift 9; SE passes tids directly —
    shift 0).  ``W``: host-chosen static capacity >= this launch's total
    member demand (quantized pow2)."""
    Uw = win_row.shape[0]
    k = jnp.arange(Uw, dtype=jnp.int32)
    valid_w = k < n_win
    wsg = rsg[win_row]
    wcnt = jnp.where(valid_w,
                     (rpk[win_row] >> jnp.uint32(10)).astype(jnp.int32), 0)
    wstart = jnp.clip(wsg.astype(jnp.int32) - chunk_base, 0, None)
    cnz = wcnt
    offs = jnp.cumsum(cnz) - cnz  # exclusive prefix, constant on padding
    j = jnp.arange(W, dtype=jnp.int32)
    # owning run per output slot: scatter run index at its first slot,
    # then cummax (runs with cnt 0 never scatter)
    seg = jnp.full(W, -1, jnp.int32).at[
        jnp.where(cnz > 0, offs, W)].max(
        jnp.arange(Uw, dtype=jnp.int32), mode="drop")
    seg = jnp.clip(jax.lax.cummax(seg), 0, Uw - 1)
    row = wstart[seg] + (j - offs[seg])
    total = jnp.sum(cnz, dtype=jnp.int32)
    ok = j < total
    tid = (tids_sorted[src0 + jnp.where(ok, row, 0)]
           .astype(jnp.uint32) >> jnp.uint32(tid_shift)).astype(jnp.int32)
    sg = wsg[seg].astype(jnp.int32)
    mem_n = state["mem_n"]
    MEM = state["mem_sg"].shape[0]
    # rows j >= total in the written block are garbage — they sit beyond
    # the advanced mem_n, so the next append overwrites them and the
    # final fetch ([:mem_n]) never sees them; a clamped-back write start
    # (mem_n > MEM - W) would clobber real rows, which the flag marks
    nc = jnp.clip(mem_n, 0, MEM - W)
    out = dict(state)
    out["mem_sg"] = jax.lax.dynamic_update_slice(state["mem_sg"], sg, (nc,))
    out["mem_tid"] = jax.lax.dynamic_update_slice(state["mem_tid"], tid,
                                                  (nc,))
    out["mem_chunk"] = jax.lax.dynamic_update_slice(
        state["mem_chunk"],
        jnp.full(W, 0, jnp.int32) + jnp.asarray(chunk_id, jnp.int32), (nc,))
    out["mem_n"] = mem_n + total
    out["flags"] = state["flags"].at[1].max(
        jnp.where((total > W) | (mem_n > MEM - W), jnp.int32(1),
                  jnp.int32(0)))
    return out


# --------------------------------------------------------------------------
# PE candidate-expansion chunk kernel
# --------------------------------------------------------------------------


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _pe_partition_clusters(SP, RANK, n_valid):
    """Split the rank-sorted mate1 stream into singleton-cluster and
    multi-cluster positions (order-preserving compaction).

    Singleton clusters — mate1 windows occurring exactly once — cannot
    form multi-element fragment runs across members, so their candidates
    never need the global (cluster, mate2-rank) sort: every fragment run
    lies within one row of nfl candidates and is resolved by a row-local
    duplicate-rank test (_pe_single_chunk).  Only multi clusters enter
    the expansion chunks.  Returns (SPs, RKs, SPm, RKm, ns, nm)."""
    N = SP.shape[0]
    j = jnp.arange(N, dtype=jnp.int32)
    valid = j < n_valid
    start = jnp.concatenate([jnp.ones(1, bool), RANK[1:] != RANK[:-1]])
    my_s, nxt_s = _run_bounds(start)
    size = nxt_s[jnp.clip(my_s, 0, N - 1)] - my_s
    single = valid & (size == 1)
    multi = valid & (size >= 2)
    ns = jnp.sum(single, dtype=jnp.int32)
    nm = jnp.sum(multi, dtype=jnp.int32)
    dst_s = jnp.where(single, jnp.cumsum(single.astype(jnp.int32)) - 1, N)
    dst_m = jnp.where(multi, jnp.cumsum(multi.astype(jnp.int32)) - 1, N)
    SPs = jnp.full(N, -1, jnp.int32).at[dst_s].set(SP, mode="drop",
                                                   unique_indices=True)
    RKs = jnp.full(N, BIG_RANK, jnp.int32).at[dst_s].set(
        RANK, mode="drop", unique_indices=True)
    SPm = jnp.full(N, -1, jnp.int32).at[dst_m].set(SP, mode="drop",
                                                   unique_indices=True)
    RKm = jnp.full(N, BIG_RANK, jnp.int32).at[dst_m].set(
        RANK, mode="drop", unique_indices=True)
    return SPs, RKs, SPm, RKm, ns, nm


@jax.jit
def _pe_cluster_counts(SP, RANK, n_valid):
    """(ns, nm): positions in singleton vs multi mate1 clusters.

    A position sits in a size-1 run iff it starts one AND the next row
    starts another — no run-bounds scans or gathers (their [N]
    temporaries next to the R/DD tables raise the human-scale peak)."""
    N = SP.shape[0]
    j = jnp.arange(N, dtype=jnp.int32)
    valid = j < n_valid
    start = jnp.concatenate([jnp.ones(1, bool), RANK[1:] != RANK[:-1]])
    nxt = jnp.concatenate([start[1:], jnp.ones(1, bool)])
    ns = jnp.sum(valid & start & nxt, dtype=jnp.int32)
    return ns, jnp.sum(valid, dtype=jnp.int32) - ns


@functools.partial(jax.jit, static_argnames=("N_out",),
                   donate_argnums=(0, 1))
def _pe_compact_multi(SP, RANK, n_valid, N_out: int):
    """Compact multi-cluster rows into right-sized buffers.

    Fast-singleton variant of :func:`_pe_partition_clusters`: singleton
    mate1 positions need no mask or stream — the slab pass reads
    singleton-ness straight off the neighbor-distance table
    (DD[p] == 0xFFFFFFFF: no same-window neighbor on either side), so
    only the multi stream is materialized, sized by a prior counts pass
    (a full-size 4-output compaction next to the DD table raises the
    human-scale peak)."""
    N = SP.shape[0]
    j = jnp.arange(N, dtype=jnp.int32)
    valid = j < n_valid
    start = jnp.concatenate([jnp.ones(1, bool), RANK[1:] != RANK[:-1]])
    nxt = jnp.concatenate([start[1:], jnp.ones(1, bool)])
    multi = valid & ~(start & nxt)
    dst_m = jnp.where(multi, jnp.cumsum(multi.astype(jnp.int32)) - 1,
                      N_out)
    SPm = jnp.full(N_out, -1, jnp.int32).at[dst_m].set(
        SP, mode="drop", unique_indices=True)
    RKm = jnp.full(N_out, BIG_RANK, jnp.int32).at[dst_m].set(
        RANK, mode="drop", unique_indices=True)
    return SPm, RKm


@functools.partial(
    jax.jit,
    static_argnames=("S", "nblk", "nfl", "K", "seqlength", "readlength",
                     "ntid", "shard_i", "shard_n"),
    donate_argnums=(0,))
def _pe_single_slabs(dense_s, DD, T32, NS, d0,
                     S: int, nblk: int, nfl: int, K: int, seqlength: int,
                     readlength: int, ntid: int, shard_i: int = 0,
                     shard_n: int = 1):
    """Fast singleton-cluster pass: contiguous position slabs, ZERO
    gathers, ZERO sorts (stranded builds).

    A singleton-cluster candidate survives iff its mate2 rank is unique
    among the row's valid candidates (any in-row duplicate sits at a
    different d = the reference multi_d drop, src/emsar_functions.c:1926;
    see _pe_single_chunk).  Uniqueness is evaluated from the packed
    global neighbor-distance table DD (nearest same-window position on
    either side, built free inside the rank pass): the left partner of
    slot dd is in-row iff prev_gap <= dd — and then automatically valid —
    while the right partner at slot dd + next_gap must clear the same
    validity bound rb the candidate itself obeys.  All reads are shifted
    SLICES of position-indexed tables (the [MV, nfl] rank gather that
    dominated the chunked singleton pass at the 675 M-row table scale is
    gone), and the dense scatter runs at tid-run scale: within a slab,
    T32 is piecewise-constant, so per-d prefix sums evaluated at run
    ends give each transcript's (tid, d) contribution — one [K, nfl]
    row scatter per slab instead of an E-scale scatter.

    Stranded-only: mate1 positions live in the fw half, so every slice
    offset stays far below Lp (no table padding), and the unstranded
    orientation rule (which breaks per-position uniqueness) never
    applies.  Returns (dense_s, overflow_flag)."""
    rl = readlength

    def body(k, carry):
        dense, flag = carry
        p0 = (shard_i + k * shard_n) * S
        i = jnp.arange(S, dtype=jnp.int32)
        p = p0 + i
        # singleton mate1 cluster <=> the window at p has no same-window
        # neighbor on either side (65535 strictly means "none"; invalid
        # windows carry 0)
        sng = jax.lax.dynamic_slice(DD, (p0,), (S,)) == jnp.uint32(
            0xFFFFFFFF)
        t = jax.lax.dynamic_slice(T32, (p0,), (S,))
        nsp = jax.lax.dynamic_slice(NS, (p0,), (S,))
        dmax = nsp - rl - p
        # candidate/partner validity bound: slot index <= rb (d-range,
        # next-separator, and in_range guards of _pe_cvalid; the
        # separator guard is on d = d0 + slot, so the slot bound is
        # dmax - d0 — missing the d0 shift overcounted every row by up
        # to d0 slots at fl_min > readlength)
        rb = jnp.minimum(jnp.minimum(jnp.int32(nfl - 1), dmax - d0),
                         seqlength - rl - d0 - p)
        rows = []
        for ddi in range(nfl):
            ddw = jax.lax.dynamic_slice(DD, (p0 + d0 + ddi,), (S,))
            gp = (ddw & jnp.uint32(0xFFFF)).astype(jnp.int32)
            gn = (ddw >> jnp.uint32(16)).astype(jnp.int32)
            keep = (sng & (gp != 0) & (ddi <= rb)
                    & (gp > ddi) & (gn > rb - ddi))
            rows.append(keep)
        keepm = jnp.stack(rows)  # [nfl, S]
        C = jnp.cumsum(keepm.astype(jnp.int32), axis=1)
        # tid-run compaction: one run end per transcript per slab
        e_mask = jnp.concatenate([t[1:] != t[:-1], jnp.ones(1, bool)])
        nend = jnp.sum(e_mask, dtype=jnp.int32)
        dst = jnp.where(e_mask, jnp.cumsum(e_mask.astype(jnp.int32)) - 1, K)
        ends = jnp.full(K, S - 1, jnp.int32).at[dst].set(
            i, mode="drop", unique_indices=True)
        prev_ends = jnp.concatenate([jnp.full(1, -1, jnp.int32), ends[:-1]])
        Ce = C[:, ends]                                       # [nfl, K]
        Cs = jnp.where(prev_ends[None, :] >= 0,
                       C[:, jnp.clip(prev_ends, 0, S - 1)], 0)
        rows_k = (Ce - Cs).T                                  # [K, nfl]
        t_k = t[ends]
        dense = dense.reshape(ntid, nfl).at[t_k].add(
            rows_k, mode="drop").reshape(ntid * nfl)
        flag = flag | (nend > K)
        return dense, flag

    return jax.lax.fori_loop(0, nblk, body,
                             (dense_s, jnp.zeros((), jnp.bool_)))


def _pe_cvalid(mpos, mrank, RW, RF32, T32, NS, d0, nfl: int,
               unstranded: bool, borderpos: int, seqlength: int,
               readlength: int, Lp: int):
    """Shared candidate-validity math for one block of mate1 positions:
    returns (cvalid [n, nfl], rw [n, nfl], tidm [n]).  Reference
    semantics: the d-loop guards of process_mate1_cluster_by_mate_3
    (src/emsar_functions.c:2854-2872) and the unstranded canonical pair
    orientation (:2863-2869) on ranks."""
    rl = readlength
    mposc = jnp.clip(mpos, 0, Lp - nfl - rl - 2)
    base = mposc + d0
    dd = jnp.arange(nfl, dtype=jnp.int32)
    cand = mpos[:, None] + d0 + dd[None, :]
    rw = RW[base[:, None] + dd[None, :]]
    in_range = cand <= seqlength - rl
    tidm = T32[mposc]
    dmax_m = NS[mposc] - rl - mpos
    cvalid = (in_range & (rw != KEY_PAD)
              & ((d0 + dd)[None, :] <= dmax_m[:, None]))
    if unstranded:
        rf = RF32[base[:, None] + dd[None, :]]
        rfp = RF32[mposc]
        cmp1 = jnp.sign(mrank[:, None] - rf).astype(jnp.int8)
        cmp2 = jnp.sign(rw.astype(jnp.int32) - rfp[:, None]).astype(jnp.int8)
        cmp = jnp.where(cmp1 != 0, cmp1, cmp2)
        keep = jnp.where(mpos[:, None] < borderpos, cmp <= 0, cmp < 0)
        cvalid = cvalid & keep
    return cvalid, rw, tidm


@functools.partial(
    jax.jit,
    static_argnames=("Ss", "nfl", "unstranded", "borderpos", "seqlength",
                     "readlength", "Lp"),
    donate_argnums=(0,))
def _pe_single_chunk(dense_s, SPs, RKs, RW, RF32, T32, NS, start, d0,
                     Ss: int, nfl: int, unstranded: bool, borderpos: int,
                     seqlength: int, readlength: int, Lp: int):
    """Candidates of one block of singleton-cluster mate1 positions.

    Every fragment run here lies within one row: a run of size >= 2
    means the same mate2 rank at >= 2 distinct d — exactly the
    reference's multi_d drop (src/emsar_functions.c:1926) — so the
    row-local duplicate-rank test replaces the global sort, and each
    surviving candidate is a size-1 run: dense_s[tid, d] += 1."""
    mpos = jax.lax.dynamic_slice(SPs, (start,), (Ss,))
    mrank = jax.lax.dynamic_slice(RKs, (start,), (Ss,))
    pvalid = mpos >= 0
    cvalid, rw, tidm = _pe_cvalid(mpos, mrank, RW, RF32, T32, NS, d0,
                                  nfl, unstranded, borderpos, seqlength,
                                  readlength, Lp)
    cvalid = cvalid & pvalid[:, None]
    dd = jnp.arange(nfl, dtype=jnp.int32)
    rwk = jnp.where(cvalid, rw, KEY_PAD)
    srw, sd = jax.lax.sort((rwk, jnp.broadcast_to(dd[None, :], rwk.shape)),
                           num_keys=1, dimension=1, is_stable=False)
    eq_prev = jnp.concatenate(
        [jnp.zeros((Ss, 1), bool), srw[:, 1:] == srw[:, :-1]], axis=1)
    eq_next = jnp.concatenate(
        [srw[:, 1:] == srw[:, :-1], jnp.zeros((Ss, 1), bool)], axis=1)
    keep = (srw != KEY_PAD) & ~(eq_prev | eq_next)
    flat = jnp.where(keep, tidm[:, None] * nfl + sd,
                     dense_s.shape[0]).reshape(-1)
    return dense_s.at[flat].add(1, mode="drop")


@functools.partial(
    jax.jit,
    static_argnames=("M", "V", "nfl", "max_repeat", "unstranded",
                     "borderpos", "seqlength", "readlength", "Lp"))
def _pe_expand_sort(RW, RF32, T32, NS, m1pos_ext, m1rank_ext, start_idx,
                    d0,
                    M: int, V: int, nfl: int, max_repeat: int,
                    unstranded: bool, borderpos: int, seqlength: int,
                    readlength: int, Lp: int):
    """One chunk of mate1 clusters: enumerate (member, d) candidates,
    sort by (cluster, mate2-rank), probe record/member demand.

    Reference semantics: process_mate1_cluster_by_mate_3 +
    construct_rshbucket_PE_3 (src/emsar_functions.c:2823-2934, 1902-1974).
    Returns the sorted (cluster-key, mate2-rank, payload) stream plus
    (rec_cnt, mult_elems) so the accumulate launch sizes its record and
    member tables to actual demand (see _se_bucket_sort).
    """
    rl = readlength
    MV = M + V
    j = jnp.arange(MV, dtype=jnp.int32)
    mpos = jax.lax.dynamic_slice(m1pos_ext, (start_idx,), (MV,))
    mrank = jax.lax.dynamic_slice(m1rank_ext, (start_idx,), (MV,))
    prevrank = jax.lax.dynamic_slice(m1rank_ext, (start_idx - 1,), (MV,))
    cstart = mrank != prevrank
    mvalid = mrank < BIG_RANK
    my_cs, _ = _run_bounds(cstart)
    owned = (cstart & (j < M))[jnp.clip(my_cs, 0, None)] & mvalid

    cvalid, rw, tidm = _pe_cvalid(mpos, mrank, RW, RF32, T32, NS, d0,
                                  nfl, unstranded, borderpos, seqlength,
                                  readlength, Lp)
    cvalid = cvalid & owned[:, None]
    dd = jnp.arange(nfl, dtype=jnp.int32)

    ckey = jnp.where(cvalid, jnp.broadcast_to(
        mrank.astype(jnp.uint32)[:, None], (MV, nfl)), KEY_PAD).reshape(-1)
    rkey = jnp.where(cvalid, rw, KEY_PAD).reshape(-1)
    # (tid, d) packed into the payload operand: a post-sort tid gather at
    # E scale costs more than the whole 3-operand sort's third lane.
    # tid < 2^23 is guaranteed by the caller (MAX_NFL_PACKED = 2^9).
    pay = ((tidm.astype(jnp.uint32) << jnp.uint32(9))[:, None]
           | dd[None, :].astype(jnp.uint32)).reshape(-1)
    sck, srk, spay = jax.lax.sort((ckey, rkey, pay), num_keys=2,
                                  is_stable=False)
    startf = jnp.concatenate([jnp.ones(1, bool),
                              (sck[1:] != sck[:-1]) | (srk[1:] != srk[:-1])])
    validrow = sck != KEY_PAD
    j = jnp.arange(MV * nfl, dtype=jnp.int32)
    _, next_start = _run_bounds(startf)
    cntr = next_start - j
    rec = startf & validrow & (cntr > 1) & (cntr < max_repeat)
    return (sck, srk, spay, jnp.sum(rec, dtype=jnp.int32),
            jnp.sum(jnp.where(rec, cntr, 0), dtype=jnp.int32))


@functools.partial(
    jax.jit, static_argnames=("nfl", "max_repeat", "U"),
    donate_argnums=(0, 1, 2))
def _pe_chunk_accum(state, sck, srk, spay, chunk_id, chunk_base,
                    nfl: int, max_repeat: int, U: int):
    """Run accumulation over one sorted PE candidate stream (second phase
    of _pe_expand_sort).  ``spay`` is NOT donated: the member-extraction
    launch reads it afterwards."""
    stid = (spay >> jnp.uint32(9)).astype(jnp.int32)
    startf = jnp.concatenate([jnp.ones(1, bool),
                              (sck[1:] != sck[:-1]) | (srk[1:] != srk[:-1])])
    validrow = sck != KEY_PAD
    d_ind = (spay & jnp.uint32(0x1FF)).astype(jnp.int32)
    # (chunk, id) is the member-group identity at scale; chunk_base only
    # suppresses cross-launch claim steals (see _postsort_accumulate)
    return _postsort_accumulate(state, startf, validrow, d_ind, stid,
                                chunk_base, nfl, max_repeat, U,
                                chunk_id=chunk_id)


# --------------------------------------------------------------------------
# PE delta-shift global pipeline (streams that fit HBM)
#
# The cluster-chunked expansion above fetches every candidate's mate2
# rank with an E-scale random gather (cluster members are scattered in
# position space) — measured ~120 M elems/s, it dominates a chunk.  In
# POSITION-major delta-major order every operand is a contiguous slice:
# candidate (p, d0+dd) has keys (R[p], R[p + d0 + dd]) where both
# factors are shifted copies of the SAME rank table, and the orientation
# ranks RF32[p] / RF32[p+d0+dd] and tid T32[p] are slices too.  One
# global 3-operand sort by (mate1 rank, mate2 rank) then groups exactly
# the reference's runs (process_mate1_cluster_by_mate_3 + multi_d,
# src/emsar_functions.c:2823-2934, 1926) — the fragment-length index
# rides in the payload and the multi-d test is the accumulate's
# adjacent-d check.  Singleton mate1 clusters need no special pass: a
# same-(p)-different-d duplicate becomes a 2-element mixed-d run, which
# the multi-d filter drops — the same verdict as the row-local
# duplicate-rank test.
#
# Used whenever the whole candidate stream fits the memory budget
# (PE_GLOBAL_BUDGET elements); larger builds use the cluster-chunked
# path above.
# --------------------------------------------------------------------------

PE_GLOBAL_BUDGET = int(os.environ.get("EMSAR_PE_GLOBAL_BUDGET", 5 << 26))


@functools.partial(
    jax.jit,
    static_argnames=("Np", "nfl", "unstranded", "borderpos", "seqlength",
                     "readlength"))
def _pe_stream_gen(R, RF32, T32, NS, d0, Np: int, nfl: int,
                   unstranded: bool, borderpos: int, seqlength: int,
                   readlength: int):
    """(A, B, PAY) for every (position, d) candidate, delta-major — all
    operands are dynamic slices of position-indexed tables (no gathers).

    A = mate1 rank (KEY_PAD on any invalid/dropped candidate), B = mate2
    rank, PAY = (tid << 9) | d-index.  Validity and the unstranded
    canonical orientation mirror _pe_cvalid exactly."""
    rl = readlength
    i = jnp.arange(Np, dtype=jnp.int32)

    def sl(tab, off):
        return jax.lax.dynamic_slice(tab, (off,), (Np,))

    a = sl(R, jnp.int32(0))
    tidm = sl(T32, jnp.int32(0))
    ns = sl(NS, jnp.int32(0))
    if unstranded:
        rfp = sl(RF32, jnp.int32(0))
    rowA, rowB, rowP = [], [], []
    for ddi in range(nfl):
        dd = jnp.int32(ddi)
        b = sl(R, d0 + dd)
        valid = ((i <= seqlength - rl - d0 - dd) & (a < BIG_RANK)
                 & (b < BIG_RANK) & (d0 + dd <= ns - rl - i))
        if unstranded:
            rf = sl(RF32, d0 + dd)
            cmp1 = jnp.sign(a - rf).astype(jnp.int8)
            cmp2 = jnp.sign(b - rfp).astype(jnp.int8)
            cmp = jnp.where(cmp1 != 0, cmp1, cmp2)
            valid = valid & jnp.where(i < borderpos, cmp <= 0, cmp < 0)
        rowA.append(jnp.where(valid, a.astype(jnp.uint32), KEY_PAD))
        rowB.append(jnp.where(valid, b.astype(jnp.uint32), KEY_PAD))
        rowP.append(jnp.where(
            valid,
            (tidm.astype(jnp.uint32) << jnp.uint32(9)) | jnp.uint32(ddi),
            jnp.uint32(0)))
    A = jnp.stack(rowA).reshape(-1)
    B = jnp.stack(rowB).reshape(-1)
    P = jnp.stack(rowP).reshape(-1)
    return A, B, P


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _sort_payload3(A, B, P):
    return jax.lax.sort((A, B, P), num_keys=2, is_stable=False)


@functools.partial(jax.jit, static_argnames=("E", "Q", "n_chunks",
                                             "max_repeat"))
def _pe_stream_stats(A, B, E: int, Q: int, n_chunks: int, max_repeat: int):
    """ONE pass over the sorted stream: per-chunk record counts + the
    valid row count.  Replaces a per-chunk probe launch (each cost an
    Ew-wide pass plus a host round trip); chunk ownership matches
    _pe_stream_chunk (a run belongs to the chunk containing its start).
    A/B are the padded arrays (row 0 is the lookback pad)."""
    j = jnp.arange(E, dtype=jnp.int32)
    a = jax.lax.dynamic_slice(A, (1,), (E,))
    b = jax.lax.dynamic_slice(B, (1,), (E,))
    diff = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    start = jnp.concatenate([jnp.ones(1, bool), diff])
    _, next_start = _run_bounds(start)
    cntr = next_start - j
    rec = start & (a != KEY_PAD) & (cntr > 1) & (cntr < max_repeat)
    S = jnp.cumsum(rec.astype(jnp.int32))
    # rec starts in [k*Q, (k+1)*Q) belong to chunk k
    edge = jnp.minimum(jnp.arange(1, n_chunks + 1, dtype=jnp.int32) * Q,
                       E) - 1
    Se = S[edge]
    per_chunk = jnp.concatenate([Se[:1], Se[1:] - Se[:-1]])
    n_valid = jnp.sum(a != KEY_PAD, dtype=jnp.int32)
    return per_chunk, n_valid


@functools.partial(
    jax.jit, static_argnames=("Q", "V", "nfl", "max_repeat", "U"),
    donate_argnums=(0,))
def _pe_stream_chunk(state, A, B, P, q0, chunk_id, chunk_base,
                     Q: int, V: int, nfl: int, max_repeat: int, U: int):
    """Accumulate runs whose start lies in sorted rows [q0, q0+Q) of the
    global delta-shift stream (same window discipline as
    _se_sorted_chunk; d and tid unpack from the payload; winner starts
    are slice-relative — extraction passes src0 = q0 against P)."""
    Ew = 1 + Q + V
    j = jnp.arange(Ew, dtype=jnp.int32)
    a = jax.lax.dynamic_slice(A, (q0,), (Ew,))
    b = jax.lax.dynamic_slice(B, (q0,), (Ew,))
    p = jax.lax.dynamic_slice(P, (q0,), (Ew,))
    diff = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    start = jnp.concatenate([jnp.ones(1, bool), diff])
    ownedrun = start & (j >= 1) & (j <= Q)
    my_start, _ = _run_bounds(start)
    rv = ownedrun[jnp.clip(my_start, 0, Ew - 1)] & (a != KEY_PAD)
    d_ind = (p & jnp.uint32(0x1FF)).astype(jnp.int32)
    tid = (p >> jnp.uint32(9)).astype(jnp.int32)
    return _postsort_accumulate(state, start, rv, d_ind, tid, chunk_base,
                                nfl, max_repeat, U, chunk_id=chunk_id)


# --------------------------------------------------------------------------
# SE sorted-stream kernels (hash slabs -> one global sort -> chunked
# run accumulation).  Reference semantics:
# initialize_suffixarray_{NS_5,SS_4} + quicksort + construct_rshbucket_2
# (src/emsar_functions.c:949-1038, 1108-1149, 1758-1819).
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_keys",),
                   donate_argnums=(0, 1, 2, 3))
def _sort_payload4(H1, H2, H3, TD, num_keys: int = 3):
    """Global 4-operand sort by the 96-bit window identity (invalid rows
    carry the all-ones identity and sort last).  ``num_keys=4`` also
    orders the payload within identity runs — the PE rank pass uses it so
    same-window positions come out position-sorted (the neighbor-distance
    table of the fast singleton pass needs within-run position order)."""
    return jax.lax.sort((H1, H2, H3, TD), num_keys=num_keys,
                        is_stable=False)


@functools.partial(jax.jit, static_argnames=("tail",))
def _pad_sorted(S, fill, tail: int):
    """[fill] + S + [fill]*tail — the 1-row lookback and lookahead margin
    the chunked accumulation slices into."""
    return jnp.concatenate([jnp.full(1, fill, S.dtype), S,
                            jnp.full(tail, fill, S.dtype)])


@functools.partial(jax.jit, static_argnames=("Q", "V", "max_repeat"))
def _se_chunk_probe(S1, S2, S3, q0, n_valid, Q: int, V: int,
                    max_repeat: int):
    """Record/member demand of the sorted-stream chunk at q0 (the same
    run-ownership rules as _se_sorted_chunk): (rec_cnt, mult_elems), so
    the accumulate launch sizes its record/member tables to actual
    demand instead of the chunk capacity (see _se_bucket_sort)."""
    Ew = 1 + Q + V
    j = jnp.arange(Ew, dtype=jnp.int32)
    s1 = jax.lax.dynamic_slice(S1, (q0,), (Ew,))
    s2 = jax.lax.dynamic_slice(S2, (q0,), (Ew,))
    s3 = jax.lax.dynamic_slice(S3, (q0,), (Ew,))
    diff = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1]) | (s3[1:] != s3[:-1])
    start = jnp.concatenate([jnp.ones(1, bool), diff])
    ownedrun = start & (j >= 1) & (j <= Q)
    my_start, next_start = _run_bounds(start)
    valid = (q0 + j) <= n_valid
    rv = ownedrun[jnp.clip(my_start, 0, Ew - 1)] & valid
    cntr = next_start - j
    rec = start & rv & (cntr > 1) & (cntr < max_repeat)
    return (jnp.sum(rec, dtype=jnp.int32),
            jnp.sum(jnp.where(rec, cntr, 0), dtype=jnp.int32))


@functools.partial(
    jax.jit, static_argnames=("Q", "V", "nfl", "max_repeat", "U"),
    donate_argnums=(0,))
def _se_sorted_chunk(state, S1, S2, S3, ST, q0, fl_ind, chunk_id,
                     chunk_base, n_valid,
                     Q: int, V: int, nfl: int, max_repeat: int,
                     U: int):
    """Accumulate runs whose start lies in sorted rows [q0, q0+Q).

    Winner run starts (win_start) are relative to this Ew slice; the
    member-extraction launch passes src0 = q0 against the full ST array.

    The slice carries a 1-row lookback (exact run-start detection at the
    chunk edge) and a V-row lookahead with V > max_repeat: every run that
    must be measured exactly (singles, records < max_repeat) is fully
    contained, and a run censored at the slice end has cntr >= V, which
    classifies it as >= max_repeat — the same verdict its true size
    would produce."""
    Ew = 1 + Q + V
    j = jnp.arange(Ew, dtype=jnp.int32)
    s1 = jax.lax.dynamic_slice(S1, (q0,), (Ew,))
    s2 = jax.lax.dynamic_slice(S2, (q0,), (Ew,))
    s3 = jax.lax.dynamic_slice(S3, (q0,), (Ew,))
    st = jax.lax.dynamic_slice(ST, (q0,), (Ew,))
    diff = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1]) | (s3[1:] != s3[:-1])
    start = jnp.concatenate([jnp.ones(1, bool), diff])
    ownedrun = start & (j >= 1) & (j <= Q)
    my_start, _ = _run_bounds(start)
    # padded slice row j = sorted row q0 + j - 1; valid rows sort first
    valid = (q0 + j) <= n_valid
    rv = ownedrun[jnp.clip(my_start, 0, Ew - 1)] & valid
    d_ind = jnp.full(Ew, fl_ind, dtype=jnp.int32)
    return _postsort_accumulate(state, start, rv, d_ind, st, chunk_base,
                                nfl, max_repeat, U, chunk_id=chunk_id)


# --------------------------------------------------------------------------
# hash-partitioned SE pipeline (builds beyond the single-sort limit)
#
# Window payloads (3-lane 96-bit canonical-window hash + tid) are computed
# CONTIGUOUSLY per slab — every sequence access is a dynamic_slice (+flip
# for the rc strand), never a random gather from the [Lp] code table.
# The payload is then radix-partitioned once by the hash's top bits
# (uniform buckets by construction — equal windows share all lanes), and
# each bucket is one contiguous slice -> one small sort -> accumulate.
# --------------------------------------------------------------------------


def _p16_range(packed, q, n: int):
    """Window words p16[q : q+n] unpacked straight from the 2-bit code
    bytes (p16[k] = codes of bases [k, k+16), big-endian).  ``q`` is a
    traced scalar: the aligned prefix q0 = q & ~3 makes every byte stream
    a repeat(dynamic_slice) — a reshape, ~30x faster than a byte gather on
    this hardware — and the final slice drops the q & 3 misalignment.
    Nothing [Lp]-sized is ever materialized."""
    q0 = q - (q & 3)
    nb = n // 4 + 2

    def bytes_at(j):
        return jnp.repeat(jax.lax.dynamic_slice(
            packed, ((q0 >> 2) + j,), (nb,)).astype(jnp.uint32), 4)

    b = [bytes_at(j) for j in range(5)]
    W = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    sh = (2 * (jnp.arange(4 * nb, dtype=jnp.uint32) & 3)).astype(jnp.uint32)
    pal = (W << sh) | (b[4] >> (jnp.uint32(8) - sh))
    return jax.lax.dynamic_slice(pal, (q & 3,), (n,))


def _bad_win(badbits, s0, n: int, rl: int):
    """Count of non-ACGT bases in window [i, i+rl) for i in [s0, s0+n):
    slab-local exclusive cumsum over the bad bitfield — the global [Lp+1]
    prefix table this replaces was 4 bytes/base.  ``s0`` may be any
    alignment (the PE rc half starts at arbitrary offsets); the byte
    slice starts at the aligned prefix and the final slices drop the
    s0 & 7 misalignment."""
    a = s0 & 7
    nbits = n + _pad_to(rl, 8) + 16
    by = jax.lax.dynamic_slice(badbits, ((s0 - a) >> 3,), (nbits // 8,))
    b8 = jnp.repeat(by.astype(jnp.uint8), 8)
    idx = jnp.arange(nbits, dtype=jnp.int32)
    bits = (b8 >> (7 - (idx & 7)).astype(jnp.uint8)) & 1
    ex = jnp.concatenate([jnp.zeros(1, jnp.int32),
                          jnp.cumsum(bits.astype(jnp.int32))])
    return (jax.lax.dynamic_slice(ex, (a + rl,), (n,))
            - jax.lax.dynamic_slice(ex, (a,), (n,)))


def _slab_words_packed(packed, s0, slab: int, rl: int, seqlength,
                       unstranded: bool):
    """Canonical window words for the contiguous positions [s0, s0+slab),
    unpacked slab-locally (fw ascending; rc word w of window i sits at
    seqlength - i - rl + 16w — descending in i, so it is the flip of the
    range ending at s0's rc position)."""
    W = pack.n_words(rl)
    fw = [_p16_range(packed, s0 + 16 * w, slab) for w in range(W)]
    rem = rl - 16 * (W - 1)
    sh = jnp.uint32(2 * (16 - rem)) if rem < 16 else None
    if sh is not None:
        fw[W - 1] = fw[W - 1] >> sh
    if not unstranded:
        return fw
    rc = []
    for w in range(W):
        start = seqlength - rl + 16 * w - s0 - (slab - 1)
        rc.append(jnp.flip(_p16_range(packed, start, slab)))
    if sh is not None:
        rc[W - 1] = rc[W - 1] >> sh
    cmp = jnp.zeros(slab, jnp.int8)
    for w in range(W):
        c = (fw[w] > rc[w]).astype(jnp.int8) - (fw[w] < rc[w]).astype(jnp.int8)
        cmp = jnp.where(cmp == 0, c, cmp)
    return [jnp.where(cmp <= 0, f, r) for f, r in zip(fw, rc)]


def _hash3_cols(words):
    """3 x uint32 multilinear hash lanes of a word-column list (the 96-bit
    window identity; lanes mirror kernels._hash4 rows 0..2)."""
    mult = np.asarray(_MULT)
    out = []
    for lane in range(3):
        acc = jnp.zeros(words[0].shape[0], jnp.uint32)
        for w, col in enumerate(words):
            acc = acc + col * jnp.uint32(mult[lane, w])
            acc = acc ^ (acc >> jnp.uint32(16)) * jnp.uint32(0x85EBCA6B)
        out.append(acc)
    return out


@functools.partial(jax.jit, static_argnames=("size",))
def _tid_forward(cuml, size: int):
    """tid of every forward position [0, size): cumsum over transcript-
    start marks.  (searchsorted per window costs log2(ntid) tiny gathers
    per position — ~600M gathers at human scale.)"""
    marks = jnp.zeros(size, jnp.int32).at[cuml].add(1, mode="drop")
    return jnp.cumsum(marks) - 1


@functools.partial(
    jax.jit, static_argnames=("slab", "unstranded", "readlength"),
    donate_argnums=(0, 1, 2, 3))
def _se_hash_slab(H1, H2, H3, TD, packed, badbits, tidf, s0, borderpos,
                  seqlength, slab: int, unstranded: bool, readlength: int):
    """Fill payload arrays for positions [s0, s0+slab): 96-bit canonical
    window hash + transcript id (negative = invalid window).

    Everything is unpacked slab-locally from the 2-bit code bytes — no
    [Lp]-sized table exists anywhere (at human scale the global p16+badp
    pair alone is 5.4 GB).  s0/borderpos/seqlength are
    traced, so one executable serves every slab of every same-scale
    transcriptome."""
    rl = readlength
    i = s0 + jnp.arange(slab, dtype=jnp.int32)
    valid = (i <= borderpos - rl) & (_bad_win(badbits, s0, slab, rl) == 0)
    words = _slab_words_packed(packed, s0, slab, rl, seqlength, unstranded)
    h1, h2, h3 = _hash3_cols(words)
    tid = jax.lax.dynamic_slice(tidf, (s0,), (slab,))
    tid = jnp.where(valid, tid, -1)
    h1 = jnp.where(valid, h1, CLAIM_EMPTY)
    h2 = jnp.where(valid, h2, CLAIM_EMPTY)
    h3 = jnp.where(valid, h3, CLAIM_EMPTY)
    H1 = jax.lax.dynamic_update_slice(H1, h1, (s0,))
    H2 = jax.lax.dynamic_update_slice(H2, h2, (s0,))
    H3 = jax.lax.dynamic_update_slice(H3, h3, (s0,))
    TD = jax.lax.dynamic_update_slice(TD, tid, (s0,))
    return H1, H2, H3, TD, jnp.sum(valid, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("kbits",), donate_argnums=(0,))
def _radix_rank_step(RANK, H1, TD, b, kbits: int):
    """rank-within-bucket + size of bucket b (one cumsum pass; the bucket
    sizes double as the histogram — a scatter-add histogram serializes on
    its fully-colliding indices)."""
    m = (TD >= 0) & ((H1 >> jnp.uint32(32 - kbits)).astype(jnp.int32)
                     == b.astype(jnp.int32))
    r = jnp.cumsum(m.astype(jnp.int32)) - 1
    return jnp.where(m, r, RANK), jnp.sum(m, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("kbits", "out_size"))
def _radix_dst(H1, TD, RANK, off, kbits: int, out_size: int):
    """Bucket-major destination of every row (invalid rows land at
    out_size and are dropped).  ``out_size`` is padded past the last
    bucket by one bucket capacity so per-bucket dynamic slices never
    clamp backward into the previous bucket."""
    b = (H1 >> jnp.uint32(32 - kbits)).astype(jnp.int32)
    return jnp.where(TD >= 0, off[jnp.clip(b, 0, off.shape[0] - 1)] + RANK,
                     out_size)


@functools.partial(jax.jit, static_argnames=("out_size",))
def _scatter_one(src, dst, out_size: int):
    """One payload operand into bucket-major order.  Sequential
    per-operand programs (each source deleted by the caller right after
    its scatter) keep the partition's peak to ~1 operand extra; a single
    8-array program holds every input AND output live at once — 11+ GB
    at human scale.  (No donation: out_size > the source shape, so
    aliasing is impossible and the annotation only warns.)"""
    return jnp.zeros(out_size, src.dtype).at[dst].set(src, mode="drop")


@functools.partial(jax.jit,
                   static_argnames=("Bcap", "max_repeat", "num_keys"),
                   donate_argnums=())
def _se_bucket_sort(P1, P2, P3, PT, off_b, cnt_b, Bcap: int,
                    max_repeat: int, num_keys: int = 3):
    """Sort one partitioned bucket and probe its record/member demand.

    Rows beyond cnt_b get all-ones keys so they sort last (a real window
    aliasing the all-ones 96-bit hash is ~2^-96).  Returns the sorted
    payload plus (rec_cnt, mult_elems): the number of multi runs below
    max_repeat and the total elements they hold — the accumulate kernel's
    record/member tables are then sized to the actual demand instead of
    the bucket capacity (the U/C2-scale claim and extraction ops dominate
    a full-capacity launch ~5x; tools/microbench measured 4.4s -> 0.8s at
    Bcap=12.6M with U,C2=1M)."""
    j = jnp.arange(Bcap, dtype=jnp.int32)
    valid = j < cnt_b
    h1 = jnp.where(valid, jax.lax.dynamic_slice(P1, (off_b,), (Bcap,)),
                   jnp.uint32(0xFFFFFFFF))
    h2 = jnp.where(valid, jax.lax.dynamic_slice(P2, (off_b,), (Bcap,)),
                   jnp.uint32(0xFFFFFFFF))
    h3 = jnp.where(valid, jax.lax.dynamic_slice(P3, (off_b,), (Bcap,)),
                   jnp.uint32(0xFFFFFFFF))
    td = jnp.where(valid, jax.lax.dynamic_slice(PT, (off_b,), (Bcap,)), 0)
    s1, s2, s3, stid = jax.lax.sort((h1, h2, h3, td), num_keys=num_keys,
                                    is_stable=False)
    diff = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1]) | (s3[1:] != s3[:-1])
    startf = jnp.concatenate([jnp.ones(1, bool), diff])
    _, next_start = _run_bounds(startf)
    cntr = next_start - j
    rec = startf & valid & (cntr > 1) & (cntr < max_repeat)
    rec_cnt = jnp.sum(rec, dtype=jnp.int32)
    mult_elems = jnp.sum(jnp.where(rec, cntr, 0), dtype=jnp.int32)
    return s1, s2, s3, stid, rec_cnt, mult_elems


@functools.partial(
    jax.jit, static_argnames=("Bcap", "nfl", "max_repeat", "U"),
    donate_argnums=(0, 1, 2, 3))
def _se_bucket_accum(state, S1, S2, S3, ST, cnt_b, fl_ind,
                     chunk_id, chunk_base, Bcap: int, nfl: int,
                     max_repeat: int, U: int):
    """Run accumulation over one sorted bucket (second phase of
    _se_bucket_sort; the run-start recompute is 3 compares).  ``ST`` is
    NOT donated: the member-extraction launch reads it afterwards."""
    j = jnp.arange(Bcap, dtype=jnp.int32)
    diff = (S1[1:] != S1[:-1]) | (S2[1:] != S2[:-1]) | (S3[1:] != S3[:-1])
    startf = jnp.concatenate([jnp.ones(1, bool), diff])
    validrow = j < cnt_b  # invalid rows sort to the tail
    d_ind = jnp.full(Bcap, fl_ind, dtype=jnp.int32)
    return _postsort_accumulate(state, startf, validrow, d_ind, ST,
                                chunk_base, nfl, max_repeat, U,
                                chunk_id=chunk_id)


# --------------------------------------------------------------------------
# prefix partitioning (PE rank pass beyond the single-sort limit)
# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# final on-device aggregation of signature records
# --------------------------------------------------------------------------


def _tab_aggregate(tab_h1, tab_h2, tab_h3fl, tab_cnt):
    """Shared core: sort records, sum counts per unique (hash, fraglen)
    row, compact unique rows to the front.  Returns (h1, h2, h3fl, cnt,
    n_unique) with rows [0, n_unique) valid.

    Dead rows carry the all-ones identity (and cnt 0), so they sort last
    with no separate flag operand; a real signature aliasing the all-ones
    87-bit identity is lost w.p. ~2^-87 (within the design's documented
    multiset-hash risk).  The unique-row compaction is an order-preserving
    cumsum + scatter, not a second full-width sort."""
    o = jax.lax.sort((tab_h1, tab_h2, tab_h3fl, tab_cnt), num_keys=3,
                     is_stable=False)
    h1, h2, h3, cnt = o
    diff = (h1[1:] != h1[:-1]) | (h2[1:] != h2[:-1]) | (h3[1:] != h3[:-1])
    start = jnp.concatenate([jnp.ones(1, bool), diff])
    _, ns = _run_bounds(start)
    csum = _run_sum_at_start(cnt, ns)
    dead = (h1 == CLAIM_EMPTY) & (h2 == CLAIM_EMPTY) & (h3 == CLAIM_EMPTY)
    head = start & ~dead
    n_unique = jnp.sum(head, dtype=jnp.int32)
    K = h1.shape[0]
    dst = jnp.where(head, jnp.cumsum(head.astype(jnp.int32)) - 1, K)
    u1 = jnp.full(K, CLAIM_EMPTY, jnp.uint32).at[dst].set(h1, mode="drop")
    u2 = jnp.full(K, CLAIM_EMPTY, jnp.uint32).at[dst].set(h2, mode="drop")
    u3 = jnp.full(K, CLAIM_EMPTY, jnp.uint32).at[dst].set(h3, mode="drop")
    uc = jnp.zeros(K, jnp.uint32).at[dst].set(csum, mode="drop")
    return u1, u2, u3, uc, n_unique


@functools.partial(jax.jit, static_argnames=("K",), donate_argnums=(0,))
def _tab_fold(state, K: int):
    """In-place aggregation of the record table: frees buffer space so
    arbitrarily many launches fit in a fixed TABCAP (records per unique
    (signature, fraglen) row collapse to one counted row).

    Only the first ``K`` rows (a pow2 prefix covering the live appends,
    which are contiguous from 0) are sorted — folding the whole capacity
    buffer cost a full TABCAP-width sort per fold at human scale."""
    h1, h2, h3, cnt, n_unique = _tab_aggregate(
        state["tab_h1"][:K], state["tab_h2"][:K],
        state["tab_h3fl"][:K], state["tab_cnt"][:K])
    out = dict(state)

    def wr(buf, vals):
        return jax.lax.dynamic_update_slice(buf, vals, (0,))

    out["tab_h1"] = wr(state["tab_h1"], h1)
    out["tab_h2"] = wr(state["tab_h2"], h2)
    out["tab_h3fl"] = wr(state["tab_h3fl"], h3)
    out["tab_cnt"] = wr(state["tab_cnt"], cnt)
    out["tab_n"] = n_unique
    return out


@functools.partial(jax.jit, donate_argnums=(0,))
def _tab_clear(state):
    """Reset the record table after a host drain.  A plain tab_n reset
    would leave the drained unique rows in place below the next fold's
    pow2 prefix, double-counting them — the buffers must return to the
    all-ones/zero dead-row state."""
    out = dict(state)
    out["tab_h1"] = jnp.full_like(state["tab_h1"], CLAIM_EMPTY)
    out["tab_h2"] = jnp.full_like(state["tab_h2"], CLAIM_EMPTY)
    out["tab_h3fl"] = jnp.full_like(state["tab_h3fl"], CLAIM_EMPTY)
    out["tab_cnt"] = jnp.zeros_like(state["tab_cnt"])
    out["tab_n"] = jnp.zeros((), jnp.int32)
    return out


@functools.partial(jax.jit, static_argnames=("UCAP",),
                   donate_argnums=(0, 1, 2, 3))
def _tab_finalize(tab_h1, tab_h2, tab_h3fl, tab_cnt, UCAP: int):
    """Aggregate per-run records into unique (signature-hash, fraglen)
    counts; returns (h1, h2, h3fl, count)[UCAP] + n_unique."""
    h1, h2, h3, cnt, n_unique = _tab_aggregate(
        tab_h1, tab_h2, tab_h3fl, tab_cnt)
    return (h1[:UCAP], h2[:UCAP], h3[:UCAP], cnt[:UCAP], n_unique)

@functools.partial(jax.jit, static_argnames=("SIGROWS",))
def _sig_rows_by_index(sig_dir, SIGROWS: int):
    """Compact the slot-indexed signature directory to row order: one
    [SLOTCAP, 4] -> [SIGROWS, 4] scatter keyed by each occupied slot's
    stored row+1 (finalize-only; rows past sig_n stay zero)."""
    rowp = sig_dir[:, 3].astype(jnp.int32)
    dst = jnp.where(rowp > 0, rowp - 1, SIGROWS)
    # no unique_indices: every empty slot shares the same dropped index
    return jnp.zeros((SIGROWS, 4), jnp.uint32).at[dst].set(
        sig_dir, mode="drop")


# --------------------------------------------------------------------------
# host orchestration
# --------------------------------------------------------------------------


def _caps_partitioned(ncand_hint: int, nfl: int = 1) -> Dict[str, int]:
    """Capacities for prefix-partitioned builds: the record table folds in
    place, members drain to host, so these bound *live* data, not totals.
    ~1.2 GB device memory at the ceilings (human-scale PE also keeps four
    [Lp] rank-space tables resident, so state headroom matters).

    SIGSLOT/SIGROWS (> 0 when enabled) size the SIGNATURE-keyed dense
    accumulator: the F1-400 human workload holds 76 M unique
    (signature, fraglen) rows that recur across the whole cluster-rank
    space — any per-(sig, fl) record table below the unique count
    re-drains the active set once per epoch (measured: 537 MB host
    drain every other chunk) — but only 294 K unique SIGNATURES, so a
    signature-keyed directory with per-row dense fraglen count vectors
    holds the whole multi-record state in ~0.6 GB and the (sig, fl)
    append table carries only hash-slot collisions and row spill.
    Enabled for big builds by default; EMSAR_SIG_TABLE=1/0 overrides."""
    n = max(int(ncand_hint), 1)
    big = n > (1 << 33)
    sig_env = os.environ.get("EMSAR_SIG_TABLE", "")
    use_sig = big if sig_env == "" else sig_env != "0"
    if use_sig:
        # directory slots ~32x the expected unique-signature count keep
        # the collision (-> append-table) rate negligible; dense rows are
        # memory-bounded (~0.6 GB at nfl=300) and spill gracefully
        sigslot = (1 << 23) if big else min(
            _next_pow2(max(n // 8, 1024)), 1 << 23)
        rows_mem = 1 << (((768 << 20) // (4 * max(nfl, 1))).bit_length() - 1)
        sigrows = max(min((1 << 21) if not big else rows_mem,
                          rows_mem, _next_pow2(max(n // 8, 1024))), 1024)
    else:
        sigslot = sigrows = 0
    return dict(
        # with the signature table the append path carries only
        # collisions/spill, so big builds keep the 2^25 table (a 2^26
        # fold next to the expansion working set raises the peak)
        TABCAP=(1 << 26) if (big and not use_sig)
        else min(_next_pow2(n + 1024), 1 << 25),
        MEMCAP=min(_next_pow2(2 * n + 64), 1 << 24),
        CLAIM=min(_next_pow2(max(n // 2, 1024)), 1 << 25),
        UCAP=(1 << 26) if big else min(_next_pow2(n + 64), 1 << 25),
        SIGSLOT=sigslot, SIGROWS=sigrows,
    )


@functools.partial(jax.jit,
                   static_argnames=("n_dense", "tabcap", "memcap", "claim",
                                    "sigslot", "sigrows", "nfl"))
def _init_state_dev(n_dense: int, tabcap: int, memcap: int, claim: int,
                    sigslot: int = 0, sigrows: int = 0, nfl: int = 1):
    """All state buffers materialized in ONE device program (eagerly, each
    full/zeros is a separate dispatch).

    ``sigslot > 0`` adds the signature-keyed dense accumulator:
    ``sig_dir`` [sigslot, 4] open-address directory rows
    (id1, id2, id3, row+1; row+1 == 0 marks an empty slot) and
    ``sig_dense`` [sigrows * nfl] per-signature dense fraglen counts."""
    st = dict(
        dense=jnp.zeros(n_dense, jnp.int32),
        tab_h1=jnp.full(tabcap, CLAIM_EMPTY, jnp.uint32),
        tab_h2=jnp.full(tabcap, CLAIM_EMPTY, jnp.uint32),
        tab_h3fl=jnp.full(tabcap, CLAIM_EMPTY, jnp.uint32),
        tab_cnt=jnp.zeros(tabcap, jnp.uint32),
        tab_n=jnp.zeros((), jnp.int32),
        mem_sg=jnp.zeros(memcap, jnp.int32),
        mem_tid=jnp.zeros(memcap, jnp.int32),
        mem_chunk=jnp.zeros(memcap, jnp.int32),
        mem_n=jnp.zeros((), jnp.int32),
        claim1=jnp.full(claim, CLAIM_EMPTY, jnp.uint32),
        claim2=jnp.full(claim, CLAIM_EMPTY, jnp.uint32),
        claim3=jnp.full(claim, CLAIM_EMPTY, jnp.uint32),
        flags=jnp.zeros(4, jnp.int32),
    )
    if sigslot:
        st["sig_dir"] = jnp.zeros((sigslot, 4), jnp.uint32)
        st["sig_dense"] = jnp.zeros(sigrows * nfl, jnp.uint32)
        st["sig_n"] = jnp.zeros((), jnp.int32)
        st["sig_stats"] = jnp.zeros(4, jnp.uint32)
    return st


def _init_state(ntid: int, nfl: int, caps: Dict[str, int]):
    return _init_state_dev(n_dense=ntid * nfl, tabcap=caps["TABCAP"],
                           memcap=caps["MEMCAP"], claim=caps["CLAIM"],
                           sigslot=caps.get("SIGSLOT", 0),
                           sigrows=caps.get("SIGROWS", 0), nfl=nfl)


@functools.partial(jax.jit, static_argnames=("Lp", "nv", "two"),
                   donate_argnums=(0,))
def _pe_prep_tables(R, Lp: int, nv: int, two: bool):
    """Rank-space lookup tables for the expansion phase.  ``R`` is
    donated: stranded builds never read RF32 (_pe_cvalid skips the
    orientation ranks), so returning RW twice frees R's 4 bytes/position
    — at human scale that is ~2.7 GB of headroom."""
    RW = jnp.where(R == BIG_RANK, KEY_PAD, R.astype(jnp.uint32))
    if two:
        # RF32[i] = R[seqlength - rl - i]: a flip of the valid prefix
        # (instead of an Lp-wide random gather from R)
        RF32 = jnp.concatenate(
            [jnp.flip(R[:nv]), jnp.full(Lp - nv, BIG_RANK, jnp.int32)])
    else:
        # stranded kernels never read RF32 (statically gated); a token
        # array keeps the call signature uniform at zero memory cost
        RF32 = jnp.zeros(8, jnp.int32)
    return RW, RF32


@functools.partial(jax.jit, static_argnames=("n",), donate_argnums=(0,))
def _shrink(a, n: int):
    return jax.lax.slice(a, (0,), (n,))


def _resize_table(a, n: int, fill):
    """Slice or pad a position-indexed table to n rows.  Stranded
    fast-path PE builds confine every read to the fw half plus the slab
    margin, so the four [Lp] tables (R/RW, DD, T32, NS) halve — ~5.4 GB
    back at human scale."""
    if a.shape[0] == n:
        return a
    if a.shape[0] > n:
        return _shrink(a, n)
    return jnp.concatenate([a, jnp.full(n - a.shape[0], fill, a.dtype)])


@functools.partial(jax.jit, static_argnames=("MV",), donate_argnums=(0, 1))
def _pe_prep_ext(spos, rank, MV: int):
    """Padded (position, rank) streams the expansion chunks slice."""
    m1pos_ext = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), spos.astype(jnp.int32),
         jnp.zeros(MV + 1, jnp.int32)])
    m1rank_ext = jnp.concatenate(
        [jnp.full(1, -1, jnp.int32), rank,
         jnp.full(MV + 1, BIG_RANK, jnp.int32)])
    return m1pos_ext, m1rank_ext


def _finalize_host(tx: Transcriptome, state, caps, nfl: int,
                   readlength_hdr: int, fl_min: int, fl_max: int,
                   drained=None, drained_tab=None) -> RshIndex:
    """Fetch the aggregated device results and assemble the RshIndex.

    ``drained``: exemplar-member (sg, tid, chunk) batches already pulled
    off the device mid-build by partitioned builds.  ``drained_tab``:
    folded unique-record batches drained past TABCAP/2 (builds whose
    unique (signature, fraglen) rows exceed any fixed table — the human
    F1-400 build holds ~76 M); counts merge associatively here."""
    # sort only a prefix covering the live rows (appends are contiguous
    # from 0) — sorting the whole capacity buffer wastes 10-30x
    profile = bool(os.environ.get("EMSAR_DEVBUILD_PROFILE"))
    import time as _time
    t0 = _time.perf_counter()
    tab_n = int(np.asarray(state["tab_n"]))
    K = min(_next_pow2(max(tab_n, 1024)), state["tab_h1"].shape[0])
    uh1, uh2, uh3fl, ucnt, n_unique = _tab_finalize(
        state["tab_h1"][:K], state["tab_h2"][:K],
        state["tab_h3fl"][:K], state["tab_cnt"][:K],
        UCAP=min(caps["UCAP"], K))
    if profile:
        jax.block_until_ready(ucnt)
        print(f"[profile] finalize: tab_n={tab_n} K={K} "
              f"aggregate {_time.perf_counter() - t0:.2f}s", flush=True)
        t0 = _time.perf_counter()
    flags = np.asarray(state["flags"])
    if flags.any():
        raise DeviceBuildOverflow(f"device buffer overflow (flags={flags})")
    rows = int(np.asarray(n_unique))
    if rows > min(caps["UCAP"], K):
        raise DeviceBuildOverflow(
            f"unique (signature, fraglen) rows {rows} > UCAP {caps['UCAP']}")

    def fetch(dev, n):
        # transfer only a pow2-sized prefix of the device buffer
        k = min(_next_pow2(max(n, 1)), dev.shape[0])
        return np.asarray(dev[:k])[:n]

    uh1 = fetch(uh1, rows)
    uh2 = fetch(uh2, rows)
    uh3fl = fetch(uh3fl, rows)
    ucnt = fetch(ucnt, rows)
    if "sig_dir" in state:
        # expand the signature-keyed dense accumulator into (sig, fl)
        # unique rows and merge them like a drained batch (each run was
        # recorded in exactly one of: dense table, append table)
        sig_n = int(np.asarray(state["sig_n"]))
        if profile:
            st4 = np.asarray(state["sig_stats"])
            print(f"[profile] finalize: sig routing rec={st4[0]} "
                  f"hit={st4[1]} ins={st4[2]} rem={st4[3]}", flush=True)
        if sig_n:
            SIGROWS = state["sig_dense"].shape[0] // nfl
            ids = fetch(_sig_rows_by_index(state["sig_dir"],
                                           SIGROWS=SIGROWS), sig_n)
            cells = fetch(state["sig_dense"], sig_n * nfl
                          ).reshape(sig_n, nfl)
            if profile:
                print(f"[profile] finalize: sig rows={sig_n} "
                      f"fetch {_time.perf_counter() - t0:.2f}s",
                      flush=True)
                t0 = _time.perf_counter()
            ri, fi = np.nonzero(cells)
            drained_tab = list(drained_tab or [])
            drained_tab.append((
                ids[ri, 0], ids[ri, 1],
                ids[ri, 2] | fi.astype(np.uint32),
                cells[ri, fi]))
    if drained_tab:
        # merge the mid-build drained unique-row batches: same 87-bit
        # identity + fraglen -> counts add (each run was recorded in
        # exactly one batch)
        uh1 = np.concatenate([b[0] for b in drained_tab] + [uh1])
        uh2 = np.concatenate([b[1] for b in drained_tab] + [uh2])
        uh3fl = np.concatenate([b[2] for b in drained_tab] + [uh3fl])
        ucnt = np.concatenate([b[3] for b in drained_tab] + [ucnt])
        key_hi = (uh1.astype(np.uint64) << np.uint64(32)) | uh2
        order_t = np.lexsort((uh3fl, key_hi))
        kh, k3 = key_hi[order_t], uh3fl[order_t]
        newu = np.concatenate([[True], (kh[1:] != kh[:-1]) |
                               (k3[1:] != k3[:-1])])
        starts_u = np.flatnonzero(newu)
        ucnt = np.add.reduceat(
            ucnt[order_t].astype(np.uint64), starts_u).astype(np.uint32)
        uh1 = uh1[order_t][starts_u]
        uh2 = uh2[order_t][starts_u]
        uh3fl = uh3fl[order_t][starts_u]
        rows = len(starts_u)
    mem_n = int(np.asarray(state["mem_n"]))
    mem_sg = fetch(state["mem_sg"], mem_n)
    mem_tid = fetch(state["mem_tid"], mem_n)
    mem_chunk = fetch(state["mem_chunk"], mem_n)
    if drained:
        mem_sg = np.concatenate([c[0] for c in drained] + [mem_sg])
        mem_tid = np.concatenate([c[1] for c in drained] + [mem_tid])
        mem_chunk = np.concatenate([c[2] for c in drained] + [mem_chunk])
        mem_n = len(mem_sg)
    dense = np.asarray(state["dense"]).reshape(tx.n_transcripts, nfl)
    if profile:
        print(f"[profile] finalize: rows={rows} mem_n={mem_n} "
              f"fetch {_time.perf_counter() - t0:.2f}s", flush=True)
        t0 = _time.perf_counter()

    # resolve exemplar multisets (vectorized: member rows grouped by their
    # claiming run id, per-group multiset-hash recomputed on host).  A
    # run id may repeat across chunks when the builder partitions; the
    # (chunk, run) pair is then the group key.
    if mem_n:
        order = np.lexsort((mem_tid, mem_sg, mem_chunk))
        sg_s = mem_sg[order]
        ck_s = mem_chunk[order]
        newgrp = np.concatenate([[True], (sg_s[1:] != sg_s[:-1]) |
                                 (ck_s[1:] != ck_s[:-1])])
        tid_s = mem_tid[order].astype(np.int32)  # sorted within each group
        starts = np.flatnonzero(newgrp)
        g_sizes = np.diff(np.append(starts, mem_n))
        lanes = sig_lanes_np(tid_s).astype(np.uint64)
        gl = np.add.reduceat(lanes, starts, axis=0) & np.uint64(0xFFFFFFFF)
        ex_keys = np.stack([gl[:, 0], gl[:, 1],
                            gl[:, 2] & np.uint64(0xFFFFFE00)],
                           axis=1).astype(np.uint32)
    else:
        starts = np.zeros(0, dtype=np.int64)
        g_sizes = np.zeros(0, dtype=np.int64)
        tid_s = np.empty(0, dtype=np.int32)
        ex_keys = np.zeros((0, 3), dtype=np.uint32)
    G = len(starts)

    # rows -> exemplar groups via one unique() over the stacked 87-bit keys
    fl_ind = (uh3fl & np.uint32(0x1FF)).astype(np.int64)
    k3 = uh3fl & np.uint32(0xFFFFFE00)
    row_keys = np.stack([uh1, uh2, k3], axis=1).astype(np.uint32)
    # unique over the stacked 87-bit keys via packed radix argsorts —
    # np.unique(axis=0) falls back to void-record comparison sorting,
    # minutes at the human F1-400 scale (76 M rows) on this 2-core host
    allk = np.concatenate([ex_keys, row_keys])
    hi = (allk[:, 0].astype(np.uint64) << np.uint64(32)) | allk[:, 1]
    lo = allk[:, 2]
    o1 = np.argsort(lo, kind="stable")
    order_k = o1[np.argsort(hi[o1], kind="stable")]
    sh, sl2 = hi[order_k], lo[order_k]
    newk = np.concatenate([[True], (sh[1:] != sh[:-1])
                           | (sl2[1:] != sl2[:-1])]) if len(allk) \
        else np.zeros(0, dtype=bool)
    uid_sorted = np.cumsum(newk) - 1
    inv = np.empty(len(allk), dtype=np.int64)
    inv[order_k] = uid_sorted
    n_uniq = int(uid_sorted[-1]) + 1 if len(allk) else 0
    ex_uid, row_uid = inv[:G], inv[G:]
    group_of_uid = np.full(n_uniq, -1, dtype=np.int64)
    # last writer wins; duplicates are verified identical below
    group_of_uid[ex_uid] = np.arange(G)
    # exemplar hash collision check: two groups sharing a key must have
    # identical content (otherwise a ~2^-44 multiset-hash alias — abort to
    # the fallback backend rather than merging EUMA rows silently).
    # Claim-table steals across launches make same-signature duplicate
    # groups COMMON at scale (G can be several times n_sig), so the check
    # compares adjacent same-key groups fully vectorized (equality is
    # transitive along the sorted order).
    order2 = np.argsort(ex_uid, kind="stable")
    u_srt = ex_uid[order2]
    adj = u_srt[1:] == u_srt[:-1]
    pa = order2[:-1][adj]
    pb = order2[1:][adj]
    if len(pa):
        if (g_sizes[pa] != g_sizes[pb]).any():
            raise DeviceBuildOverflow(
                "multiset hash collision between exemplars")
        sz = g_sizes[pa]
        tot = int(sz.sum())
        k = np.arange(tot) - np.repeat(np.cumsum(sz) - sz, sz)
        ta = tid_s[np.repeat(starts[pa], sz) + k]
        tb = tid_s[np.repeat(starts[pb], sz) + k]
        if (ta != tb).any():
            raise DeviceBuildOverflow(
                "multiset hash collision between exemplars")

    row_grp = group_of_uid[row_uid]
    if (row_grp < 0).any():
        raise DeviceBuildOverflow(
            "unresolved signature (claim-table collision)")

    # compact to the signatures that actually occur in rows
    used_grp, row_sig = np.unique(row_grp, return_inverse=True)
    n_sig = len(used_grp)
    sizes_u = g_sizes[used_grp]
    euma = np.zeros((n_sig, nfl), dtype=np.int64)
    np.add.at(euma, (row_sig, fl_ind), ucnt.astype(np.int64))

    # canonical (size, tid tuple) order (reference print_rsh row order):
    # padded-matrix lexsort, vectorized like SignatureAccumulator.finalize
    if n_sig:
        max_sz = int(sizes_u.max())
        padded = np.full((n_sig, max_sz), np.iinfo(np.int32).max,
                         dtype=np.int32)
        rep = np.repeat(np.arange(n_sig), sizes_u)
        pos = (np.arange(int(sizes_u.sum()))
               - np.repeat(np.cumsum(sizes_u) - sizes_u, sizes_u))
        take = np.repeat(starts[used_grp], sizes_u) + pos
        padded[rep, pos] = tid_s[take]
        keys = [padded[:, c] for c in range(max_sz - 1, -1, -1)] + [sizes_u]
        canon = np.lexsort(tuple(keys))
        euma = euma[canon]
        sizes = sizes_u[canon].astype(np.int64)
        sig_offsets = np.zeros(n_sig + 1, dtype=np.int64)
        np.cumsum(sizes, out=sig_offsets[1:])
        pos_out = (np.arange(int(sig_offsets[-1]))
                   - np.repeat(sig_offsets[:-1], sizes))
        take = np.repeat(starts[used_grp[canon]], sizes) + pos_out
        sig_tids = tid_s[take]
    else:
        sig_offsets = np.zeros(1, dtype=np.int64)
        sig_tids = np.empty(0, dtype=np.int32)

    if profile:
        print(f"[profile] finalize: G={G} n_sig={n_sig} "
              f"resolve {_time.perf_counter() - t0:.2f}s", flush=True)
    return RshIndex(names=list(tx.names), readlength=readlength_hdr,
                    min_fraglength=fl_min, max_fraglength=fl_max,
                    single_euma=dense.astype(np.int64),
                    sig_offsets=sig_offsets,
                    sig_tids=sig_tids.astype(np.int32),
                    multi_euma=euma)


@functools.partial(jax.jit, static_argnames=("Bcap", "Lp", "with_dd"),
                   donate_argnums=(0, 1, 2, 3, 4, 5))
def _pe_bucket_rank(R, DD, SPo, RKo, base, maxcl, S1, S2, S3, SSP, cnt_b,
                    off_b, Bcap: int, Lp: int, with_dd: bool = False):
    """Assign global ranks to one sorted bucket and write (position,
    rank) into the bucket-major output arrays plus R[pos] = rank.

    ``base`` is the running rank offset (device scalar, threaded through
    launches — no per-bucket host sync); returns the advanced base and
    the running max cluster size.  Equal windows never cross buckets
    (they share all hash lanes), so the per-bucket neighbor-distance
    pack (``with_dd``) is exact."""
    j = jnp.arange(Bcap, dtype=jnp.int32)
    valid = j < cnt_b
    diff = (S1[1:] != S1[:-1]) | (S2[1:] != S2[:-1]) | (S3[1:] != S3[:-1])
    start = jnp.concatenate([jnp.ones(1, bool), diff]) & valid
    rankloc = jnp.cumsum(start.astype(jnp.int32)) - 1
    nd = jnp.max(jnp.where(valid, rankloc + 1, 0))
    rank = jnp.where(valid, base + rankloc, BIG_RANK)
    _, ns = _run_bounds(start)
    sizes = jnp.minimum(ns, cnt_b) - j
    maxcl = jnp.maximum(maxcl, jnp.max(jnp.where(start, sizes, 0)))
    R = R.at[jnp.where(valid, SSP, Lp)].set(rank, mode="drop",
                                            unique_indices=True)
    if with_dd:
        DD = DD.at[jnp.where(valid, SSP, Lp)].set(
            _dd_pack(SSP, start | ~valid, valid), mode="drop",
            unique_indices=True)
    # block writes: bucket b+1's block starts at off_b + cnt_b, so its
    # write overwrites this block's garbage tail; the last bucket's tail
    # lies beyond n_valid and is never read
    SPo = jax.lax.dynamic_update_slice(SPo, SSP, (off_b,))
    RKo = jax.lax.dynamic_update_slice(RKo, rank, (off_b,))
    return R, DD, SPo, RKo, base + nd, maxcl


def _pe_rank_hashsort(tx, ref: DeviceRef, rl: int, two: bool, cfg,
                      with_dd: bool = False):
    """Rank pass: contiguous hash slabs over both strand halves, then
    group every distinct mate1 window — one global 4-operand sort within
    the sort budget, or a hash-prefix radix partition with per-bucket
    sorts beyond it (human-scale transcriptomes; equal windows share all
    hash lanes, so clusters never cross buckets and bucket-major rank
    assignment composes exactly).  Replaces the reference's mate1 suffix
    sort + mark_sfa_se (src/emsar_functions.c:1108-1149, 1300-1306):
    rank == cluster id, and any total order over distinct windows serves
    the downstream orientation rules (module docstring).
    Returns (spos, rank, max_cluster, n_valid, R, DD); DD (``with_dd``)
    is the packed same-window neighbor-distance table consumed by the
    fast singleton pass (token array otherwise)."""
    seqlength = int(tx.seqlength)
    n_fw = int(tx.borderpos) - rl + 1
    # slab <= pad(n_fw) keeps every rc flipped slice in bounds
    # (pad_to(n_fw, slab) <= 2*n_fw <= seqlength - rl + 1); the env
    # override lets tests exercise the multi-slab path at small scale
    slab = min(_next_pow2(n_fw),
               int(os.environ.get("EMSAR_PE_SLAB", 1 << 25)))
    hpad = _pad_to(n_fw, slab)
    halves = [False] + ([True] if two else [])
    Npad = hpad * len(halves)
    H1 = jnp.full(Npad, CLAIM_EMPTY, jnp.uint32)
    H2 = jnp.full(Npad, CLAIM_EMPTY, jnp.uint32)
    H3 = jnp.full(Npad, CLAIM_EMPTY, jnp.uint32)
    PS = jnp.full(Npad, -1, jnp.int32)
    nv_dev = []
    with phase("PE dev: rank hash pass", cfg.verbose):
        out0 = 0
        for rc in halves:
            for s0 in range(0, hpad, slab):
                H1, H2, H3, PS, c = _pe_hash_slab(
                    H1, H2, H3, PS, ref._packed, ref._badbits,
                    jnp.int32(s0), jnp.int32(out0 + s0), jnp.int32(n_fw),
                    jnp.int32(seqlength), slab=slab, rc_half=rc,
                    readlength=rl)
                nv_dev.append(c)
            out0 += hpad
        n_valid = int(np.asarray(jnp.stack(nv_dev)).sum())
    ref.release_seq()  # the expansion phase only needs rank-space tables

    limit = min(getattr(cfg, "device_sort_limit", 1 << 28), 1 << 26)
    if Npad <= limit:
        with phase(f"PE dev: rank sort ({Npad} rows)", cfg.verbose):
            S1, S2, S3, SP = _sort_payload4(H1, H2, H3, PS,
                                            num_keys=4 if with_dd else 3)
            del H1, H2, H3, PS
            _psync(SP)
        with phase("PE dev: rank finish", cfg.verbose):
            R, rank, maxcl, _, DD = _pe_rank_finish(S1, S2, S3, SP,
                                                    jnp.int32(n_valid),
                                                    Lp=ref.Lp,
                                                    with_dd=with_dd)
            del S1, S2, S3
            maxcl_i = int(np.asarray(maxcl))
        return SP, rank, maxcl_i, n_valid, R, DD

    # ---- partitioned rank pass (beyond the single-sort budget) ----
    kbits = 1
    while (Npad >> kbits) > limit and kbits < 6:
        kbits += 1
    while True:
        B = 1 << kbits
        with phase(f"PE dev: rank radix pass ({B} buckets)", cfg.verbose):
            RANK = jnp.zeros(Npad, jnp.int32)
            cnt_dev = []
            for b in range(B):
                RANK, c = _radix_rank_step(RANK, H1, PS, jnp.int32(b),
                                           kbits=kbits)
                cnt_dev.append(c)
            counts = np.asarray(jnp.stack(cnt_dev))
        maxb = int(counts.max()) if B else 0
        if maxb <= limit or kbits >= 6:
            break
        kbits += 1
        del RANK
    if maxb > limit:
        raise DeviceBuildUnsupported(
            f"rank bucket of {maxb} windows exceeds the sort budget")
    p2 = _next_pow2(max(maxb, 1 << 16))
    Bcap = p2 if maxb > 3 * p2 // 4 else 3 * p2 // 4
    out_size = Npad + Bcap
    off = np.zeros(B, np.int32)
    np.cumsum(counts[:B - 1], out=off[1:])
    with phase("PE dev: rank radix partition", cfg.verbose):
        dst = _radix_dst(H1, PS, RANK, jnp.asarray(off), kbits=kbits,
                         out_size=out_size)
        del RANK
        P1 = _scatter_one(H1, dst, out_size=out_size)
        del H1
        P2 = _scatter_one(H2, dst, out_size=out_size)
        del H2
        P3 = _scatter_one(H3, dst, out_size=out_size)
        del H3
        PP = _scatter_one(PS, dst, out_size=out_size)
        del PS, dst
        _psync(PP)
    with phase(f"PE dev: rank {B} bucket sorts (cap {Bcap})", cfg.verbose):
        R = jnp.full(ref.Lp, BIG_RANK, jnp.int32)
        # DD builds AFTER the loop from (SPo, RKo): allocating the [Lp]
        # table while the partition copies are live raises the peak
        DD = jnp.zeros(8, jnp.uint32)
        SPo = jnp.full(out_size, -1, jnp.int32)
        RKo = jnp.full(out_size, BIG_RANK, jnp.int32)
        base = jnp.zeros((), jnp.int32)
        maxcl = jnp.zeros((), jnp.int32)
        for b in range(B):
            if counts[b] == 0:
                continue
            S1, S2, S3, SSP, _, _ = _se_bucket_sort(
                P1, P2, P3, PP, jnp.int32(int(off[b])),
                jnp.int32(int(counts[b])), Bcap=Bcap, max_repeat=2,
                num_keys=4 if with_dd else 3)
            R, DD, SPo, RKo, base, maxcl = _pe_bucket_rank(
                R, DD, SPo, RKo, base, maxcl, S1, S2, S3, SSP,
                jnp.int32(int(counts[b])), jnp.int32(int(off[b])),
                Bcap=Bcap, Lp=ref.Lp, with_dd=False)
            del S1, S2, S3, SSP
        del P1, P2, P3, PP
        maxcl_i = int(np.asarray(maxcl))
    if with_dd:
        # the bucket-major stream is rank-grouped with positions
        # ascending within each rank run (position is the 4th sort key),
        # so the neighbor-distance table derives in one pass now that
        # the partition copies are freed
        with phase("PE dev: neighbor distances", cfg.verbose):
            DD = _dd_from_stream(SPo, RKo, Lp=ref.Lp)
    return SPo, RKo, maxcl_i, n_valid, R, DD


@functools.partial(jax.jit, static_argnames=("Lpx", "nv", "two"),
                   donate_argnums=())
def _pe_global_tables(R, T32, NS, Lpx: int, nv: int, two: bool):
    """Sentinel-extended position tables for the delta-shift stream: every
    slice R[d0+dd : d0+dd+Np] must stay in bounds (a clamped
    dynamic_slice would silently alias positions)."""
    def ext(tab, fill):
        return jnp.concatenate(
            [tab, jnp.full(Lpx - tab.shape[0], fill, tab.dtype)])

    Rx = ext(R, BIG_RANK)
    if two:
        RFx = ext(jnp.concatenate(
            [jnp.flip(R[:nv]),
             jnp.full(R.shape[0] - nv, BIG_RANK, jnp.int32)]), BIG_RANK)
    else:
        RFx = Rx
    return Rx, RFx, ext(T32, 0), ext(NS, 0)


def _build_pe_global(tx: Transcriptome, ref: DeviceRef, R, rl: int,
                     fl_min: int, fl_max: int, two: bool,
                     cfg: BuildConfig) -> RshIndex:
    """Delta-shift global PE pipeline (see the section comment above
    _pe_stream_gen): slice-generated candidate keys, one global sort,
    SE-style chunked accumulation."""
    nfl = fl_max - fl_min + 1
    d0 = fl_min - rl
    seqlength = int(tx.seqlength)
    borderpos = int(tx.borderpos)
    n1 = (seqlength if two else borderpos) - rl + 1
    Np = _pad_to(n1, 256)
    Lpx = _pad_to(max(Np + d0 + nfl + 8, ref.Lp), 256)
    E = Np * nfl
    profile = bool(os.environ.get("EMSAR_DEVBUILD_PROFILE"))

    with phase("PE dev: stream gen", cfg.verbose):
        T32 = ref.t32(rl)
        Rx, RFx, T32x, NSx = _pe_global_tables(
            R, T32, ref.nsep, Lpx=Lpx, nv=seqlength - rl + 1, two=two)
        del R, T32
        A, B, P = _pe_stream_gen(Rx, RFx, T32x, NSx, jnp.int32(d0),
                                 Np=Np, nfl=nfl, unstranded=two,
                                 borderpos=borderpos, seqlength=seqlength,
                                 readlength=rl)
        del Rx, RFx, T32x, NSx
        _psync(P)
    with phase(f"PE dev: stream sort ({E} rows)", cfg.verbose):
        A, B, P = _sort_payload3(A, B, P)
        _psync(P)

    caps = _caps_partitioned(E, nfl=nfl)
    state = _init_state(tx.n_transcripts, nfl, caps)
    drained: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    drained_tab: List[tuple] = []
    V = _next_pow2(max(int(cfg.max_repeat) + 2, 64))
    Q = min(_next_pow2(E), 1 << 24)
    n_chunks = max(-(-E // Q), 1)
    with phase(f"PE dev: stream accumulate ({n_chunks} chunks)",
               cfg.verbose):
        A = _pad_sorted(A, KEY_PAD, tail=Q + V)
        B = _pad_sorted(B, KEY_PAD, tail=Q + V)
        P = _pad_sorted(P, jnp.uint32(0), tail=Q + V)
        rc_dev, nv_dev = _pe_stream_stats(A, B, E=E, Q=Q,
                                          n_chunks=n_chunks,
                                          max_repeat=int(cfg.max_repeat))
        rc_all = np.asarray(rc_dev)
        n_valid = int(np.asarray(nv_dev))
        import time as _time
        for k in range(n_chunks):
            if k * Q >= n_valid:
                break  # invalid rows sort last; all-pad chunks are inert
            if profile:
                t0 = _time.perf_counter()
            rc_i = int(rc_all[k])
            Uk = min(max(_next_pow2(rc_i + 64), 1 << 12), Q + V + 1,
                     caps["TABCAP"] // 4)
            state, *win = _pe_stream_chunk(
                state, A, B, P, jnp.int32(k * Q), jnp.int32(k),
                jnp.int32(_launch_base(k, 1 + Q + V)), Q=Q, V=V, nfl=nfl,
                max_repeat=int(cfg.max_repeat), U=Uk)
            state, drained = _maintain(state, caps, drained,
                                       caps["TABCAP"] // 4, win=win,
                                       tids_sorted=P, src0=k * Q,
                                       chunk_id=k, tid_shift=9,
                                       chunk_base=_launch_base(
                                           k, 1 + Q + V),
                        drained_tab=drained_tab)
            if profile:
                print(f"[profile] stream chunk {k}: "
                      f"{_time.perf_counter() - t0:.3f}s rec={rc_i}",
                      flush=True)
    del A, B, P
    with phase("PE dev: finalize", cfg.verbose):
        return _finalize_host(tx, state, caps, nfl, rl, fl_min, fl_max,
                              drained=drained, drained_tab=drained_tab)


def build_pe_index_device(tx: Transcriptome, readlength: int,
                          cfg: BuildConfig,
                          shard: Optional[Tuple[int, int]] = None
                          ) -> RshIndex:
    """PE rsh index, fully device-resident (see module docstring).

    ``shard=(i, n)``: process-sharded build — this invocation owns every
    n-th expansion chunk and singleton slab (clusters partition across
    chunks, so per-shard EUMA counts are disjoint and RshIndex.merge
    reassembles the exact single-process output).  The multi-host story
    for BASELINE config 4's build half; the reference itself shards
    clusters across threads (src/emsar_functions.c:2839), this shards
    the same axis across processes."""
    rl = int(readlength)
    fl_min = max(cfg.min_fraglength, rl)
    fl_max = max(cfg.max_fraglength, fl_min)
    nfl = fl_max - fl_min + 1
    if nfl >= MAX_NFL_PACKED:
        raise DeviceBuildUnsupported(f"nFraglen {nfl} >= {MAX_NFL_PACKED}")
    if rl > 1024:
        raise DeviceBuildUnsupported("readlength > 1024")
    if tx.n_transcripts >= 1 << 23:
        # (tid, d) pack into one uint32 sort payload in _pe_expand_sort
        raise DeviceBuildUnsupported("n_transcripts >= 2^23")
    stranded = cfg.strand.stranded
    n_fw = int(tx.borderpos) - rl + 1
    if n_fw <= 0:
        raise DeviceBuildUnsupported("read length exceeds transcriptome")
    two = not stranded
    Npos = n_fw * (2 if two else 1)

    n1 = (int(tx.seqlength) if two else int(tx.borderpos)) - rl + 1
    shard_i, shard_n = shard if shard is not None else (0, 1)
    # sharded builds always take the chunked path (the global pipeline
    # has no chunk axis to partition)
    use_global = (shard is None
                  and _pad_to(n1, 256) * nfl <= PE_GLOBAL_BUDGET)
    # fast singleton path (slab slices + neighbor distances): stranded
    # chunked builds only — the unstranded orientation rule masks
    # candidates per (mate1, mate2) pair, which a per-position
    # neighbor-distance table cannot express (see _pe_single_slabs)
    fast_singles = (not two and not use_global
                    and os.environ.get("EMSAR_PE_FAST_SINGLES", "1") != "0")

    with phase("PE dev: reference upload", cfg.verbose):
        ref = DeviceRef(tx)
    spos, rank, maxcl_i, nvalid_i, R, DD = _pe_rank_hashsort(
        tx, ref, rl, two, cfg, with_dd=fast_singles)

    if use_global:
        del spos, rank, DD
        return _build_pe_global(tx, ref, R, rl, fl_min, fl_max, two, cfg)

    with phase("PE dev: cluster partition", cfg.verbose):
        if fast_singles:
            ns_d, nm_d = _pe_cluster_counts(spos, rank, jnp.int32(nvalid_i))
            ns_i, nm_i = int(np.asarray(ns_d)), int(np.asarray(nm_d))
            # halve R/DD BEFORE the compaction: its [N]-scale temporaries
            # sit next to two full [Lp] tables
            S = min(1 << 17 if nfl < 128 else 1 << 16,
                    _next_pow2(max(n1, 1024)))
            LpE = _quantize_size(_pad_to(n1, S) + S + (fl_max - rl) + 64)
            R = _resize_table(R, LpE, BIG_RANK)
            DD = _resize_table(DD, LpE, jnp.uint32(0))
            _psync(R)
            nm_cap = min(_quantize_size(nm_i + 256), spos.shape[0])
            SPm, RKm = _pe_compact_multi(spos, rank, jnp.int32(nvalid_i),
                                         N_out=nm_cap)
            _psync(SPm)
            SPs = RKs = None
        else:
            SPs, RKs, SPm, RKm, ns_d, nm_d = _pe_partition_clusters(
                spos, rank, jnp.int32(nvalid_i))
            ns_i, nm_i = int(np.asarray(ns_d)), int(np.asarray(nm_d))
            # the compacted streams live in full-size buffers; shrink to
            # the occupied prefix (rows beyond are already sentinels) —
            # at human scale the four full buffers alone are ~6.8 GB
            N_full = SPm.shape[0]
            ns_cap = min(_quantize_size(ns_i + 256), N_full)
            nm_cap = min(_quantize_size(nm_i + 256), N_full)
            if ns_cap < N_full:
                SPs = _shrink(SPs, ns_cap)
                RKs = _shrink(RKs, ns_cap)
            if nm_cap < N_full:
                SPm = _shrink(SPm, nm_cap)
                RKm = _shrink(RKm, nm_cap)

    V = _next_pow2(max(maxcl_i + 1, 8))
    if V * nfl * 2 > max(int(cfg.pe_chunk_candidates), 4 * nfl):
        raise DeviceBuildUnsupported(
            f"mate1 cluster of {maxcl_i} members needs a larger chunk "
            f"budget than pe_chunk_candidates={cfg.pe_chunk_candidates}")
    # chunk budget scales down to the problem so tiny builds stay tiny
    e_target = max(min(int(cfg.pe_chunk_candidates),
                       _next_pow2(max(nm_i, 1) * nfl)),
                   2 * V * nfl, 4 * nfl)
    MV = max(2 * V, e_target // nfl)
    M = MV - V
    E = MV * nfl
    n_chunks = (nm_i + M - 1) // M

    with phase("PE dev: prep", cfg.verbose):
        # R is donated away here (stranded builds drop it entirely);
        # m1*_ext are built only after the singleton pass frees SPs/RKs
        # — ordering that keeps human-scale peak device memory in budget
        if fast_singles:
            # R/DD were already halved before the compaction; T32 and NS
            # generate DIRECTLY at LpE — the full-[Lp] t32/nsep kernels
            # would add 2.7 GB output + flip intermediates each
            tidf = _tid_forward(ref.cuml, size=_pad_to(n1 + 2, 256))
            T32 = _t32_fw(tidf, LpE=LpE, n1=n1)
            del tidf
            _psync(T32)
            NS = _nsep_kernel(jnp.asarray(ref._seppos_host), LpE)
            _psync(NS)
        else:
            T32 = ref.t32(rl)
            NS = ref.nsep
        Lp_k = LpE if fast_singles else ref.Lp
        RW, RF32 = _pe_prep_tables(R, Lp=Lp_k,
                                   nv=int(tx.seqlength) - rl + 1, two=two)
        del R
        # partitioned-scale capacities: the record table folds in place
        # and members drain to host, so human-scale cluster-path builds
        # (record totals far beyond any fixed table) stay in budget
        caps = _caps_partitioned(Npos * nfl, nfl=nfl)

    import os as _os
    profile = bool(_os.environ.get("EMSAR_DEVBUILD_PROFILE"))
    drained: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    drained_tab: List[tuple] = []
    d0 = fl_min - rl

    # singleton-cluster pass: the (usually large) majority of mate1
    # positions resolve without the global candidate sort
    dense_s = jnp.zeros(tx.n_transcripts * nfl, jnp.int32)
    if fast_singles:
        nblk_glob = (n1 + S - 1) // S
        nblk = len(range(shard_i, nblk_glob, shard_n))
        assert nblk_glob * S + d0 + nfl + 8 <= LpE
        with phase(f"PE dev: singleton slab pass ({ns_i} pos, "
                   f"{nblk} slabs)", cfg.verbose):
            dense_s, sflag = _pe_single_slabs(
                dense_s, DD, T32, NS, jnp.int32(d0),
                S=S, nblk=nblk, nfl=nfl, K=1 << 13,
                seqlength=int(tx.seqlength), readlength=rl,
                ntid=tx.n_transcripts, shard_i=shard_i, shard_n=shard_n)
            if bool(np.asarray(sflag)):
                raise DeviceBuildOverflow(
                    "singleton slab tid-run capacity exceeded")
            del DD
    else:
        del DD
        Ss = MV
        n_schunks = (ns_i + Ss - 1) // Ss
        with phase(f"PE dev: singleton pass ({ns_i} pos, "
                   f"{n_schunks} chunks)", cfg.verbose):
            if n_schunks:
                # slice pad so the last chunk never clamps back over
                # earlier rows (which would double-count them)
                SPs = jnp.concatenate([SPs, jnp.full(Ss, -1, jnp.int32)])
                RKs = jnp.concatenate(
                    [RKs, jnp.full(Ss, BIG_RANK, jnp.int32)])
            for k in range(shard_i, n_schunks, shard_n):
                dense_s = _pe_single_chunk(
                    dense_s, SPs, RKs, RW, RF32, T32, NS,
                    jnp.int32(k * Ss), jnp.int32(d0), Ss=Ss, nfl=nfl,
                    unstranded=two, borderpos=int(tx.borderpos),
                    seqlength=int(tx.seqlength), readlength=rl, Lp=Lp_k)
            del SPs, RKs
            _psync(dense_s)

    with phase("PE dev: ext prep", cfg.verbose):
        m1pos_ext, m1rank_ext = _pe_prep_ext(SPm, RKm, MV=MV)
        del SPm, RKm
        state = _init_state(tx.n_transcripts, nfl, caps)

    with phase("PE dev: expansion", cfg.verbose):
        import time as _time

        def expand(k):
            return _pe_expand_sort(
                RW, RF32, T32, NS, m1pos_ext, m1rank_ext,
                jnp.int32(1 + k * M), jnp.int32(d0),
                M=M, V=V, nfl=nfl, max_repeat=int(cfg.max_repeat),
                unstranded=two, borderpos=int(tx.borderpos),
                seqlength=int(tx.seqlength), readlength=rl, Lp=Lp_k)

        # depth-2 software pipeline: chunk k+1's expansion is dispatched
        # before chunk k's probe counters are fetched, so the device keeps
        # working through the host round trip
        ks = list(range(shard_i, n_chunks, shard_n))
        pending = expand(ks[0]) if ks else None
        for ki, k in enumerate(ks):
            if profile:
                t0 = _time.perf_counter()
            nxt = expand(ks[ki + 1]) if ki + 1 < len(ks) else None
            sck, srk, spay, rc_d, me_d = pending
            rc_i, me_i = int(np.asarray(rc_d)), int(np.asarray(me_d))
            # quantized (not pow2) record capacity: U-scale claim and
            # row-gather ops are ~60% of a chunk, and next_pow2 doubled
            # them whenever rec sat just above a power of two
            Uk = min(max(_quantize_size(rc_i + 64), 1 << 12), E,
                     caps["TABCAP"] // 4)
            state, *win = _pe_chunk_accum(
                state, sck, srk, spay, jnp.int32(k),
                jnp.int32(_launch_base(k, E)), nfl=nfl,
                max_repeat=int(cfg.max_repeat), U=Uk)
            del sck, srk
            # fold bound: the next launch appends at most E records
            state, drained = _maintain(state, caps, drained,
                                       min(E, caps["TABCAP"] // 4),
                                       win=win,
                                       tids_sorted=spay, src0=0,
                                       chunk_id=k, tid_shift=9,
                                       chunk_base=_launch_base(k, E),
                        drained_tab=drained_tab)
            del spay
            pending = nxt
            if profile:
                print(f"[profile] chunk {k}: "
                      f"{_time.perf_counter() - t0:.3f}s "
                      f"rec={rc_i} mem={me_i}", flush=True)

    with phase("PE dev: finalize", cfg.verbose):
        state = dict(state)
        state["dense"] = state["dense"] + dense_s  # singleton-pass merge
        return _finalize_host(tx, state, caps, nfl, rl, fl_min, fl_max,
                              drained=drained, drained_tab=drained_tab)


def build_se_index_device(tx: Transcriptome, readlength_min: int,
                          readlength_max: int, cfg: BuildConfig) -> RshIndex:
    """SE rsh index over a read-length range, fully device-resident.

    Per read length: a contiguous hash pass (dynamic slices only — no
    gathers from the HBM-resident code table), then either ONE global
    4-operand sort of the (96-bit identity, tid) payload (builds within
    the sort budget) or a radix partition by hash top bits followed by
    per-bucket sorts (equal windows share all hash lanes, so runs never
    cross buckets and per-bucket accumulation composes exactly — the
    reference's generate_seqtag idea, src/emsar_functions.c:1233-1264,
    with adaptive hash buckets).  Run accumulation streams over the
    sorted rows in overlapping chunks."""
    lmin, lmax = int(readlength_min), int(readlength_max)
    nfl = lmax - lmin + 1
    if nfl >= MAX_NFL_PACKED:
        raise DeviceBuildUnsupported("read-length range too wide")
    if lmax > 1024:
        raise DeviceBuildUnsupported("readlength > 1024")
    n0 = int(tx.borderpos) - lmin + 1
    if n0 <= 0:
        raise DeviceBuildUnsupported("read length exceeds transcriptome")
    limit = getattr(cfg, "device_sort_limit", 1 << 26)

    unstranded = not cfg.strand.stranded
    borderpos, seqlength = int(tx.borderpos), int(tx.seqlength)
    with phase("SE dev: reference upload", cfg.verbose):
        ref = DeviceRef(tx)
    ncand = sum(max(borderpos - l + 1, 0) for l in range(lmin, lmax + 1))
    caps = _caps_partitioned(ncand, nfl=nfl)
    state = _init_state(tx.n_transcripts, nfl, caps)
    drained: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    drained_tab: List[tuple] = []

    chunk_id = 0
    slab = min(_next_pow2(n0), 1 << 25)
    n0pad = _pad_to(n0, slab)
    tidf = _tid_forward(ref.cuml, size=n0pad)
    single_sort = n0pad <= max(limit, 1 << 20)
    V = _next_pow2(max(int(cfg.max_repeat) + 2, 64))
    # rows per single-sort accumulate launch: a launch appends at most
    # Q/2 records (each record is a run of >= 2 rows), and its record
    # block is capped at TABCAP/4, so Q <= TABCAP/2 can never overflow
    # however densely the windows share sequence
    Q = min(_next_pow2(n0pad), 1 << 24, caps["TABCAP"] // 2)
    kbits = 1
    while (n0 >> kbits) > min(limit, 1 << 24) and kbits < 6:
        kbits += 1

    for l in range(lmin, lmax + 1):
        n_l = borderpos - l + 1
        if n_l <= 0:
            continue
        H1 = jnp.zeros(n0pad, jnp.uint32)
        H2 = jnp.zeros(n0pad, jnp.uint32)
        H3 = jnp.zeros(n0pad, jnp.uint32)
        TD = jnp.full(n0pad, -1, jnp.int32)
        nv_dev = []
        with phase(f"SE dev: l{l} hash pass", cfg.verbose):
            for s0 in range(0, n0pad, slab):
                H1, H2, H3, TD, nv = _se_hash_slab(
                    H1, H2, H3, TD, ref._packed, ref._badbits, tidf,
                    jnp.int32(s0), jnp.int32(borderpos),
                    jnp.int32(seqlength), slab=slab,
                    unstranded=unstranded, readlength=l)
                nv_dev.append(nv)
            n_valid = int(np.asarray(jnp.stack(nv_dev)).sum())

        if single_sort:
            with phase(f"SE dev: l{l} sort ({n0pad} rows)", cfg.verbose):
                S1, S2, S3, ST = _sort_payload4(H1, H2, H3, TD)
                del H1, H2, H3, TD
                S1 = _pad_sorted(S1, jnp.uint32(0xFFFFFFFF), tail=Q + V)
                S2 = _pad_sorted(S2, jnp.uint32(0xFFFFFFFF), tail=Q + V)
                S3 = _pad_sorted(S3, jnp.uint32(0xFFFFFFFF), tail=Q + V)
                ST = _pad_sorted(ST, jnp.int32(0), tail=Q + V)
                _psync(ST)
            n_chunks = max(-(-n0pad // Q), 1)
            with phase(f"SE dev: l{l} accumulate ({n_chunks} chunks)",
                       cfg.verbose):
                for k in range(n_chunks):
                    rc_d, me_d = _se_chunk_probe(
                        S1, S2, S3, jnp.int32(k * Q), jnp.int32(n_valid),
                        Q=Q, V=V, max_repeat=int(cfg.max_repeat))
                    rc_i = int(np.asarray(rc_d))
                    Uk = min(max(_next_pow2(rc_i + 64), 1 << 12),
                             Q + V + 1, caps["TABCAP"] // 4)
                    state, *win = _se_sorted_chunk(
                        state, S1, S2, S3, ST, jnp.int32(k * Q),
                        jnp.int32(l - lmin), jnp.int32(chunk_id),
                        jnp.int32(_launch_base(chunk_id, 1 + Q + V)),
                        jnp.int32(n_valid), Q=Q, V=V, nfl=nfl,
                        max_repeat=int(cfg.max_repeat), U=Uk)
                    state, drained = _maintain(
                        state, caps, drained, caps["TABCAP"] // 4,
                        win=win, tids_sorted=ST, src0=k * Q,
                        chunk_id=chunk_id, tid_shift=0,
                        chunk_base=_launch_base(chunk_id, 1 + Q + V),
                        drained_tab=drained_tab)
                    chunk_id += 1
            del S1, S2, S3, ST
            continue
        while True:  # escalation: only giant equal-window runs resist
            B = 1 << kbits
            with phase(f"SE dev: l{l} rank pass ({B} buckets)",
                       cfg.verbose):
                RANK = jnp.zeros(n0pad, jnp.int32)
                cnt_dev = []
                for b in range(B):
                    RANK, c = _radix_rank_step(RANK, H1, TD, jnp.int32(b),
                                               kbits=kbits)
                    cnt_dev.append(c)
                counts = np.asarray(jnp.stack(cnt_dev))
            maxb = int(counts.max()) if B else 0
            if maxb <= limit or kbits >= 6:
                break
            kbits += 1
            del RANK
        # quantize the bucket capacity to {2^k, 3*2^(k-1)}: <= 33% pad
        # waste, and the launch shape stays stable across read lengths
        p2 = _next_pow2(max(maxb, 1 << 16))
        Bcap = p2 if maxb > 3 * p2 // 4 else 3 * p2 // 4
        if maxb > limit:
            raise DeviceBuildUnsupported(
                f"hash bucket of {maxb} windows exceeds the sort budget "
                f"(a single window repeated beyond the budget dominates)")
        out_size = n0pad + Bcap
        with phase(f"SE dev: l{l} radix partition", cfg.verbose):
            off = np.zeros(B, np.int32)
            np.cumsum(counts[:B - 1], out=off[1:])
            dst = _radix_dst(H1, TD, RANK, jnp.asarray(off), kbits=kbits,
                             out_size=out_size)
            del RANK
            # free each source right after its scatter: peak stays ~1
            # payload above steady state (all four at once adds ~4 GB at
            # human scale)
            P1 = _scatter_one(H1, dst, out_size=out_size)
            del H1
            P2 = _scatter_one(H2, dst, out_size=out_size)
            del H2
            P3 = _scatter_one(H3, dst, out_size=out_size)
            del H3
            PT = _scatter_one(TD, dst, out_size=out_size)
            del TD, dst
            _psync(PT)
        with phase(f"SE dev: l{l} {B} buckets (cap {Bcap})", cfg.verbose):
            for b in range(B):
                if counts[b] == 0:
                    continue
                S1, S2, S3, ST, rc_d, me_d = _se_bucket_sort(
                    P1, P2, P3, PT, jnp.int32(int(off[b])),
                    jnp.int32(int(counts[b])), Bcap=Bcap,
                    max_repeat=int(cfg.max_repeat))
                # exact record/member demand, pow2-quantized: the claim
                # and extraction ops run at this scale, and sizing them
                # to the bucket capacity cost ~5x (see _se_bucket_sort)
                rc_i = int(np.asarray(rc_d))
                Ub = min(max(_next_pow2(rc_i + 64), 1 << 12), Bcap,
                         caps["TABCAP"] // 4)
                state, *win = _se_bucket_accum(
                    state, S1, S2, S3, ST, jnp.int32(int(counts[b])),
                    jnp.int32(l - lmin), jnp.int32(chunk_id),
                    jnp.int32(_launch_base(chunk_id, Bcap)), Bcap=Bcap,
                    nfl=nfl, max_repeat=int(cfg.max_repeat), U=Ub)
                del S1, S2, S3
                state, drained = _maintain(
                    state, caps, drained, caps["TABCAP"] // 4,
                    win=win, tids_sorted=ST, src0=0, chunk_id=chunk_id,
                    tid_shift=0,
                    chunk_base=_launch_base(chunk_id, Bcap),
                        drained_tab=drained_tab)
                del ST
                chunk_id += 1
        del P1, P2, P3, PT

    with phase("SE dev: finalize", cfg.verbose):
        return _finalize_host(tx, state, caps, nfl, -1, lmin, lmax,
                              drained=drained, drained_tab=drained_tab)


def _maintain(state, caps, drained, U, win=None, tids_sorted=None,
              src0=0, chunk_id=0, tid_shift=0, chunk_base=0,
              drained_tab=None):
    """Per-launch maintenance (one small sync): dispatch winner-member
    extraction, abort on overflow flags, fold the record table when the
    next launch might not fit, drain exemplar members to the host past
    half capacity.

    ``win``: the (win_sg, win_start, win_cnt, n_win, wmem) tuple from
    :func:`_postsort_accumulate`; extraction only launches when winners
    exist (the common no-new-signature launch costs nothing beyond the
    scalar fetch, which this sync already pays).

    ``U`` must bound the NEXT launch's record demand, which is unknown
    under demand sizing — callers pass the worst case (TABCAP/4), so the
    fold triggers whenever tab_n passes TABCAP/2."""
    if win is not None:
        win_row, rsg, rpk, n_win_d, wmem_d = win
        scal = np.array(jnp.stack(
            [state["mem_n"], state["tab_n"], state["flags"][0],
             state["flags"][1], n_win_d, wmem_d]))
        if scal[4] > 0:
            wmem = int(scal[5])
            W = _next_pow2(max(wmem, 256))
            if W > caps["MEMCAP"]:
                raise DeviceBuildOverflow(
                    f"winner member demand {wmem} > MEMCAP")
            # slice the compacted winner rows to a small pow2 so the
            # extraction's id/count gathers run at winner scale
            Uwn = min(_next_pow2(max(int(scal[4]), 256)),
                      win_row.shape[0])
            state = _extract_members(
                state, _shrink(win_row, Uwn), rsg, rpk,
                jnp.int32(int(scal[4])), tids_sorted,
                jnp.int32(src0), jnp.int32(chunk_id),
                jnp.int32(chunk_base), W=W, tid_shift=tid_shift)
            scal[0] += wmem
    else:
        scal = np.asarray(jnp.stack([state["mem_n"], state["tab_n"],
                                     state["flags"][0], state["flags"][1]]))
    if scal[2] or scal[3]:
        raise DeviceBuildOverflow(
            f"device buffer overflow (tab={bool(scal[2])}, "
            f"mem={bool(scal[3])})")
    if int(scal[1]) + U > caps["TABCAP"] - U:
        K = min(_next_pow2(max(int(scal[1]), 1024)), caps["TABCAP"])
        state = _tab_fold(state, K=K)
        if drained_tab is not None:
            # unique rows can exceed any fixed TABCAP: when a fold
            # leaves the table more than 3/4 full, drain the folded
            # unique rows to the host (counts merge associatively at
            # finalize) and reset.  This is graceful degradation only —
            # every re-drained epoch re-transfers the active signature
            # set (measured 537 MB every other chunk at F1-400 human
            # scale BEFORE the signature-keyed dense table; with it the
            # append table carries only hash collisions/row spill and
            # drains never fire on that workload)
            folded_n = int(np.asarray(state["tab_n"]))
            if folded_n > caps["TABCAP"] * 3 // 4:
                k = min(_next_pow2(max(folded_n, 1)), caps["TABCAP"])
                drained_tab.append(tuple(
                    np.asarray(state[f][:k])[:folded_n].copy()
                    for f in ("tab_h1", "tab_h2", "tab_h3fl", "tab_cnt")))
                state = _tab_clear(state)
    mem_n = int(scal[0])
    if mem_n > caps["MEMCAP"] // 2:
        k = min(_next_pow2(max(mem_n, 1)), caps["MEMCAP"])
        drained.append((np.asarray(state["mem_sg"][:k])[:mem_n].copy(),
                        np.asarray(state["mem_tid"][:k])[:mem_n].copy(),
                        np.asarray(state["mem_chunk"][:k])[:mem_n].copy()))
        state = dict(state)
        state["mem_n"] = jnp.zeros((), jnp.int32)
    return state, drained
