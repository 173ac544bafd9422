"""Dense-batched module solver.

Most sequence-sharing modules are small (a gene family: tens of segments x
a handful of isoforms).  Instead of the global CSR edge list, modules are
bucketed into padded size classes and solved as batched dense EM:

    s     = einsum('bct,bt->bc', M, theta)          (segment intensities)
    num   = einsum('bct,bc->bt', M, R / s)
    theta = theta * num / denom

as batched matrix products, replacing the CSR path's gather/scatter.
Oversized modules fall back to the CSR solver (model/solver.py).

The padded membership tensor M is mostly zeros, so only its COO
coordinates are copied to the device; M, the denominator, and the
read-attribution starting point are all materialized on device inside the
jitted solve.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .modules import ModuleDecomposition, SegmentGraph

# (max segments, max transcripts) per class; larger modules -> CSR
SIZE_CLASSES: Tuple[Tuple[int, int], ...] = ((32, 8), (64, 16), (128, 32),
                                             (512, 128))

# True f32 products: at the default precision a GPU may run float32
# einsums in TF32 (~1e-3 relative error), which exceeds the convergence
# epsilon — the block-gain criterion then measures rounding noise, not
# likelihood improvement, and the while_loop spins to max_blocks.  Every
# float einsum here asks for HIGHEST.
_PREC = jax.lax.Precision.HIGHEST

# No GEMM autotuning for the dense solves: the autotuner picks among
# algorithms by timing them, the pick varies from one compilation to the
# next, and the algorithms round differently, so two processes (or one
# process with an empty compile cache) would print different digits for
# the same counts.  With the fixed default choice the dense path is
# bitwise reproducible across processes and cards (measured on H100s;
# tools/solve_determinism.py).  Its batched matrix-vector products are
# tiny, so the autotuner has little to win.
_COMPILE = {"xla_gpu_autotune_level": 0}


@dataclasses.dataclass
class DenseBatch:
    """One padded size class of modules, in COO membership form.

    ``flat_idx`` holds b*C*T + ci*T + ti per (segment, transcript)
    incidence — duplicates encode multiplicity (internal repeats) and
    accumulate in the device scatter that materializes M.
    """

    shape: Tuple[int, int, int]  # (B, C, T)
    flat_idx: np.ndarray  # int32/int64 [nnz]
    eumaps: np.ndarray  # [B, C]
    reads: np.ndarray  # [B, C]
    tid_map: np.ndarray  # int32 [B, T], -1 padding
    sids: np.ndarray  # int64 [B]

    @property
    def m(self) -> np.ndarray:
        """Materialized [B, C, T] membership tensor (host, for tests)."""
        B, C, T = self.shape
        m = np.zeros(B * C * T, dtype=self.eumaps.dtype)
        np.add.at(m, self.flat_idx, 1.0)
        return m.reshape(B, C, T)


@dataclasses.dataclass
class DensePartition:
    batches: List[DenseBatch]
    csr_sids: np.ndarray  # modules left to the CSR solver


def partition_modules(graph: SegmentGraph, modules: ModuleDecomposition,
                      eumaps: np.ndarray, read_count: np.ndarray,
                      classes: Tuple[Tuple[int, int], ...] = SIZE_CLASSES,
                      dtype=np.float32) -> DensePartition:
    """Bucket modules into dense size classes (fully vectorized).

    Active segments are those with sid >= 0 and EUMAps > 0 (reference
    skips E==0 segments in the likelihood, Fp src/emsar_functions.c:2952);
    transcripts are those appearing in a module's active segments."""
    ntid = graph.n_transcripts
    off, tids = graph.ct_offsets, graph.ct_tids
    seg_sizes = np.diff(off)
    active = (modules.cs >= 0) & (eumaps > 0)
    act_cids = np.flatnonzero(active)
    if len(act_cids) == 0:
        return DensePartition(batches=[],
                              csr_sids=np.empty(0, dtype=np.int64))

    cid_sid = modules.cs[act_cids]
    order = np.argsort(cid_sid, kind="stable")
    act_cids = act_cids[order]
    cid_sid = cid_sid[order]
    # modules present among active segments, as contiguous row ranges
    sids_u, first_pos, mod_ncid = np.unique(cid_sid, return_index=True,
                                            return_counts=True)
    nmod = len(sids_u)
    mod_row = np.repeat(np.arange(nmod, dtype=np.int64), mod_ncid)
    ci = np.arange(len(act_cids), dtype=np.int64) \
        - np.repeat(first_pos, mod_ncid)  # local segment index

    # flat (module, local segment, tid) incidences
    e_sizes = seg_sizes[act_cids]
    n_inc = int(e_sizes.sum())
    estart = np.zeros(len(act_cids) + 1, dtype=np.int64)
    np.cumsum(e_sizes, out=estart[1:])
    within = np.arange(n_inc, dtype=np.int64) - np.repeat(estart[:-1],
                                                          e_sizes)
    e_tid = tids[np.repeat(off[act_cids], e_sizes) + within].astype(np.int64)
    e_mod = np.repeat(mod_row, e_sizes)
    e_ci = np.repeat(ci, e_sizes)

    # per-module transcript lists (sorted) + local ranks
    key = e_mod * ntid + e_tid
    uniq = np.unique(key)
    u_mod = uniq // ntid
    u_tid = (uniq % ntid).astype(np.int32)
    mod_ntid = np.bincount(u_mod, minlength=nmod)
    u_start = np.zeros(nmod + 1, dtype=np.int64)
    np.cumsum(mod_ntid, out=u_start[1:])
    u_rank = np.arange(len(uniq), dtype=np.int64) \
        - np.repeat(u_start[:-1], mod_ntid)
    e_ti = u_rank[np.searchsorted(uniq, key)]

    # smallest fitting class per module; none -> CSR
    n_cls = len(classes)
    cls = np.full(nmod, n_cls, dtype=np.int64)
    for k in reversed(range(n_cls)):
        cmax, tmax = classes[k]
        cls = np.where((mod_ncid <= cmax) & (mod_ntid <= tmax), k, cls)
    csr_sids = sids_u[cls == n_cls]

    cls_of_cid = cls[mod_row]
    cls_of_inc = cls[e_mod]
    cls_of_u = cls[u_mod]
    batches: List[DenseBatch] = []
    for k, (cmax, tmax) in enumerate(classes):
        members = np.flatnonzero(cls == k)
        if len(members) == 0:
            continue
        B = len(members)
        brow = np.full(nmod, -1, dtype=np.int64)
        brow[members] = np.arange(B)

        emask = cls_of_inc == k
        flat = (brow[e_mod[emask]] * (cmax * tmax)
                + e_ci[emask] * tmax + e_ti[emask])
        flat_idx = flat.astype(np.int32 if B * cmax * tmax < 2**31
                               else np.int64)

        E_cls = np.zeros((B, cmax), dtype=dtype)
        R_cls = np.zeros((B, cmax), dtype=dtype)
        cmask = cls_of_cid == k
        rows, cols = brow[mod_row[cmask]], ci[cmask]
        E_cls[rows, cols] = eumaps[act_cids[cmask]]
        R_cls[rows, cols] = read_count[act_cids[cmask]]

        tid_map = np.full((B, tmax), -1, dtype=np.int32)
        umask = cls_of_u == k
        tid_map[brow[u_mod[umask]], u_rank[umask]] = u_tid[umask]

        batches.append(DenseBatch(shape=(B, cmax, tmax), flat_idx=flat_idx,
                                  eumaps=E_cls, reads=R_cls, tid_map=tid_map,
                                  sids=sids_u[members]))
    return DensePartition(batches=batches, csr_sids=csr_sids)


def _em_iter_dense(m, reads, inv_denom, theta):
    s = jnp.einsum("bct,bt->bc", m, theta,
                   preferred_element_type=theta.dtype,
                   precision=_PREC)
    ratio = jnp.where(s > 0, reads / jnp.where(s > 0, s, 1.0), 0.0)
    num = jnp.einsum("bct,bc->bt", m, ratio,
                     preferred_element_type=theta.dtype, precision=_PREC)
    return theta * num * inv_denom


def _materialize(flat_idx, eumaps, B: int, C: int, T: int):
    """COO coordinates -> dense [B, C, T] membership (device scatter)."""
    m = jnp.zeros((B * C * T,), dtype=eumaps.dtype)
    m = m.at[flat_idx].add(1.0)
    return m.reshape(B, C, T)


def _solve_loop(m, eumaps, reads, inv_denom, theta0, epsilon,
                block_iters: int, max_blocks: int):
    """SQUAREM EM from ``theta0`` with the same convergence semantics as
    the CSR solver (termwise likelihood gains).  Shared by the main solve
    and the vmapped restart rounds."""

    def intens(th):
        return jnp.einsum("bct,bt->bc", m, th,
                          preferred_element_type=th.dtype,
                          precision=_PREC)

    def gain_rows(s_old, s_new):
        both = (s_old > 0) & (s_new > 0)
        ratio = jnp.log1p(jnp.where(both, (s_new - s_old) /
                                    jnp.where(both, s_old, 1.0), 0.0))
        died = (s_old > 0) & (s_new <= 0) & (reads > 0)
        born = (s_old <= 0) & (s_new > 0) & (reads > 0)
        term = jnp.where(both, reads * ratio,
                         jnp.where(died, -1e30,
                                   jnp.where(born, 1e30, 0.0)))
        return jnp.sum(term - eumaps * (s_new - s_old), axis=1)

    def cycle(th):
        t1 = _em_iter_dense(m, reads, inv_denom, th)
        t2 = _em_iter_dense(m, reads, inv_denom, t1)
        r = t1 - th
        v = t2 - t1 - r
        rn = jnp.sqrt(jnp.sum(r * r, axis=1, keepdims=True))
        vn = jnp.sqrt(jnp.sum(v * v, axis=1, keepdims=True))
        alpha = jnp.where(vn > 0, -rn / jnp.where(vn > 0, vn, 1.0), -1.0)
        alpha = jnp.minimum(alpha, -1.0)
        # coordinates the extrapolation would clamp to 0 take the plain
        # double-EM value instead: an exact 0 is an absorbing boundary for
        # multiplicative EM and can freeze a suboptimal KKT point
        extrap = th - 2.0 * alpha * r + alpha * alpha * v
        cand = jnp.where(extrap > 0, extrap, t2)
        cand = _em_iter_dense(m, reads, inv_denom, cand)
        better = (gain_rows(intens(t2), intens(cand)) >= 0)[:, None]
        return jnp.where(better, cand, t2)

    def block(state):
        th, s_prev, it, _ = state
        th = jax.lax.fori_loop(0, block_iters, lambda _, x: cycle(x), th)
        s_new = intens(th)
        # per-module convergence (max row gain), matching the reference's
        # per-module epsilon (MLE :3119), not a batch-summed criterion
        return th, s_new, it + 1, jnp.max(gain_rows(s_prev, s_new))

    def cond(state):
        _, _, it, gain = state
        return (gain >= epsilon) & (it < max_blocks)

    state = (theta0, intens(theta0), jnp.int32(0),
             jnp.asarray(jnp.inf, theta0.dtype))
    th, _, it, _ = jax.lax.while_loop(cond, block, block(state))
    return th, it


def _prep_dense(flat_idx, eumaps, B: int, C: int, T: int):
    m = _materialize(flat_idx, eumaps, B, C, T)
    denom = jnp.einsum("bct,bc->bt", m, eumaps,
                       preferred_element_type=eumaps.dtype, precision=_PREC)
    inv_denom = jnp.where(denom > 0, 1.0 / jnp.where(denom > 0, denom, 1.0),
                          0.0)
    return m, inv_denom


@functools.partial(jax.jit,
                   static_argnames=("B", "C", "T", "block_iters",
                                    "max_blocks"),
                   compiler_options=_COMPILE)
def _dense_solve_jax(flat_idx, eumaps, reads, epsilon,
                     B: int, C: int, T: int,
                     block_iters: int, max_blocks: int):
    m, inv_denom = _prep_dense(flat_idx, eumaps, B, C, T)
    # read-attribution start: all of each segment's reads granted to every
    # member transcript (upper-bound scale, cheap, halves the cycle count
    # vs. all-ones; exact zeros stay zero, which is their optimum)
    theta0 = jnp.einsum("bct,bc->bt", m, reads,
                        preferred_element_type=reads.dtype,
                        precision=_PREC) * inv_denom
    return _solve_loop(m, eumaps, reads, inv_denom, theta0, epsilon,
                       block_iters, max_blocks)


@functools.partial(jax.jit,
                   static_argnames=("B", "C", "T", "block_iters",
                                    "max_blocks"),
                   compiler_options=_COMPILE)
def _dense_restart_jax(flat_idx, eumaps, reads, inits, epsilon,
                       B: int, C: int, T: int,
                       block_iters: int, max_blocks: int):
    """Random-restart solves of one dense size class, vmapped over the
    rounds axis of ``inits`` [R, B, T].  The membership tensor and
    denominator are materialized once and broadcast across rounds."""
    m, inv_denom = _prep_dense(flat_idx, eumaps, B, C, T)
    th, it = jax.vmap(
        lambda th0: _solve_loop(m, eumaps, reads, inv_denom, th0, epsilon,
                                block_iters, max_blocks))(inits)
    return th, jnp.max(it)


def subset_batch(batch: DenseBatch, rows: np.ndarray) -> DenseBatch:
    """The sub-batch of ``rows`` (module indices into the batch axis)."""
    B, C, T = batch.shape
    brow = np.full(B, -1, dtype=np.int64)
    brow[rows] = np.arange(len(rows))
    b_of = batch.flat_idx // (C * T)
    keep = brow[b_of] >= 0
    rem = batch.flat_idx[keep] - b_of[keep] * (C * T)
    flat = brow[b_of[keep]] * (C * T) + rem
    nB = len(rows)
    return DenseBatch(
        shape=(nB, C, T),
        flat_idx=flat.astype(np.int32 if nB * C * T < 2**31 else np.int64),
        eumaps=batch.eumaps[rows], reads=batch.reads[rows],
        tid_map=batch.tid_map[rows], sids=batch.sids[rows])


def solve_dense_restarts(batch: DenseBatch, inits: np.ndarray,
                         epsilon: float, block_iters: int = 8,
                         max_blocks: int = 2048) -> np.ndarray:
    """Solve one dense size class from ``inits`` [R, B, T] (the restart
    rounds behind sd.of.FPKM); returns theta [R, B, T]."""
    batch, B0 = _pad_b(batch)
    B, C, T = batch.shape
    if B != B0:
        inits = np.pad(inits, ((0, 0), (0, B - B0), (0, 0)))
    E = jnp.asarray(batch.eumaps)
    th, _ = _dense_restart_jax(jnp.asarray(batch.flat_idx), E,
                               jnp.asarray(batch.reads),
                               jnp.asarray(inits.astype(batch.eumaps.dtype)),
                               jnp.asarray(epsilon, E.dtype),
                               B, C, T, block_iters, max_blocks)
    return np.asarray(th)[:, :B0]


def _quantize_b(b: int) -> int:
    """Round the batch axis up to a multiple of an eighth of its next
    power of two (4 shapes per octave; under a quarter inert pad rows
    above 64 rows), so
    distinct module counts share compiled executables instead of
    compiling one per (index, sample)."""
    if b <= 8:
        return 8
    p2 = 1 << (b - 1).bit_length()
    step = max(p2 // 8, 8)
    return -(-b // step) * step


def _pad_b(batch: DenseBatch) -> Tuple[DenseBatch, int]:
    """Pad the batch axis to a quantized size with inert rows (E = R = 0,
    no incidences: zero denominator, zero theta, zero likelihood gain)."""
    B, C, T = batch.shape
    Bp = _quantize_b(B)
    if Bp == B:
        return batch, B
    pad = Bp - B
    return DenseBatch(
        shape=(Bp, C, T), flat_idx=batch.flat_idx,
        eumaps=np.pad(batch.eumaps, ((0, pad), (0, 0))),
        reads=np.pad(batch.reads, ((0, pad), (0, 0))),
        tid_map=np.pad(batch.tid_map, ((0, pad), (0, 0)),
                       constant_values=-1),
        sids=np.pad(batch.sids, (0, pad), constant_values=-1)), B


def solve_dense_batch(batch: DenseBatch, epsilon: float,
                      block_iters: int = 8, max_blocks: int = 2048
                      ) -> Tuple[np.ndarray, int]:
    """Solve one dense size class; returns (theta [B, T], n_blocks)."""
    batch, B0 = _pad_b(batch)
    B, C, T = batch.shape
    E = jnp.asarray(batch.eumaps)
    R = jnp.asarray(batch.reads)
    th, it = _dense_solve_jax(jnp.asarray(batch.flat_idx), E, R,
                              jnp.asarray(epsilon, E.dtype),
                              B, C, T, block_iters, max_blocks)
    return np.asarray(th)[:B0], int(it)
