"""SPMD distribution layer: sharded multi-sample EM over a device mesh.

The reference has no distribution story at all (single process + pthreads,
SURVEY §2 C23); this layer is new design:

* mesh axes: ``dp`` (samples — data parallel) x ``tp`` (likelihood edges —
  model parallel);
* the signature->transcript edge list is sharded over ``tp``; per-sample
  read counts are sharded over ``dp``; theta is replicated within ``tp``;
* each EM iteration computes partial segment-sums over the local edge
  shard and merges them with ``jax.lax.psum`` over ``tp`` — sufficient
  statistics ride the device interconnect, matching the north-star design
  (BASELINE.json: "per-shard sufficient statistics merged each EM
  iteration via jax.lax.psum").

Multi-sample batching (-M) vmaps the same update over the sample axis,
turning the solve into dense [S, …] device work.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..model.solver import SolverProblem


def make_mesh(n_devices: Optional[int] = None, dp: int = 1,
              devices=None) -> Mesh:
    """1-D or 2-D mesh (dp, tp) over the first n devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if n_devices % dp != 0:
        raise ValueError(f"n_devices {n_devices} not divisible by dp {dp}")
    tp = n_devices // dp
    return Mesh(devices.reshape(dp, tp), ("dp", "tp"))


@dataclasses.dataclass
class ShardedProblem:
    """Edge arrays padded to a multiple of the tp axis; reads [S, C].

    ``eumaps`` / ``denom`` may be per-sample ([S, C] / [S, T], sharded like
    reads) — multisample batches have per-sample fragment-length weights —
    or shared ([C] / [T], replicated).

    ``layout``:
      * 'edges' — arbitrary balanced edge split over tp; theta/denom stay
        [S, T] replicated within tp (both segment- and transcript-sums
        psum over tp);
      * 'transcript' — transcripts partitioned into tp contiguous blocks
        and every edge stored on its transcript's shard, so theta/denom
        shard over tp ([S, Tp/tp] per device: T-axis memory drops
        tp-fold, BASELINE.json's very-large-transcriptome config) and
        only the segment intensities psum over tp.
    """

    n_transcripts: int
    n_segments: int
    edge_cid: jax.Array  # int32 [Ep] sharded P('tp')
    edge_tid: jax.Array  # 'edges': global tid; 'transcript': block-local
    edge_mult: jax.Array
    eumaps: jax.Array  # [S, C] sharded P('dp', None) (or [C] replicated)
    reads: jax.Array  # [S, C] sharded P('dp', None)
    denom: jax.Array  # [S, T] P('dp', None) | [S, Tp] P('dp', 'tp')
    mesh: Mesh
    layout: str = "edges"
    t_padded: int = 0  # Tp ('transcript' layout), multiple of tp
    theta0: Optional[jax.Array] = None  # optional warm start, like denom


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for multi-host runs (no-op when already
    initialized or single-host).  Per-host alignment shards then feed the
    same sharded solve; cross-host merges ride the same psum collectives
    over DCN."""
    import jax

    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError:
        pass  # already initialized


def shard_problem(problem: SolverProblem, reads_per_sample: np.ndarray,
                  mesh: Mesh, dtype=np.float32,
                  shard_by: str = "edges",
                  eumaps_per_sample: Optional[np.ndarray] = None,
                  denom_per_sample: Optional[np.ndarray] = None
                  ) -> ShardedProblem:
    """Pad + device_put the edge arrays and per-sample read counts.

    ``reads_per_sample``: [S, C_active] float array (one row per sample).
    Padding edges carry mult=0 so they contribute nothing.

    ``eumaps_per_sample`` / ``denom_per_sample``: optional [S, C] / [S, T]
    per-sample EUMAps and denominators (multisample batches weight EUMA by
    per-sample fragment-length distributions); defaults to the shared
    values in ``problem``.

    ``shard_by``: 'edges' (arbitrary balanced split; theta replicated
    within tp) or 'transcript' (transcripts partitioned into tp contiguous
    blocks, every edge stored on its transcript's shard, theta/denom
    sharded over tp — identical results, tp-fold lower T-axis memory).
    """
    tp = mesh.shape["tp"]
    dp = mesh.shape["dp"]
    S = reads_per_sample.shape[0]
    Sp = -(-S // dp) * dp
    ntid = problem.n_transcripts
    C = len(problem.eumaps)

    def pad_s(rows, ncol):
        out = np.zeros((Sp, ncol), dtype=dtype)
        out[:S] = rows
        return out

    reads = pad_s(reads_per_sample, reads_per_sample.shape[1])
    if eumaps_per_sample is None:
        eumaps_per_sample = np.broadcast_to(problem.eumaps, (S, C))
    if denom_per_sample is None:
        denom_per_sample = np.broadcast_to(problem.denom, (S, ntid))
    eumaps = pad_s(eumaps_per_sample, C)

    # read-attribution warm start (solver.solve's default init): every
    # segment's reads granted fully to each member transcript — halves
    # the cycle count vs all-ones
    num0 = np.zeros((S, ntid), dtype=np.float64)
    seg_r = np.asarray(reads_per_sample, dtype=np.float64)
    for s in range(S):
        np.add.at(num0[s], problem.edge_tid,
                  problem.edge_mult * seg_r[s][problem.edge_cid])
    th0 = num0 / np.where(denom_per_sample > 0, denom_per_sample, 1.0)
    th0 = np.where(denom_per_sample > 0, th0, 0.0)

    e_sh = NamedSharding(mesh, P("tp"))
    r_sh = NamedSharding(mesh, P("dp", None))

    if shard_by == "edges":
        E = len(problem.edge_cid)
        Ep = -(-E // tp) * tp

        def pad_e(a, fill=0):
            out = np.full(Ep, fill, dtype=a.dtype)
            out[:E] = a
            return out

        return ShardedProblem(
            n_transcripts=ntid, n_segments=C,
            edge_cid=jax.device_put(pad_e(problem.edge_cid), e_sh),
            edge_tid=jax.device_put(pad_e(problem.edge_tid), e_sh),
            edge_mult=jax.device_put(pad_e(problem.edge_mult.astype(dtype)),
                                     e_sh),
            eumaps=jax.device_put(eumaps, r_sh),
            reads=jax.device_put(reads, r_sh),
            denom=jax.device_put(pad_s(denom_per_sample, ntid), r_sh),
            mesh=mesh, layout="edges",
            theta0=jax.device_put(pad_s(th0, ntid), r_sh))
    if shard_by != "transcript":
        raise ValueError(f"unknown shard_by {shard_by!r}")

    # transcript layout: block j owns tids [j*blk, (j+1)*blk); its edges
    # live only on shard j, padded per shard to the max shard size
    blk = -(-ntid // tp)
    Tp = blk * tp
    shard_of = problem.edge_tid // blk
    order = np.argsort(shard_of, kind="stable")
    e_cid = problem.edge_cid[order]
    e_tid = problem.edge_tid[order]
    e_mult = problem.edge_mult[order]
    sh_sorted = shard_of[order]
    cnt = np.bincount(sh_sorted, minlength=tp)
    Emax = max(int(cnt.max()), 1)
    cid_p = np.zeros(tp * Emax, dtype=e_cid.dtype)
    tid_p = np.zeros(tp * Emax, dtype=e_tid.dtype)  # block-LOCAL ids
    mult_p = np.zeros(tp * Emax, dtype=dtype)
    off = np.concatenate([[0], np.cumsum(cnt)])
    for j in range(tp):
        sl = slice(off[j], off[j + 1])
        n = off[j + 1] - off[j]
        cid_p[j * Emax:j * Emax + n] = e_cid[sl]
        tid_p[j * Emax:j * Emax + n] = e_tid[sl] - j * blk
        mult_p[j * Emax:j * Emax + n] = e_mult[sl]

    def pad_t(rows):
        out = np.zeros((Sp, Tp), dtype=dtype)
        out[:S, :ntid] = rows
        return out

    t_sh = NamedSharding(mesh, P("dp", "tp"))
    return ShardedProblem(
        n_transcripts=ntid, n_segments=C,
        edge_cid=jax.device_put(cid_p, e_sh),
        edge_tid=jax.device_put(tid_p, e_sh),
        edge_mult=jax.device_put(mult_p, e_sh),
        eumaps=jax.device_put(eumaps, r_sh),
        reads=jax.device_put(reads, r_sh),
        denom=jax.device_put(pad_t(denom_per_sample), t_sh),
        mesh=mesh, layout="transcript", t_padded=Tp,
        theta0=jax.device_put(pad_t(th0), t_sh))


def _em_block_local(edge_cid, edge_tid, edge_mult, eumaps, reads, inv_denom,
                    theta, n_transcripts, n_segments, block_iters):
    """One block of EM iterations on local shards; psums over 'tp'.

    reads/eumaps/theta/inv_denom: [S_local, C] / [S_local, C] /
    [S_local, T] / [S_local, T]; edges: local [E_local].
    """

    def seg_c(vals_sxe):
        part = jax.vmap(lambda v: jax.ops.segment_sum(
            v, edge_cid, num_segments=n_segments))(vals_sxe)
        return jax.lax.psum(part, "tp")

    def seg_t(vals_sxe):
        part = jax.vmap(lambda v: jax.ops.segment_sum(
            v, edge_tid, num_segments=n_transcripts))(vals_sxe)
        return jax.lax.psum(part, "tp")

    def em_iter(th):
        s = seg_c(edge_mult[None, :] * th[:, edge_tid])  # [S, C]
        ratio = jnp.where(s > 0, reads / jnp.where(s > 0, s, 1.0), 0.0)
        num = seg_t(edge_mult[None, :] * ratio[:, edge_cid])  # [S, T]
        return th * num * inv_denom

    def intensities(th):
        return seg_c(edge_mult[None, :] * th[:, edge_tid])  # [S, C]

    def ll_of(s):
        lam = eumaps * s
        safe = jnp.where(lam > 0, lam, 1.0)
        return jnp.sum(jnp.where(lam > 0, reads * jnp.log(safe) - lam,
                                 jnp.where(reads > 0, -1e30, 0.0)), axis=1)

    def gain_of(s_old, s_new):
        """Per-sample logL delta from intensity deltas (float32-accurate;
        see model/solver.py)."""
        both = (s_old > 0) & (s_new > 0)
        safe_old = jnp.where(both, s_old, 1.0)
        ratio = jnp.log1p(jnp.where(both, (s_new - s_old) / safe_old, 0.0))
        died = (s_old > 0) & (s_new <= 0) & (reads > 0)
        born = (s_old <= 0) & (s_new > 0) & (reads > 0)
        term = jnp.where(both, reads * ratio,
                         jnp.where(died, -1e30,
                                   jnp.where(born, 1e30, 0.0)))
        return jnp.sum(term - eumaps * (s_new - s_old), axis=1)

    def squarem_cycle(th):
        # per-sample SQUAREM extrapolation (see model/solver.py); the
        # steplength and the likelihood safeguard are per dp-local sample
        t1 = em_iter(th)
        t2 = em_iter(t1)
        r = t1 - th
        v = t2 - t1 - r
        rn = jnp.sqrt(jnp.sum(r * r, axis=1, keepdims=True))
        vn = jnp.sqrt(jnp.sum(v * v, axis=1, keepdims=True))
        alpha = jnp.where(vn > 0, -rn / jnp.where(vn > 0, vn, 1.0), -1.0)
        alpha = jnp.minimum(alpha, -1.0)
        # zero-crossing coordinates fall back to the plain double-EM value
        # (exact 0 is absorbing for multiplicative EM)
        extrap = th - 2.0 * alpha * r + (alpha * alpha) * v
        cand = em_iter(jnp.where(extrap > 0, extrap, t2))
        better = (gain_of(intensities(t2), intensities(cand)) >= 0)[:, None]
        return jnp.where(better, cand, t2)

    theta = jax.lax.fori_loop(0, block_iters,
                              lambda _, th: squarem_cycle(th), theta)
    s_new = intensities(theta)
    return theta, s_new, ll_of(s_new), gain_of


def _em_block_local_t(edge_cid, edge_tid_loc, edge_mult, eumaps, reads,
                      inv_denom, theta, blk, n_segments, block_iters):
    """Transcript-sharded EM block: theta/denom are [S_local, blk] per tp
    shard and every edge lives on its transcript's shard, so only the
    segment intensities cross shards (one psum per EM step); the
    transcript-sum needs no collective at all."""

    def intensities(th):
        part = jax.vmap(lambda v: jax.ops.segment_sum(
            v, edge_cid, num_segments=n_segments))(
                edge_mult[None, :] * th[:, edge_tid_loc])
        return jax.lax.psum(part, "tp")  # [S, C] replicated within tp

    def em_iter(th):
        s = intensities(th)
        ratio = jnp.where(s > 0, reads / jnp.where(s > 0, s, 1.0), 0.0)
        num = jax.vmap(lambda v: jax.ops.segment_sum(
            v, edge_tid_loc, num_segments=blk))(
                edge_mult[None, :] * ratio[:, edge_cid])
        return th * num * inv_denom

    def ll_of(s):
        lam = eumaps * s
        safe = jnp.where(lam > 0, lam, 1.0)
        return jnp.sum(jnp.where(lam > 0, reads * jnp.log(safe) - lam,
                                 jnp.where(reads > 0, -1e30, 0.0)), axis=1)

    def gain_of(s_old, s_new):
        both = (s_old > 0) & (s_new > 0)
        safe_old = jnp.where(both, s_old, 1.0)
        ratio = jnp.log1p(jnp.where(both, (s_new - s_old) / safe_old, 0.0))
        died = (s_old > 0) & (s_new <= 0) & (reads > 0)
        born = (s_old <= 0) & (s_new > 0) & (reads > 0)
        term = jnp.where(both, reads * ratio,
                         jnp.where(died, -1e30,
                                   jnp.where(born, 1e30, 0.0)))
        return jnp.sum(term - eumaps * (s_new - s_old), axis=1)

    def squarem_cycle(th):
        t1 = em_iter(th)
        t2 = em_iter(t1)
        r = t1 - th
        v = t2 - t1 - r
        # steplength norms span the sharded T axis -> psum over tp
        rn = jnp.sqrt(jax.lax.psum(jnp.sum(r * r, axis=1), "tp"))[:, None]
        vn = jnp.sqrt(jax.lax.psum(jnp.sum(v * v, axis=1), "tp"))[:, None]
        alpha = jnp.where(vn > 0, -rn / jnp.where(vn > 0, vn, 1.0), -1.0)
        alpha = jnp.minimum(alpha, -1.0)
        extrap = th - 2.0 * alpha * r + (alpha * alpha) * v
        cand = em_iter(jnp.where(extrap > 0, extrap, t2))
        better = (gain_of(intensities(t2), intensities(cand)) >= 0)[:, None]
        return jnp.where(better, cand, t2)

    theta = jax.lax.fori_loop(0, block_iters,
                              lambda _, th: squarem_cycle(th), theta)
    s_new = intensities(theta)
    return theta, s_new, ll_of(s_new), gain_of


def solve_sharded(sp: ShardedProblem, epsilon: float = 1e-6,
                  max_blocks: int = 4096, block_iters: int = 32
                  ) -> Tuple[np.ndarray, float, int]:
    """Full sharded EM solve: jitted while_loop of psum-merged blocks.

    Returns (theta [S, T], logL, n_blocks).
    """
    mesh = sp.mesh
    dtype = sp.reads.dtype
    transcript = sp.layout == "transcript"
    t_spec = P("dp", "tp") if transcript else P("dp", None)
    if sp.theta0 is not None:
        theta0 = sp.theta0.astype(dtype)
    else:
        theta0 = jnp.where(sp.denom > 0, jnp.asarray(1.0, dtype), 0.0)
    theta0 = jax.device_put(theta0, NamedSharding(mesh, t_spec))
    inv_denom = jnp.where(sp.denom > 0, 1.0 / jnp.where(sp.denom > 0,
                                                        sp.denom, 1.0), 0.0)

    n_t, n_s = sp.n_transcripts, sp.n_segments
    blk = sp.t_padded // mesh.shape["tp"] if transcript else 0

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("tp"), P("tp"), P("tp"), P("dp", None), P("dp", None),
                  t_spec, t_spec),
        out_specs=(t_spec, P(), P()),
        check_vma=False)
    def run(edge_cid, edge_tid, edge_mult, eumaps, reads, inv_den, th0):
        def step(th):
            if transcript:
                return _em_block_local_t(edge_cid, edge_tid, edge_mult,
                                         eumaps, reads, inv_den, th, blk,
                                         n_s, block_iters)
            return _em_block_local(edge_cid, edge_tid, edge_mult, eumaps,
                                   reads, inv_den, th, n_t, n_s, block_iters)

        def block(state):
            th, s_prev, _, it, _ = state
            th_new, s_new, ll_new, gain_of = step(th)
            gain = jax.lax.psum(jnp.sum(gain_of(s_prev, s_new)), "dp")
            return th_new, s_new, ll_new, it + 1, gain

        def cond(state):
            _, _, _, it, gain = state
            return (gain >= epsilon) & (it < max_blocks)

        th, s, ll, _ = step(th0)
        state = (th, s, ll, jnp.zeros((), jnp.int32),
                 jnp.asarray(jnp.inf, th.dtype))
        th, _, ll, it, _ = jax.lax.while_loop(cond, block, state)
        ll_tot = jax.lax.psum(jnp.sum(ll), "dp")
        return th, ll_tot[None], it[None]

    theta, ll, it = jax.jit(run)(sp.edge_cid, sp.edge_tid, sp.edge_mult,
                                 sp.eumaps, sp.reads, inv_denom, theta0)
    theta = np.asarray(theta)[:, :n_t]
    return theta, float(np.asarray(ll)[0]), int(np.asarray(it)[0])
