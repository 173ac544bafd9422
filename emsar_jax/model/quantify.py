"""Quantification orchestration: index + signature counts -> FPKM/TPM.

Mirrors the reference per-sample pipeline (src/emsar_main.c:380-488):
fragment-length weighting, module decomposition with the EUMAcut loop,
EUMAps construction, the (EM) likelihood maximization, and iEUMA /
inferred read counts.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from ..config import QuantConfig
from ..ingest.collapse import SampleCounts
from ..io.rsh import RshIndex
from ..utils.timing import phase
from .modules import (ModuleDecomposition, SegmentGraph, build_segment_graph,
                      decompose_modules)
from .solver import SolverProblem, build_problem, solve


@dataclasses.dataclass
class QuantResult:
    fpkm: np.ndarray  # [ntid] the ML estimate
    fpkm_rounds: np.ndarray  # [num_round, ntid] (identical rows: EM is
    # deterministic; kept for output-format parity)
    ieuma: np.ndarray  # [ntid]
    adj_euma: np.ndarray  # [n_cid]
    wf: np.ndarray  # [nFraglen]
    graph: SegmentGraph
    modules: ModuleDecomposition
    total_read_count: int
    loglik: float
    em_blocks: int


def _resolve_dtype(cfg: QuantConfig):
    """'auto' = float64 on the CPU, float32 plus the host float64 polish on
    a GPU.  Whether a float64 device solve is fast enough to replace the
    polish is an open measurement (chip_smoke.py prints both times)."""
    if cfg.solver_dtype == "float64":
        return np.float64
    if cfg.solver_dtype == "float32":
        return np.float32
    import jax
    return np.float64 if jax.devices()[0].platform == "cpu" else np.float32


def compute_wf(index: RshIndex, fraglength_counts: np.ndarray) -> np.ndarray:
    """Empirical fragment-length sampling probability (reference:
    transfer_fraglendist_to_Wf, src/emsar_functions.c:2503-2513)."""
    nfl = index.n_fraglen
    idx = np.arange(index.fraglen_min, index.fraglen_min + nfl)
    wf = fraglength_counts[idx].astype(np.float64)
    s = wf.sum()
    return wf / s if s > 0 else wf * np.nan


def index_modules(index: RshIndex) -> Optional[ModuleDecomposition]:
    """The index-only module decomposition, cached on the index object.

    At EUMAcut == 0 every segment is active regardless of the sample's
    fragment-length weights (the reference cut is strict '<',
    propagate_2 src/emsar_functions.c:2242), so the decomposition
    depends only on the index's transcript-sharing structure.  Returns
    None when a component exceeds MAX_NTID_PER_SID — the EUMAcut loop
    then needs real adjEUMA values (quantify_sample falls back).

    Idempotent and thread-safe: CLI paths call this on a worker thread
    while the alignment file is still streaming, overlapping the
    decomposition with ingest."""
    cached = getattr(index, "_modules_cache", None)
    if cached is not None:
        return cached[0]
    with _MODULES_LOCK:
        cached = getattr(index, "_modules_cache", None)
        if cached is not None:
            return cached[0]
        ncid = index.n_cid
        graph0 = build_segment_graph(index, np.ones(ncid),
                                     np.zeros(ncid, dtype=np.int64))
        mods = decompose_modules(graph0, fail_on_oversize=True)
        index._modules_cache = (mods,)
    return mods


_MODULES_LOCK = threading.Lock()


@dataclasses.dataclass
class SampleProblem:
    """One sample's likelihood, as every solver path receives it."""

    wf: np.ndarray  # [nFraglen]
    adj_euma: np.ndarray  # [n_cid]
    read_count: np.ndarray  # [n_cid]
    graph: SegmentGraph
    modules: ModuleDecomposition
    eumaps: np.ndarray  # [n_cid]
    problem: SolverProblem  # float64 masters


def sample_problem(index: RshIndex, counts: SampleCounts, cfg: QuantConfig
                   ) -> SampleProblem:
    """Fragment-length weighting, module decomposition and the float64
    edge-list problem of one sample (reference src/emsar_main.c:380-431)."""
    with phase("fragment-length weighting", cfg.verbose):
        wf = compute_wf(index, counts.fraglength_counts)
        # adjEUMA = EUMA @ Wf in f64 (the one-shot exactness-sensitive matvec)
        adj_single = index.single_euma.astype(np.float64) @ wf
        adj_multi = index.multi_euma.astype(np.float64) @ wf
        adj_euma = np.concatenate([adj_single, adj_multi])

    read_count = counts.readcount_per_cid()

    with phase("module decomposition", cfg.verbose):
        graph = build_segment_graph(index, adj_euma, read_count)
        # index-only decomposition (cached; possibly prefetched on a
        # worker thread during ingest) — the EUMAcut loop with real
        # adjEUMA values only when a module oversizes
        modules = index_modules(index)
        if modules is None:
            modules = decompose_modules(graph, verbose=cfg.verbose)

    with phase("problem build", cfg.verbose):
        # EUMAps (reference construct_EUMAps :3148-3154)
        eumaps = adj_euma / 1e3 * (counts.total_read_count / 1e6) \
            * (10.0 ** cfg.delta)
        # the problem keeps f64 masters; solve() casts to the device dtype
        problem = build_problem(graph, modules, eumaps, read_count,
                                dtype=np.float64)
    return SampleProblem(wf=wf, adj_euma=adj_euma, read_count=read_count,
                         graph=graph, modules=modules, eumaps=eumaps,
                         problem=problem)


def quantify_sample(index: RshIndex, counts: SampleCounts, cfg: QuantConfig
                    ) -> QuantResult:
    sp = sample_problem(index, counts, cfg)
    problem = sp.problem

    with phase("EM solve", cfg.verbose):
        dtype = _resolve_dtype(cfg)
        part = None
        if cfg.solver_mode == "auto":
            fpkm, blocks, part = _solve_auto(sp.graph, sp.modules, sp.eumaps,
                                             sp.read_count, problem, cfg,
                                             dtype)
            ll = float("nan")
        else:
            fpkm, ll, blocks = solve(problem, epsilon=cfg.epsilon,
                                     max_iters=cfg.max_niter_mle,
                                     block_iters=cfg.solver_block_iters,
                                     dtype=dtype)
            fpkm = fpkm.astype(np.float64)
        if dtype == np.float32 or cfg.solver_mode == "auto":
            # close the float32 convergence floor / dense-CSR seams with a
            # short host f64 SQUAREM polish (see solver.polish_host_f64)
            from .solver import polish_host_f64
            fpkm = polish_host_f64(problem, fpkm,
                                   epsilon=max(cfg.epsilon, 1e-9),
                                   max_cycles=200)
        if not np.isfinite(ll):
            ll = _host_loglik(problem, fpkm)

    with phase("iEUMA", cfg.verbose):
        # iEUMA[tid] = sum over ALL cids containing tid (with multiplicity),
        # regardless of module exclusion (reference compute_iEUMA :3218)
        ieuma = np.zeros(index.n_transcripts, dtype=np.float64)
        sizes = np.diff(sp.graph.ct_offsets)
        np.add.at(ieuma, sp.graph.ct_tids,
                  np.repeat(sp.adj_euma, sizes))

    fpkm_rounds = _make_rounds(problem, fpkm, cfg, dtype, part=part,
                               graph=sp.graph, modules=sp.modules,
                               eumaps=sp.eumaps, read_count=sp.read_count)
    return QuantResult(fpkm=fpkm, fpkm_rounds=fpkm_rounds, ieuma=ieuma,
                       adj_euma=sp.adj_euma, wf=sp.wf, graph=sp.graph,
                       modules=sp.modules,
                       total_read_count=counts.total_read_count,
                       loglik=ll, em_blocks=blocks)


def _restart_eps(cfg: QuantConfig) -> float:
    """Restart-round epsilon: the sd column reports manifold spread
    (O(1-100) FPKM); convergence error contributes O(eps * scale).
    Measured on the 12k-transcript bench workload, eps 1e-3 vs 1e-4
    leaves the sd distribution statistically identical (2618 vs 2620
    transcripts with sd > 1, same max/mean);
    re-validated round 4 on the PE BAM workload (464 vs 464 transcripts
    with sd > 1, identical max, mean 1.0002 vs 0.9991) and on a fully
    collinear 800-transcript fixture (identical stats to all digits) —
    tools/validate_restart_eps.py.  Only the default epsilon is
    loosened: an explicit -e overrides this floor in either direction."""
    default_eps = type(cfg).__dataclass_fields__["epsilon"].default
    return 1e-3 if cfg.epsilon == default_eps else cfg.epsilon


def _make_rounds(problem, fpkm: np.ndarray, cfg: QuantConfig, dtype,
                 part=None, graph=None, modules=None, eumaps=None,
                 read_count=None) -> np.ndarray:
    """[num_round, ntid] FPKM rounds: round 0 is the deterministic solve
    (golden-stable), rounds 1..n-1 are random-restart solves whose spread
    across the flat maximizer manifold populates sd.of.FPKM (reference
    NUM_ROUND loop, src/emsar_main.c:441-450).

    Cost controls (exact, not approximations): transcripts in
    single-transcript modules have a unique maximizer — every round lands
    on round 0's value and their sd is exactly 0 — so restarts solve only
    the edge subset of multi-transcript modules.  The restart epsilon is
    looser than round 0's: the sd column reports manifold spread (orders
    of magnitude above convergence error).  When the main solve ran the
    dense path (``part``), restarts ride the same dense batches
    (vmapped over rounds) instead of the CSR edge list."""
    if cfg.num_round <= 1:
        return fpkm[None, :].copy()
    if part is not None:
        return _make_rounds_dense(problem, fpkm, cfg, dtype, part,
                                  graph, modules, eumaps, read_count)
    with phase("restart rounds", cfg.verbose):
        extra = _csr_restarts(problem, fpkm, cfg, dtype)
        if extra is None:
            return np.broadcast_to(fpkm,
                                   (cfg.num_round, len(fpkm))).copy()
    return np.concatenate([fpkm[None, :], extra], axis=0)


def _csr_restarts(problem, fpkm: np.ndarray, cfg: QuantConfig, dtype
                  ) -> Optional[np.ndarray]:
    """Restart rounds on the CSR edge list, restricted to transcripts in
    multi-transcript modules; [num_round-1, ntid] with round-0 values
    elsewhere, or None when nothing is multi-transcript."""
    from .solver import solve_restart_rounds

    # a transcript sits in a multi-transcript module iff some segment
    # of its module holds >= 2 distinct tids; module connectivity runs
    # only through shared segments, so direct sharing is equivalent
    ntid = problem.n_transcripts
    denom_pos = problem.denom > 0
    e_cid = problem.edge_cid
    seg_deg = np.zeros(len(problem.eumaps), dtype=np.int64)
    np.add.at(seg_deg, e_cid, 1)
    multi_tid = np.zeros(ntid, dtype=bool)
    multi_tid[problem.edge_tid[seg_deg[e_cid] >= 2]] = True
    keep = multi_tid[problem.edge_tid]
    if not keep.any():
        return None
    # compact the segment axis to segments with a kept edge — the
    # others contribute nothing to the restricted likelihood but would
    # still cost segment_sum bandwidth every EM iteration
    seg_used = np.zeros(len(problem.eumaps), dtype=bool)
    seg_used[problem.edge_cid[keep]] = True
    new_cid = (np.cumsum(seg_used) - 1).astype(np.int32)
    sub = SolverProblem(
        n_transcripts=ntid, edge_cid=new_cid[problem.edge_cid[keep]],
        edge_tid=problem.edge_tid[keep],
        edge_mult=problem.edge_mult[keep],
        eumaps=problem.eumaps[seg_used], reads=problem.reads[seg_used],
        denom=np.where(multi_tid, problem.denom, 0.0))
    extra = solve_restart_rounds(
        sub, cfg.num_round - 1, epsilon=_restart_eps(cfg),
        max_iters=cfg.max_niter_mle, block_iters=cfg.solver_block_iters,
        dtype=dtype, seed=cfg.rng_seed if cfg.rng_seed is not None else 0,
        polish=False)
    return np.where(multi_tid[None, :] & denom_pos[None, :], extra,
                    fpkm[None, :])


def _make_rounds_dense(problem, fpkm: np.ndarray, cfg: QuantConfig, dtype,
                       part, graph, modules, eumaps, read_count
                       ) -> np.ndarray:
    """Restart rounds riding the dense batches of the main solve:
    module rows with >= 2 distinct transcripts are re-solved from
    uniform(0,100) inits, vmapped over rounds with the membership tensor
    shared; modules the main solve left to the CSR path restart there.
    Single-transcript modules have a unique maximizer — their rounds are
    exactly round 0."""
    import dataclasses as _dc

    from .dense import solve_dense_restarts, subset_batch
    from .solver import build_problem

    ntid = problem.n_transcripts
    n_extra = cfg.num_round - 1
    rounds = np.broadcast_to(fpkm, (n_extra, ntid)).copy()
    restart_eps = _restart_eps(cfg)
    seed = cfg.rng_seed if cfg.rng_seed is not None else 0
    rng = np.random.default_rng(np.uint64(0x5EED_0001) + np.uint64(seed))
    with phase("restart rounds", cfg.verbose):
        if len(part.csr_sids):
            keep_seg = np.isin(modules.cs, part.csr_sids)
            modules_csr = _dc.replace(
                modules, cs=np.where(keep_seg, modules.cs, -1))
            csr_problem = build_problem(graph, modules_csr, eumaps,
                                        read_count, dtype=np.float64)
            extra = _csr_restarts(csr_problem, fpkm, cfg, dtype)
            if extra is not None:
                touched = np.zeros(ntid, dtype=bool)
                touched[csr_problem.edge_tid] = True
                rounds[:, touched] = extra[:, touched]
        for batch in part.batches:
            multi_rows = np.flatnonzero(
                (batch.tid_map >= 0).sum(axis=1) >= 2)
            if not len(multi_rows):
                continue
            sub = subset_batch(batch, multi_rows)
            nB, _, T = sub.shape
            inits = rng.uniform(0.0, 100.0, size=(n_extra, nB, T))
            inits = np.where(sub.tid_map[None, :, :] >= 0, inits, 0.0)
            eps = (max(restart_eps, 1e-5)
                   if np.dtype(sub.eumaps.dtype) == np.float32
                   else restart_eps)
            theta = solve_dense_restarts(
                sub, inits, eps, block_iters=cfg.solver_block_iters)
            mask = sub.tid_map >= 0
            rounds[:, sub.tid_map[mask]] = theta[:, mask]
    return np.concatenate([fpkm[None, :], rounds], axis=0)


def _host_loglik(problem, theta: np.ndarray) -> float:
    s = np.zeros(len(problem.eumaps))
    np.add.at(s, problem.edge_cid,
              problem.edge_mult * theta[problem.edge_tid])
    lam = problem.eumaps * s
    m = lam > 0
    ll = float(np.sum(problem.reads[m] * np.log(lam[m]) - lam[m]))
    if ((~m) & (problem.reads > 0)).any():
        ll = -1e30
    return ll


def _solve_auto(graph, modules, eumaps, read_count, problem, cfg, dtype):
    """Dense-batched solve for small modules + CSR for the rest."""
    import dataclasses as _dc

    from .dense import partition_modules, solve_dense_batch

    part = partition_modules(graph, modules, eumaps, read_count, dtype=dtype)
    eps = max(cfg.epsilon, 1e-5) if dtype == np.float32 else cfg.epsilon
    fpkm = np.zeros(graph.n_transcripts, dtype=np.float64)
    blocks_total = 0
    for batch in part.batches:
        theta, blocks = solve_dense_batch(batch, eps,
                                          block_iters=cfg.solver_block_iters)
        blocks_total += blocks
        mask = batch.tid_map >= 0
        fpkm[batch.tid_map[mask]] = theta[mask].astype(np.float64)
    if len(part.csr_sids):
        keep = np.isin(modules.cs, part.csr_sids)
        modules_csr = _dc.replace(modules,
                                  cs=np.where(keep, modules.cs, -1))
        csr_problem = build_problem(graph, modules_csr, eumaps, read_count,
                                    dtype=np.float64)
        theta, _, blocks = solve(csr_problem, epsilon=cfg.epsilon,
                                 max_iters=cfg.max_niter_mle,
                                 block_iters=cfg.solver_block_iters,
                                 dtype=dtype)
        blocks_total += blocks
        touched = np.zeros(graph.n_transcripts, dtype=bool)
        touched[csr_problem.edge_tid] = True
        fpkm[touched] = theta.astype(np.float64)[touched]
    return fpkm, blocks_total, part


def quantify_samples_batched(index: RshIndex, counts_list, cfg: QuantConfig,
                             mesh=None):
    """Batched multisample quantification: one sharded device solve over
    the sample axis (dp) x likelihood edges (tp), per-sample EUMAps from
    per-sample fragment-length weights.

    Falls back to None (caller loops) when EUMAcut re-clustering triggers
    (module structure then depends on per-sample EUMA).  Results match the
    per-sample path at solver tolerance.
    """
    from ..parallel.mesh import make_mesh, shard_problem, solve_sharded
    from .solver import polish_host_f64

    ntid = index.n_transcripts
    S = len(counts_list)
    wfs, adjs, rcs = [], [], []
    for counts in counts_list:
        wf = compute_wf(index, counts.fraglength_counts)
        adj = np.concatenate([index.single_euma.astype(np.float64) @ wf,
                              index.multi_euma.astype(np.float64) @ wf])
        wfs.append(wf)
        adjs.append(adj)
        rcs.append(counts.readcount_per_cid())

    graph = build_segment_graph(index, adjs[0], rcs[0])
    modules = decompose_modules(graph, verbose=cfg.verbose)
    if modules.euma_cut != 0.0:
        return None  # module structure is sample-dependent; loop instead

    # active cids: in a module (union over samples of the E>0 criterion is
    # handled by zeroing reads where a sample's EUMAps is 0)
    active = modules.cs >= 0
    act_cids = np.flatnonzero(active)
    local = np.full(graph.n_cid, -1, dtype=np.int64)
    local[act_cids] = np.arange(len(act_cids))

    off = graph.ct_offsets
    sizes = np.diff(off)
    rep = np.repeat(active, sizes)
    flat_cid = np.repeat(np.arange(graph.n_cid, dtype=np.int64), sizes)[rep]
    flat_tid = graph.ct_tids[rep].astype(np.int64)
    key = flat_cid * ntid + flat_tid
    uniq, mult = np.unique(key, return_counts=True)
    e_cid = local[uniq // ntid].astype(np.int32)
    e_tid = (uniq % ntid).astype(np.int32)
    e_mult = mult.astype(np.float64)

    scale = (10.0 ** cfg.delta) / 1e9
    E_mat = np.stack([adjs[s][act_cids] *
                      (counts_list[s].total_read_count * scale)
                      for s in range(S)])
    R_mat = np.stack([rcs[s][act_cids].astype(np.float64) for s in range(S)])
    R_mat = np.where(E_mat > 0, R_mat, 0.0)  # reference skips E==0 segments
    denom_mat = np.zeros((S, ntid))
    for s in range(S):
        np.add.at(denom_mat[s], e_tid, e_mult * E_mat[s, e_cid])

    problem = SolverProblem(n_transcripts=ntid, edge_cid=e_cid,
                            edge_tid=e_tid, edge_mult=e_mult,
                            eumaps=E_mat[0], reads=R_mat[0],
                            denom=denom_mat[0])
    if mesh is None:
        mesh = make_mesh()
    dtype = _resolve_dtype(cfg)
    sp = shard_problem(problem, R_mat, mesh, dtype=dtype,
                       eumaps_per_sample=E_mat, denom_per_sample=denom_mat)
    theta, ll, blocks = solve_sharded(sp, epsilon=max(cfg.epsilon, 1e-5)
                                      if dtype == np.float32 else cfg.epsilon,
                                      block_iters=cfg.solver_block_iters)
    theta = np.asarray(theta)[:S].astype(np.float64)

    results = []
    ct_rep = np.repeat(np.arange(graph.n_cid), sizes)
    for s in range(S):
        fpkm = theta[s]
        ps = SolverProblem(n_transcripts=ntid, edge_cid=e_cid,
                           edge_tid=e_tid, edge_mult=e_mult,
                           eumaps=E_mat[s], reads=R_mat[s],
                           denom=denom_mat[s])
        if dtype == np.float32:
            fpkm = polish_host_f64(ps, fpkm, epsilon=max(cfg.epsilon, 1e-9),
                                   max_cycles=200)
        ieuma = np.zeros(ntid)
        np.add.at(ieuma, graph.ct_tids, adjs[s][ct_rep])
        fpkm_rounds = _make_rounds(ps, fpkm, cfg, dtype)
        graph_s = dataclasses.replace(graph, adj_euma=adjs[s],
                                      read_count=rcs[s])
        results.append(QuantResult(
            fpkm=fpkm, fpkm_rounds=fpkm_rounds, ieuma=ieuma,
            adj_euma=adjs[s], wf=wfs[s], graph=graph_s, modules=modules,
            total_read_count=counts_list[s].total_read_count,
            loglik=float(ll), em_blocks=blocks))
    return results
