"""Sharded EM must match the single-device solver on an 8-device CPU mesh."""

import numpy as np

from emsar_jax.model.modules import build_segment_graph, decompose_modules
from emsar_jax.model.solver import build_problem, solve
from emsar_jax.parallel.mesh import make_mesh, shard_problem, solve_sharded
from emsar_jax.config import BuildConfig
from emsar_jax.index.build import build_se_index
from emsar_jax.io.fasta import build_transcriptome
from tests.util import random_transcriptome


def _toy_problem(seed=0, n=40):
    rng = np.random.default_rng(seed)
    names, seqs = random_transcriptome(rng, n, min_len=60, max_len=300,
                                       shared_frac=0.6)
    tx = build_transcriptome(names, seqs)
    idx = build_se_index(tx, 20, 20, BuildConfig(verbose=0))
    # synthetic counts proportional to EUMA + noise
    adj = np.concatenate([idx.single_euma[:, 0], idx.multi_euma[:, 0]]) \
        .astype(np.float64)
    rc = rng.poisson(adj * 2.0).astype(np.int64)
    total = int(rc.sum())
    graph = build_segment_graph(idx, adj, rc)
    modules = decompose_modules(graph)
    eumaps = adj / 1e3 * (total / 1e6)
    problem = build_problem(graph, modules, eumaps, rc)
    return problem, rc


def test_sharded_solver_matches_single(tmp_path):
    problem, rc = _toy_problem()
    fpkm, ll, _ = solve(problem, epsilon=1e-12)

    for dp in (1, 2, 8):
        mesh = make_mesh(8, dp=dp)
        reads = problem.reads[None, :].astype(np.float64)
        if dp > 1:
            reads = np.repeat(reads, dp, axis=0)  # identical samples per shard
        sp = shard_problem(problem, reads, mesh, dtype=np.float64)
        theta, ll_s, _ = solve_sharded(sp, epsilon=1e-12)
        for s in range(reads.shape[0]):
            np.testing.assert_allclose(theta[s], fpkm, rtol=1e-8, atol=1e-8)


def test_transcript_sharded_matches_single():
    """shard_by='transcript': theta/denom shard over tp ([S, Tp/tp] per
    device) and results match the single-device solver exactly."""
    problem, rc = _toy_problem(seed=3)
    fpkm, ll, _ = solve(problem, epsilon=1e-12)

    for dp in (1, 2):
        mesh = make_mesh(8, dp=dp)
        tp = 8 // dp
        reads = np.repeat(problem.reads[None, :].astype(np.float64), dp,
                          axis=0)
        sp = shard_problem(problem, reads, mesh, dtype=np.float64,
                           shard_by="transcript")
        assert sp.layout == "transcript"
        # per-device theta/denom memory actually shards tp-fold
        Tp = sp.t_padded
        assert Tp % tp == 0 and Tp >= problem.n_transcripts
        shard_shapes = {s.data.shape for s in sp.denom.addressable_shards}
        assert shard_shapes == {(reads.shape[0] // dp
                                 if dp > 1 else reads.shape[0], Tp // tp)}
        theta, ll_s, _ = solve_sharded(sp, epsilon=1e-12)
        assert theta.shape[1] == problem.n_transcripts
        for s in range(reads.shape[0]):
            np.testing.assert_allclose(theta[s], fpkm, rtol=1e-8, atol=1e-8)
        assert abs(ll_s - ll * dp) <= 1e-6 * abs(ll) * dp


def test_multisample_sharded_independent():
    """Different samples on the dp axis are solved independently: each
    reaches the same optimum as its own single-device solve (coordinates
    may differ along non-identifiable collinear directions, so compare
    segment intensities and likelihood)."""
    problem, rc = _toy_problem(seed=1)
    rng = np.random.default_rng(2)
    S = 4
    reads = np.stack([rng.permutation(problem.reads) for _ in range(S)])
    mesh = make_mesh(8, dp=4)
    sp = shard_problem(problem, reads, mesh, dtype=np.float64)
    theta, _, _ = solve_sharded(sp, epsilon=1e-12)

    def seg_intensity(th):
        s = np.zeros(len(problem.eumaps))
        np.add.at(s, problem.edge_cid,
                  problem.edge_mult * th[problem.edge_tid])
        return s

    def loglik(th, R):
        lam = problem.eumaps * seg_intensity(th)
        m = lam > 0
        assert not ((~m) & (R > 0)).any()
        return float(np.sum(R[m] * np.log(lam[m]) - lam[m]))

    for s in range(S):
        p1 = type(problem)(**{**problem.__dict__, "reads": reads[s]})
        f1, _, _ = solve(p1, epsilon=1e-12)
        ll_ref = loglik(f1, reads[s])
        ll_sh = loglik(theta[s], reads[s])
        assert abs(ll_sh - ll_ref) <= 1e-8 * abs(ll_ref), (ll_sh, ll_ref)
        # quasi-flat curvature directions leave tiny intensity wiggle at
        # any finite tolerance; require loose agreement only
        np.testing.assert_allclose(seg_intensity(theta[s]),
                                   seg_intensity(f1), rtol=2e-3, atol=1e-2)
