"""The dense-batched module solver must match the CSR solver, in float64
and in float32, and its batch padding must be inert."""

import numpy as np
import pytest

from emsar_jax.model import dense
from emsar_jax.model.dense import (partition_modules, solve_dense_batch,
                                   SIZE_CLASSES)
from emsar_jax.model.modules import build_segment_graph, decompose_modules
from emsar_jax.model.solver import build_problem, solve
from emsar_jax.config import BuildConfig
from emsar_jax.index.build import build_se_index
from emsar_jax.io.fasta import build_transcriptome
from emsar_jax.sim import gene_family_transcriptome
from tests.util import random_transcriptome


def _problem(seed=0, gene_family=True):
    rng = np.random.default_rng(seed)
    if gene_family:
        names, seqs, _ = gene_family_transcriptome(rng, 25, n_exons=6,
                                                   min_exon=40, max_exon=150)
    else:
        names, seqs = random_transcriptome(rng, 50, shared_frac=0.6)
    tx = build_transcriptome(names, seqs)
    idx = build_se_index(tx, 20, 20, BuildConfig(verbose=0))
    adj = np.concatenate([idx.single_euma[:, 0],
                          idx.multi_euma[:, 0]]).astype(np.float64)
    rc = rng.poisson(adj * 1.5).astype(np.int64)
    total = max(int(rc.sum()), 1)
    graph = build_segment_graph(idx, adj, rc)
    modules = decompose_modules(graph)
    eumaps = adj / 1e3 * (total / 1e6)
    return graph, modules, eumaps, rc


def _fpkm_dense(graph, modules, eumaps, rc, dtype=np.float64):
    part = partition_modules(graph, modules, eumaps, rc, dtype=dtype)
    assert part.batches, "expected at least one dense batch"
    fpkm = np.zeros(graph.n_transcripts)
    for batch in part.batches:
        theta, _ = solve_dense_batch(batch, 1e-12)
        mask = batch.tid_map >= 0
        fpkm[batch.tid_map[mask]] = theta[mask]
    return fpkm, part


def _loglik(problem, theta):
    s = np.zeros(len(problem.eumaps))
    np.add.at(s, problem.edge_cid,
              problem.edge_mult * theta[problem.edge_tid])
    lam = problem.eumaps * s
    m = lam > 0
    assert not ((~m) & (problem.reads > 0)).any()
    return float(np.sum(problem.reads[m] * np.log(lam[m]) - lam[m]))


def test_dense_matches_csr():
    """Same maximizer quality: the dense and CSR solvers must reach the
    same optimum (theta may differ along non-identifiable collinear
    directions, so compare the likelihood, not coordinates)."""
    graph, modules, eumaps, rc = _problem()
    problem = build_problem(graph, modules, eumaps, rc)
    ref, _, _ = solve(problem, epsilon=1e-12)
    fpkm, part = _fpkm_dense(graph, modules, eumaps, rc)
    # merge: CSR covers any modules the dense classes didn't
    covered = np.zeros(graph.n_transcripts, dtype=bool)
    for b in part.batches:
        covered[b.tid_map[b.tid_map >= 0]] = True
    merged = np.where(covered, fpkm, ref)
    ll_ref = _loglik(problem, ref)
    ll_dense = _loglik(problem, merged)
    assert ll_dense >= ll_ref - 1e-6 * abs(ll_ref), (ll_dense, ll_ref)
    # identifiable quantity: expected reads per segment must agree
    def seg_intensity(th):
        s = np.zeros(len(problem.eumaps))
        np.add.at(s, problem.edge_cid,
                  problem.edge_mult * th[problem.edge_tid])
        return problem.eumaps * s
    np.testing.assert_allclose(seg_intensity(merged), seg_intensity(ref),
                               rtol=1e-4, atol=1e-6)


def test_float32_dense_matches_float64():
    """The float32 dense path (the default on a GPU) reaches the float64
    optimum within float32's resolution: compare likelihood and the
    identifiable segment intensities, not collinear coordinates."""
    graph, modules, eumaps, rc = _problem(seed=1)
    problem = build_problem(graph, modules, eumaps, rc)
    f64, _ = _fpkm_dense(graph, modules, eumaps, rc)
    f32, _ = _fpkm_dense(graph, modules, eumaps, rc, dtype=np.float32)
    ll64 = _loglik(problem, f64)
    ll32 = _loglik(problem, f32)
    assert abs(ll32 - ll64) <= 1e-5 * abs(ll64)

    def seg_intensity(th):
        s = np.zeros(len(problem.eumaps))
        np.add.at(s, problem.edge_cid,
                  problem.edge_mult * th[problem.edge_tid])
        return problem.eumaps * s
    np.testing.assert_allclose(seg_intensity(f32), seg_intensity(f64),
                               rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("b", [1, 7, 8, 9, 63, 64, 65, 100, 1000, 4097,
                               123457])
def test_quantize_b_shapes(b):
    """Batch sizes round up to a multiple of an eighth of their next power
    of two: never below b or 8, a multiple of 8, and padded by less than
    that eighth."""
    q = dense._quantize_b(b)
    assert q >= b and q >= 8 and q % 8 == 0
    assert q - b < max((1 << (b - 1).bit_length()) // 8, 8)
    assert dense._quantize_b(q) == q  # idempotent: padded sizes are fixed


def test_quantize_b_shape_count_per_octave():
    sizes = {dense._quantize_b(b) for b in range(1025, 2049)}
    assert sizes == {1280, 1536, 1792, 2048}


def test_pad_b_rows_are_inert():
    """Padding adds rows with no incidences and E = R = 0; solving the
    padded batch gives the unpadded rows exactly what the unpadded solve
    gives, and the padded rows stay 0."""
    import jax.numpy as jnp

    graph, modules, eumaps, rc = _problem(seed=4)
    part = partition_modules(graph, modules, eumaps, rc, dtype=np.float64)
    batch = next(b for b in part.batches
                 if dense._quantize_b(b.shape[0]) != b.shape[0])
    padded, B0 = dense._pad_b(batch)
    B, C, T = padded.shape
    assert B0 == batch.shape[0] and B == dense._quantize_b(B0)
    assert (C, T) == batch.shape[1:]
    np.testing.assert_array_equal(padded.flat_idx, batch.flat_idx)
    assert not padded.eumaps[B0:].any() and not padded.reads[B0:].any()
    assert (padded.tid_map[B0:] == -1).all() and (padded.sids[B0:] == -1).all()

    def run(bt):
        th, _ = dense._dense_solve_jax(
            jnp.asarray(bt.flat_idx), jnp.asarray(bt.eumaps),
            jnp.asarray(bt.reads), jnp.asarray(1e-12), *bt.shape, 8, 2048)
        return np.asarray(th)

    th_pad, th_raw = run(padded), run(batch)
    assert not th_pad[B0:].any()
    # values below 1e-12 of the largest are converged zeros whose last
    # iterate depends on the row count through reduction order
    atol = 1e-12 * float(np.abs(th_raw).max())
    np.testing.assert_allclose(th_pad[:B0], th_raw, rtol=1e-12, atol=atol)
    theta, _ = solve_dense_batch(batch, 1e-12)
    assert theta.shape == (B0, T)
    np.testing.assert_allclose(theta, th_raw, rtol=1e-12, atol=atol)


def test_quantify_auto_mode_matches_csr():
    from emsar_jax.config import QuantConfig
    from emsar_jax.model.quantify import quantify_sample
    from emsar_jax.ingest.collapse import SampleCounts
    graph, modules, eumaps, rc = _problem(seed=2)
    # fabricate an index-shaped SampleCounts through the pipeline instead:
    # run quantify_sample twice with different solver modes
    rng = np.random.default_rng(3)
    names, seqs, _ = gene_family_transcriptome(rng, 20, n_exons=5,
                                               min_exon=40, max_exon=120)
    tx = build_transcriptome(names, seqs)
    idx = build_se_index(tx, 20, 20, BuildConfig(verbose=0))
    adj = np.concatenate([idx.single_euma[:, 0], idx.multi_euma[:, 0]])
    counts = SampleCounts(
        single_counts=rng.poisson(np.maximum(idx.single_euma[:, 0], 0) * 2.0),
        multi_counts=rng.poisson(np.maximum(idx.multi_euma[:, 0], 0) * 2.0),
        fraglength_counts=np.bincount([20], minlength=401) * 1000,
        total_read_count=1000)
    cfg_csr = QuantConfig(verbose=0, solver_mode="csr")
    cfg_auto = QuantConfig(verbose=0, solver_mode="auto")
    r1 = quantify_sample(idx, counts, cfg_csr)
    r2 = quantify_sample(idx, counts, cfg_auto)
    # same optimum (theta can differ along collinear isoform directions)
    assert abs(r2.loglik - r1.loglik) <= 1e-6 * abs(r1.loglik)
    # identifiable totals agree
    irc1 = (r1.ieuma / 1e3) * r1.fpkm
    irc2 = (r2.ieuma / 1e3) * r2.fpkm
    np.testing.assert_allclose(irc2.sum(), irc1.sum(), rtol=1e-8)
