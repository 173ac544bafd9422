"""Property tests of the quantification model (SURVEY §4: the reference has
no tests; these pin model invariants independent of the golden oracle)."""

import numpy as np

from emsar_jax.config import BuildConfig, QuantConfig, StrandType
from emsar_jax.index.build import build_se_index
from emsar_jax.ingest.collapse import ReadCollapser, group_alignments
from emsar_jax.io.fasta import build_transcriptome
from emsar_jax.model.quantify import quantify_sample
from emsar_jax.sim import gene_family_transcriptome, simulate_fragments
from tests.util import random_transcriptome


def _quantify_fixture(seed, n=30, rl=20, n_reads=4000, gene_family=False):
    rng = np.random.default_rng(seed)
    if gene_family:
        names, seqs, _ = gene_family_transcriptome(rng, n // 4, n_exons=5,
                                                   min_exon=40, max_exon=120)
    else:
        names, seqs = random_transcriptome(rng, n, min_len=60, max_len=300,
                                           shared_frac=0.5)
    tx = build_transcriptome(names, seqs)
    idx = build_se_index(tx, rl, rl, BuildConfig(verbose=0))
    pos = simulate_fragments(tx, rl, n_reads, rng)

    # alignments straight from the canonical index grouping: every read's
    # signature exists in the index by construction
    collapser = ReadCollapser(idx, 1, 400, 100, pe=False)

    def stream():
        # brute-force alignment of each read against all transcripts
        from tests.aligner import align_se
        seq = tx.seq.tobytes()
        for i, p in enumerate(pos):
            read = seq[p:p + rl]
            for strand, tname, q in align_se(read, names, seqs):
                yield f"r{i}", (tx.name_to_tid[tname], 0, rl, q)

    collapser.consume(group_alignments(stream()))
    counts = collapser.finish()
    cfg = QuantConfig(verbose=0)
    cfg.strand = StrandType.parse("ns", False)
    result = quantify_sample(idx, counts, cfg)
    return idx, counts, result


def test_tpm_sums_to_1e6():
    idx, counts, result = _quantify_fixture(seed=90)
    mean = result.fpkm
    tpm = mean * 1e6 / mean.sum()
    assert abs(tpm.sum() - 1e6) < 1e-3


def test_total_inferred_readcount_matches_total():
    """sum(iReadcount) == TotalReadCount when every counted read's
    signature is in the index and no segments are EUMA-cut.  (At the ML
    optimum, sum_c lambda_c == sum_c R_c.)"""
    idx, counts, result = _quantify_fixture(seed=91, gene_family=True)
    ireadcount = (result.ieuma / 1e3) * result.fpkm \
        * (counts.total_read_count / 1e6)
    counted = counts.single_counts.sum() + counts.multi_counts.sum()
    # reads whose signature is missing from the index are not in `counted`
    assert abs(ireadcount.sum() - counted) / max(counted, 1) < 1e-6


def test_fpkm_nonnegative_and_finite():
    _, _, result = _quantify_fixture(seed=92, gene_family=True)
    assert np.isfinite(result.fpkm).all()
    assert (result.fpkm >= 0).all()


def test_scale_invariance_in_total_reads():
    """Doubling every count doubles FPKM-per-read consistently: TPM is
    invariant."""
    idx, counts, result = _quantify_fixture(seed=93)
    import dataclasses
    cfg = QuantConfig(verbose=0)
    doubled = dataclasses.replace(
        counts, single_counts=counts.single_counts * 2,
        multi_counts=counts.multi_counts * 2,
        fraglength_counts=counts.fraglength_counts * 2,
        total_read_count=counts.total_read_count * 2)
    r2 = quantify_sample(idx, doubled, cfg)
    tpm1 = result.fpkm / max(result.fpkm.sum(), 1e-30)
    tpm2 = r2.fpkm / max(r2.fpkm.sum(), 1e-30)
    np.testing.assert_allclose(tpm1, tpm2, rtol=1e-6, atol=1e-9)
