"""Generate the human-transcriptome-scale build fixture.

Human cDNA is ~350 Mbp over ~150-200k transcripts (BASELINE.json configs
3-4); this synthesizes a gene-family transcriptome of comparable size and
sharing structure (exon/isoform subsets, the regime that populates
multi-transcript signatures) so the device builder can be validated
byte-for-byte against the reference binary at that scale.

Usage: python tools/make_scale_fixture.py [n_genes] [out.fa]
Defaults: 42000 genes (~150k tx / ~300 Mbp), bench_cache/scale.fa.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from emsar_jax.sim import gene_family_transcriptome  # noqa: E402


SEED = 20260820


def write_fixture(n_genes: int, out: str, seed: int = SEED):
    """Write the fixture FASTA; returns (n_transcripts, total_bases).
    Genes are drawn in order from one stream, so a smaller ``n_genes``
    gives a prefix (a slab) of a larger fixture with the same seed."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    rng = np.random.default_rng(seed)
    names, seqs, _ = gene_family_transcriptome(
        rng, n_genes, min_isoforms=2, max_isoforms=6, n_exons=10,
        min_exon=120, max_exon=500)
    total = sum(len(s) for s in seqs)
    with open(out, "w", buffering=1 << 22) as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n}\n{s.decode('latin-1')}\n")
    return len(names), total


def main():
    n_genes = int(sys.argv[1]) if len(sys.argv) > 1 else 42000
    out = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        REPO, "bench_cache", "scale.fa")
    n_tx, total = write_fixture(n_genes, out)
    print(f"{out}: {n_tx} transcripts, {total/1e6:.1f} Mbp")


if __name__ == "__main__":
    main()
