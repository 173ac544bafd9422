"""emsar_jax — EMSAR transcript-abundance estimation in JAX.

A from-scratch rebuild of the capabilities of EMSAR (Lee et al., BMC
Bioinformatics 16:278; reference C implementation at parklab/emsar):

* ``emsar-build`` — construct an rsh ("read-sharing") index from a
  transcriptome FASTA: for every possible read (SE) or fragment (PE), the
  exact multiset of transcript occurrences sharing that sequence, and the
  per-(signature, fragment-length) count of distinct shared sequences
  (EUMA, "effectively unique mappable area").
* ``emsar`` — stream alignments (bowtie text / SAM / BAM), collapse each
  read's alignment set into a mapping signature, match signatures against
  the rsh index, decompose transcripts into disjoint sequence-sharing
  modules, and maximize the per-module Poisson likelihood to produce
  per-transcript FPKM / TPM / inferred read counts.

Architecture (device-first, not a port):

* reference model + I/O: host-side NumPy (``emsar_jax.io``)
* index construction: 2-bit packed windows as multi-word integer sort keys,
  ``jax.lax.sort`` + run-boundary detection on device (``emsar_jax.index``)
* quantification: global edge-list EM on the identical Poisson objective,
  jitted ``lax.while_loop`` with segment-sums / matmuls on device
  (``emsar_jax.model``)
* distribution: ``jax.sharding.Mesh`` + shard_map with psum-merged
  sufficient statistics (``emsar_jax.parallel``)
"""

__version__ = "0.1.0"
