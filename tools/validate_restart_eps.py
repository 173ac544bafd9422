"""Validate the restart-round epsilon floor on additional workload shapes.

Round-2 advisor item 3: the 1e-3 restart epsilon (quantify._restart_eps)
was justified only on the 12k-transcript SE bench workload.  This tool
repeats the sd-distribution comparison (eps 1e-3 vs 1e-4) on:

* the PE bench workload (7.3k transcripts, BAM pairs), and
* a collinear-heavy fixture (every gene a pair of identical-sequence
  transcripts — the maximal flat-manifold regime that drives sd).

The sd column reports spread across random-restart maximizer points; if
tightening eps by 10x leaves the sd distribution statistically unchanged,
the looser default costs nothing.  Results go into BASELINE_MEASURED.md.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
if os.environ.get("EMSAR_EPS_CPU"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
else:
    from emsar_jax.utils import jitcache
    jitcache.enable()

from emsar_jax.config import QuantConfig, StrandType  # noqa: E402
from emsar_jax.io.rsh import RshIndex  # noqa: E402
from emsar_jax.ingest import native as native_mod  # noqa: E402
from emsar_jax.model import quantify as Q  # noqa: E402

CACHE = os.path.join(REPO, "bench_cache")


def sd_stats(fpkm_rounds):
    num_round = fpkm_rounds.shape[0]
    mean = fpkm_rounds.mean(axis=0)
    sd = np.sqrt(((fpkm_rounds - mean) ** 2).sum(axis=0)
                 / (num_round - 1)) / num_round
    return dict(n_gt1=int((sd > 1).sum()), mean=float(sd.mean()),
                max=float(sd.max()), n_gt01=int((sd > 0.1).sum()))


def run_workload(name, index, counts, pe):
    import time
    for eps in (1e-3, 1e-4):
        cfg = QuantConfig(verbose=0, pe=pe)
        cfg.strand = StrandType.parse("ns", pe)
        cfg.solver_dtype = ("float64"
                           if jax.devices()[0].platform == "cpu"
                           else "float32")
        cfg.min_fraglength = index.min_fraglength
        cfg.max_fraglength = index.max_fraglength
        orig = Q._restart_eps
        Q._restart_eps = lambda _cfg: eps
        try:
            t0 = time.perf_counter()
            r = Q.quantify_sample(index, counts, cfg)
            dt = time.perf_counter() - t0
        finally:
            Q._restart_eps = orig
        print(f"{name} eps={eps:g}: sd stats {sd_stats(r.fpkm_rounds)} "
              f"({dt:.2f}s)", flush=True)


def main():
    # PE bench workload
    cfg = QuantConfig(verbose=0, pe=True)
    index = RshIndex.load(os.path.join(CACHE, "benchpe.rsh"))
    nc = native_mod.NativeCollapser(index)
    counts = nc.collapse_file(os.path.join(CACHE, "benchpe.bam"), "bam",
                              True, 0, cfg.max_repeat,
                              index.min_fraglength, index.max_fraglength,
                              [index.readlength])
    run_workload("PE bench", index, counts, True)

    # collinear-heavy fixture: 400 genes, each two identical transcripts
    import subprocess
    import tempfile
    from tests.util import write_fasta
    from emsar_jax.io.fasta import build_transcriptome
    from emsar_jax.index.build import build_se_index
    from emsar_jax.config import BuildConfig
    from emsar_jax.sim import simulate_fragments

    rng = np.random.default_rng(99)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    names, seqs = [], []
    for g in range(400):
        s = bases[rng.integers(0, 4, size=600)].tobytes()
        for i in range(2):
            names.append(f"G{g:04d}T{i}")
            seqs.append(s)
    tx = build_transcriptome(names, seqs)
    bcfg = BuildConfig(verbose=0)
    bcfg.strand = StrandType.parse("ns", False)
    idx = build_se_index(tx, 50, 50, bcfg)
    tmp = tempfile.mkdtemp()
    rshp = os.path.join(tmp, "col.rsh")
    idx.write_text(rshp)
    # simulate reads: every read maps to both copies of its gene
    frag = simulate_fragments(tx, 50, 200_000, rng)
    aln = os.path.join(tmp, "col.bowtieout")
    seqstr = "A" * 50
    cuml = tx.cuml
    with open(aln, "w", buffering=1 << 20) as fh:
        for i, p in enumerate(frag):
            fw = p if p < tx.borderpos else tx.seqlength - p - 50
            t = int(np.searchsorted(cuml, fw, side="right")) - 1
            q = fw - cuml[t]
            base_t = t - (t % 2)
            for tt in (base_t, base_t + 1):
                fh.write(f"r{i}\t+\t{names[tt]}\t{q}\t{seqstr}\tI\t0\t\n")
    index2 = RshIndex.read_text(rshp)
    nc2 = native_mod.NativeCollapser(index2)
    counts2 = nc2.collapse_file(aln, "bowtie", False, 0, 100,
                                index2.min_fraglength,
                                index2.max_fraglength, None)
    run_workload("collinear SE", index2, counts2, False)


if __name__ == "__main__":
    main()
