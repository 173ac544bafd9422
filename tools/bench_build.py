"""Index-build wall-time benchmark vs the reference emsar-build binary.

Usage: python tools/bench_build.py [pe|se] [--reps N]
Runs on whatever JAX platform the environment provides; uses the
persistent compile cache (emsar_jax/utils/jitcache.py).
"""
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CACHE = os.path.join(REPO, "bench_cache")

import numpy as np


def log(m):
    print(f"[bench_build] {m}", flush=True)


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "pe"
    reps = 2
    import jax
    from emsar_jax.utils import jitcache
    jitcache.enable()
    log(f"platform: {jax.devices()}")

    from emsar_jax.config import BuildConfig, StrandType
    from emsar_jax.io.fasta import read_fasta
    from emsar_jax.index.build import build_pe_index, build_se_index
    from emsar_jax.sim import gene_family_transcriptome
    from tests.util import write_fasta
    from emsar_jax.utils import timing

    if mode == "pe":
        fasta = os.path.join(CACHE, "pe400.fa")
        if not os.path.exists(fasta):
            rng = np.random.default_rng(4242)
            names, seqs, _ = gene_family_transcriptome(rng, 400)
            write_fasta(fasta, names, seqs)
        ref_rsh = os.path.join(CACHE, "pe400ref.rsh")
        if not os.path.exists(ref_rsh):
            t0 = time.time()
            subprocess.run(["/root/reference/src/emsar-build", "-q", "--PE",
                            "-F", "300", "-f", "250", fasta, "76", CACHE,
                            "pe400ref"], check=True)
            log(f"reference PE build: {time.time()-t0:.1f}s")
        tx = read_fasta(fasta)
        cfg = BuildConfig(pe=True, strand=StrandType.parse("ns", True),
                          min_fraglength=250, max_fraglength=300, verbose=1)
        for rep in range(reps):
            timing.reset_phases()
            t0 = time.time()
            idx = build_pe_index(tx, 76, cfg, backend="device")
            dt = time.time() - t0
            log(f"ours PE build rep{rep}: {dt:.1f}s  phases: " + ", ".join(
                f"{k}={v:.2f}" for k, v in timing.phase_times().items()))
        ours = os.path.join(CACHE, "pe400ours.rsh")
        idx.write_text(ours)
        same = open(ours, "rb").read() == open(ref_rsh, "rb").read()
        log(f"byte-identical to reference: {same}")
    else:
        fasta = os.path.join(CACHE, "bench.fa")
        if not os.path.exists(fasta):
            rng = np.random.default_rng(1234)
            names, seqs, _ = gene_family_transcriptome(rng, 2000)
            write_fasta(fasta, names, seqs)
        ref_rsh = os.path.join(CACHE, "seref.rsh")
        if not os.path.exists(ref_rsh):
            t0 = time.time()
            subprocess.run(["/root/reference/src/emsar-build", "-q", fasta,
                            "50", CACHE, "seref"], check=True)
            log(f"reference SE build: {time.time()-t0:.1f}s")
        tx = read_fasta(fasta)
        cfg = BuildConfig(verbose=1)
        for rep in range(reps):
            timing.reset_phases()
            t0 = time.time()
            idx = build_se_index(tx, 50, 50, cfg, backend="device")
            dt = time.time() - t0
            log(f"ours SE build rep{rep}: {dt:.1f}s  phases: " + ", ".join(
                f"{k}={v:.2f}" for k, v in timing.phase_times().items()))
        ours = os.path.join(CACHE, "seours.rsh")
        idx.write_text(ours)
        same = open(ours, "rb").read() == open(ref_rsh, "rb").read()
        log(f"byte-identical to reference: {same}")


if __name__ == "__main__":
    main()
