"""Human-transcriptome-scale index-build demonstration.

Generates a ~190 Mbp / ~150k-transcript gene-family transcriptome (the
scale of human cDNA), builds the SE rsh index with the reference binary
and with the prefix-partitioned device builder, byte-compares the
outputs, and reports wall times.

Usage:  python tools/human_scale_build.py [--genes N] [--readlength L]
        [--cpu] [--skip-ref]

The fixture and the reference build are cached under bench_cache/ so the
expensive parts run once; compiled kernels persist in the compile cache
(emsar_jax/utils/jitcache.py).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CACHE = os.path.join(REPO, "bench_cache")
REF_BUILD = "/root/reference/src/emsar-build"


def log(msg):
    print(f"[human-scale] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genes", type=int, default=25000)
    ap.add_argument("--readlength", type=int, default=76)
    ap.add_argument("--pe", action="store_true",
                    help="paired-end build (readlength is the mate length)")
    ap.add_argument("--fmin", type=int, default=290)
    ap.add_argument("--fmax", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip-ref", action="store_true",
                    help="skip the reference build/diff (timing only)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from emsar_jax.utils import jitcache
    jitcache.enable()
    log(f"jax platform: {jax.devices()[0].platform}")

    tag = f"human{args.genes}"
    fasta = os.path.join(CACHE, f"{tag}.fa")
    if not os.path.exists(fasta):
        from emsar_jax.sim import gene_family_transcriptome
        from tests.util import write_fasta
        log(f"generating {args.genes}-gene transcriptome...")
        rng = np.random.default_rng(99)
        names, seqs, _ = gene_family_transcriptome(rng, args.genes)
        log(f"{len(names)} transcripts, "
            f"{sum(len(s) for s in seqs) / 1e6:.0f} Mbp")
        write_fasta(fasta, names, seqs)

    from emsar_jax.io.fasta import read_fasta
    log("reading fasta...")
    tx = read_fasta(fasta, "E")
    log(f"{tx.n_transcripts} transcripts, seq_array {tx.seqlength / 1e6:.0f}"
        f" M chars ({tx.borderpos / 1e6:.0f} M fw)")

    rl = args.readlength
    mode = f"pe.l{rl}.F{args.fmin}-{args.fmax}" if args.pe else f"l{rl}"
    ref_rsh = os.path.join(CACHE, f"{tag}.{mode}.ref.rsh")
    t_ref = None
    if not args.skip_ref:
        if not os.path.exists(ref_rsh):
            log(f"reference emsar-build {mode} (single run, cached)...")
            refcmd = [REF_BUILD, "-q"]
            if args.pe:
                refcmd += ["--PE", "-f", str(args.fmin), "-F",
                           str(args.fmax)]
            refcmd += [fasta, str(rl), CACHE, f"{tag}.{mode}.ref"]
            t0 = time.perf_counter()
            subprocess.run(refcmd, check=True)
            t_ref = time.perf_counter() - t0
            with open(ref_rsh + ".time", "w") as fh:
                fh.write(f"{t_ref:.2f}\n")
            log(f"reference build: {t_ref:.1f}s")
        else:
            with open(ref_rsh + ".time") as fh:
                t_ref = float(fh.read().strip())
            log(f"reference build (cached): {t_ref:.1f}s")

    from emsar_jax.config import BuildConfig, StrandType
    from emsar_jax.index.build import build_pe_index, build_se_index
    log(f"device build {mode} starting...")
    t0 = time.perf_counter()
    if args.pe:
        cfg = BuildConfig(verbose=2, pe=True, min_fraglength=args.fmin,
                          max_fraglength=args.fmax)
        cfg.strand = StrandType.parse("ns", True)
        idx = build_pe_index(tx, rl, cfg)
    else:
        cfg = BuildConfig(verbose=2)
        cfg.strand = StrandType.parse("ns", False)
        idx = build_se_index(tx, rl, rl, cfg)
    t_ours = time.perf_counter() - t0
    log(f"device build: {t_ours:.1f}s")

    ours_rsh = os.path.join(CACHE, f"{tag}.{mode}.ours.rsh")
    t0 = time.perf_counter()
    idx.write_text(ours_rsh)
    log(f"write .rsh: {time.perf_counter() - t0:.1f}s")

    if not args.skip_ref:
        same = open(ours_rsh, "rb").read() == open(ref_rsh, "rb").read()
        log(f"byte-identical: {same}")
        print(f"RESULT ref={t_ref:.1f}s ours={t_ours:.1f}s "
              f"identical={same}")
        if not same:
            raise SystemExit(1)
    else:
        print(f"RESULT ours={t_ours:.1f}s (reference skipped)")


if __name__ == "__main__":
    main()
