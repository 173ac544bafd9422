"""Simulate human-scale SE bowtie-format alignments over the scale fixture.

The scale transcriptome (tools/make_scale_fixture.py) is exon/isoform
structured: every transcript of a gene is an ordered subset of the gene's
exon pool.  Exons are long random sequences (>= readlength), so a read's
exact-match alignment set is fully determined by the exon structure:

* a read inside one exon matches every isoform keeping that exon,
* a read spanning the junction between consecutive kept exons (e, f)
  matches isoforms keeping e and f with every exon between them dropped.

That is the transcriptome-wide exact-match set up to one caveat: a
junction read with a k-byte overhang into one of its exons can, with
probability 4^-k, also match a different junction whose exon tail
coincides on those k bytes — measured ~0.1% of reads miss such a
chance match.  The file remains a valid exact-aligner output (every
listed alignment is a true exact match) and both quantifiers consume
the identical file, so the comparison stays apples-to-apples — the
realistic multi-alignment regime the reference streams
(read_bowtie_SE, /root/reference/src/emsar_functions.c:707-768).  The
sequence column is a constant spacer: the quantifiers consume only its
length (:568).

Usage: python tools/make_scale_reads.py [n_genes] [n_reads] [rl] [out]
Defaults: 42000 genes (must match make_scale_fixture), 3M reads, l76,
bench_cache/scale_reads.bowtieout.  The gene structure is re-derived
from make_scale_fixture's seed by replaying its RNG draws, so the
337 Mbp fasta never needs to be parsed here.
"""
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_EXONS = 10


def build_structure(n_genes, seed=20260820):
    """Replays gene_family_transcriptome's RNG draws (sim.py), keeping
    only the structure (exon lengths + keep masks) — no sequences."""
    rng = np.random.default_rng(seed)
    min_exon, max_exon = 120, 500
    min_iso, max_iso = 2, 6
    names, gene_of, exon_lens, keeps = [], [], [], []
    for g in range(n_genes):
        lens = rng.integers(min_exon, max_exon + 1, size=N_EXONS)
        for L in lens:
            rng.integers(0, 4, size=int(L))  # burn the sequence draws
        k = int(rng.integers(min_iso, max_iso + 1))
        for i in range(k):
            keep = rng.random(N_EXONS) < rng.uniform(0.4, 0.9)
            if not keep.any():
                keep[int(rng.integers(0, N_EXONS))] = True
            names.append(f"G{g:05d}T{i}")
            gene_of.append(g)
            exon_lens.append(lens)
            keeps.append(keep)
    return names, np.asarray(gene_of), np.asarray(exon_lens), \
        np.asarray(keeps)


def main():
    n_genes = int(sys.argv[1]) if len(sys.argv) > 1 else 42000
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 3_000_000
    rl = int(sys.argv[3]) if len(sys.argv) > 3 else 76
    out = sys.argv[4] if len(sys.argv) > 4 else os.path.join(
        REPO, "bench_cache", "scale_reads.bowtieout")
    write_reads(n_genes, n_reads, rl, out)


def write_reads(n_genes, n_reads, rl, out, seed=7):
    """Write ``n_reads`` SE reads (bowtie format) drawn with ``seed``."""
    t0 = time.time()
    names, gene_of, exon_lens, keeps = build_structure(n_genes)
    ntx = len(names)
    print(f"structure: {ntx} transcripts ({time.time()-t0:.1f}s)",
          flush=True)

    kept_lens = np.where(keeps, exon_lens, 0)
    tx_len = kept_lens.sum(axis=1)
    cum = np.cumsum(kept_lens, axis=1)      # kept length through slot e
    pre = cum - kept_lens                   # start of slot e in transcript
    gstart = np.concatenate([[0], np.flatnonzero(np.diff(gene_of)) + 1,
                             [ntx]])
    bits = (keeps.astype(np.uint16)
            << np.arange(N_EXONS, dtype=np.uint16)).sum(axis=1)
    # next kept slot after e, per transcript (-1 = none)
    nxt_kept = np.full((ntx, N_EXONS), -1, dtype=np.int64)
    for e in range(N_EXONS - 1):
        later = keeps[:, e + 1:]
        has = later.any(axis=1)
        nxt_kept[:, e] = np.where(has, e + 1 + np.argmax(later, axis=1), -1)
    between = np.zeros((N_EXONS, N_EXONS), dtype=np.uint16)
    for e in range(N_EXONS):
        for f in range(e + 1, N_EXONS):
            for x in range(e + 1, f):
                between[e, f] |= np.uint16(1 << x)

    rng = np.random.default_rng(seed)
    # uniform start over the concatenated transcriptome, like the
    # reference readgenerator (readgenerator_functions.c:4-114)
    w = np.where(tx_len >= rl, tx_len - rl + 1, 0).astype(np.float64)
    tid = rng.choice(ntx, size=n_reads, p=w / w.sum())
    pos = (rng.random(n_reads) * (tx_len[tid] - rl + 1)).astype(np.int64)

    # read -> (slot e, offset in e); dropped slots share the next kept
    # slot's start, so "last slot with start <= pos" is always kept
    e_kept = (pos[:, None] >= pre[tid]).sum(axis=1) - 1
    off = pos - pre[tid, e_kept]
    span = off + rl > exon_lens[tid, e_kept]

    # group reads by gene (sort by tid; a read's gene owns its matches)
    order = np.argsort(tid, kind="stable")
    tid_s, e_s, off_s, span_s = tid[order], e_kept[order], off[order], \
        span[order]
    g_of_read = gene_of[tid_s]
    gb = np.concatenate([[0], np.flatnonzero(np.diff(g_of_read)) + 1,
                         [len(tid_s)]])
    print(f"read mapping done ({time.time()-t0:.1f}s); matching + writing",
          flush=True)

    seq = "A" * rl
    t2 = time.time()
    nlines = 0
    with open(out, "w", buffering=1 << 22) as fh:
        buf = []
        for bi in range(len(gb) - 1):
            lo, hi = int(gb[bi]), int(gb[bi + 1])
            g = g_of_read[lo]
            sib = np.arange(gstart[g], gstart[g + 1])
            sb = bits[sib]
            e = e_s[lo:hi]
            sp = span_s[lo:hi]
            f = nxt_kept[tid_s[lo:hi], e]
            need = (1 << e).astype(np.uint16) | np.where(
                sp & (f >= 0), 1 << np.maximum(f, 0), 0).astype(np.uint16)
            blk = np.where(sp, between[e, np.maximum(f, 0)],
                           np.uint16(0)).astype(np.uint16)
            ok = ((sb[None, :] & need[:, None]) == need[:, None]) & \
                 ((sb[None, :] & blk[:, None]) == 0)
            rr, ss = np.nonzero(ok)
            sib_t = sib[ss]
            apos = pre[sib_t, e[rr]] + off_s[lo:hi][rr]
            rids = order[lo:hi][rr]
            nm = [names[t] for t in sib_t]
            for j in range(len(rr)):
                buf.append(f"r{rids[j]}\t+\t{nm[j]}\t{apos[j]}\t"
                           f"{seq}\tI\t0\t\n")
            nlines += len(rr)
            if len(buf) > 200000:
                fh.write("".join(buf))
                buf.clear()
        fh.write("".join(buf))
    print(f"{nlines} alignment lines / {n_reads} reads "
          f"({time.time()-t2:.1f}s match+write, {time.time()-t0:.1f}s "
          f"total)", flush=True)


if __name__ == "__main__":
    main()
