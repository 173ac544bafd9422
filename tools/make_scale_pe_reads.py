"""Simulate human-scale PE alignments over the scale fixture as a BAM.

Same exon-structure derivation as make_scale_reads.py (the SE tool), PE
specifics:

* A pair (mate1 at q, mate2 at q+d, fraglen F = d + rl) aligns to
  isoform s iff BOTH mates exact-match s at offsets q and q+d.  On this
  fixture the inter-mate gap (F - 2*rl <= 98 bp) is shorter than the
  minimum exon (120 bp), so no exon can sit wholly inside the gap: the
  fragment's touched exon slots form one contiguous kept run, and the
  pair matches s iff s keeps every slot the FRAGMENT touches and none
  strictly between them — the SE junction rule applied at fragment
  length.  (Mate offsets then line up automatically because the kept
  sequence between the mates is identical.)
* Output is a qname-grouped BAM in the bench fixture's shape (mate1
  flag 0x41 forward, mate2 flag 0x91 reverse = the fr orientation the
  ssfr index expects), consumed by the reference via read_BAM_PE
  (/root/reference/src/emsar_functions.c:474-548) and by our parallel
  BGZF ingest.

Usage: python tools/make_scale_pe_reads.py [n_genes] [n_pairs] [rl]
                                           [fmin] [fmax] [out.bam]
Defaults: 42000 genes, 2M pairs, l101, F290-300,
bench_cache/scale_pe.bam.
"""
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.make_scale_reads import build_structure, N_EXONS  # noqa: E402


def main():
    n_genes = int(sys.argv[1]) if len(sys.argv) > 1 else 42000
    n_pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 2_000_000
    rl = int(sys.argv[3]) if len(sys.argv) > 3 else 101
    fmin = int(sys.argv[4]) if len(sys.argv) > 4 else 290
    fmax = int(sys.argv[5]) if len(sys.argv) > 5 else 300
    out = sys.argv[6] if len(sys.argv) > 6 else os.path.join(
        REPO, "bench_cache", "scale_pe.bam")
    write_pe_bam(n_genes, n_pairs, rl, fmin, fmax, out)


def write_pe_bam(n_genes, n_pairs, rl, fmin, fmax, out, seed=11):
    """Write ``n_pairs`` qname-grouped ssfr pairs (BAM) drawn with
    ``seed``."""
    if fmax - 2 * rl >= 120:
        raise ValueError("the inter-mate gap must stay below the minimum "
                         "exon (120 bp)")

    t0 = time.time()
    names, gene_of, exon_lens, keeps = build_structure(n_genes)
    ntx = len(names)
    kept_lens = np.where(keeps, exon_lens, 0)
    tx_len = kept_lens.sum(axis=1)
    cum = np.cumsum(kept_lens, axis=1)
    pre = cum - kept_lens
    gstart = np.concatenate([[0], np.flatnonzero(np.diff(gene_of)) + 1,
                             [ntx]])
    bits = (keeps.astype(np.uint16)
            << np.arange(N_EXONS, dtype=np.uint16)).sum(axis=1)
    range_mask = np.zeros((N_EXONS, N_EXONS), dtype=np.uint16)
    for e in range(N_EXONS):
        for f in range(e, N_EXONS):
            range_mask[e, f] = ((1 << (f + 1)) - 1) & ~((1 << e) - 1)
    print(f"structure: {ntx} transcripts ({time.time()-t0:.1f}s)",
          flush=True)

    rng = np.random.default_rng(seed)
    F = rng.integers(fmin, fmax + 1, size=n_pairs)
    w = np.where(tx_len >= fmax, tx_len - fmax + 1, 0).astype(np.float64)
    tid = rng.choice(ntx, size=n_pairs, p=w / w.sum())
    pos = (rng.random(n_pairs) * (tx_len[tid] - F + 1)).astype(np.int64)

    # fragment-touched kept-slot run [e_first, e_last] (kept coordinates)
    e_first = (pos[:, None] >= pre[tid]).sum(axis=1) - 1
    e_last = ((pos + F - 1)[:, None] >= pre[tid]).sum(axis=1) - 1
    rmask = range_mask[e_first, e_last]
    need = (bits[tid] & rmask).astype(np.uint16)
    blk = (~bits[tid] & rmask & 0x3FF).astype(np.uint16)

    order = np.argsort(tid, kind="stable")
    tid_s = tid[order]
    g_of_read = gene_of[tid_s]
    gb = np.concatenate([[0], np.flatnonzero(np.diff(g_of_read)) + 1,
                         [len(tid_s)]])
    print(f"pair mapping done ({time.time()-t0:.1f}s); matching",
          flush=True)

    qnames, flags, refids, positions = [], [], [], []
    n_aln = 0
    for bi in range(len(gb) - 1):
        lo, hi = int(gb[bi]), int(gb[bi + 1])
        g = g_of_read[lo]
        sib = np.arange(gstart[g], gstart[g + 1])
        sb = bits[sib]
        sel = order[lo:hi]
        nd, bl = need[sel], blk[sel]
        ok = ((sb[None, :] & nd[:, None]) == nd[:, None]) & \
             ((sb[None, :] & bl[:, None]) == 0)
        rr, ss = np.nonzero(ok)
        sib_t = sib[ss]
        ef = e_first[sel][rr]
        q = pre[sib_t, ef] + (pos[sel][rr] - pre[tid[sel][rr], ef])
        d = (F[sel][rr] - rl).astype(np.int64)
        rid = sel[rr]
        for j in range(len(rr)):
            qn = b"rp%07d" % rid[j]
            qnames += [qn, qn]
            flags += [0x41, 0x91]
            refids += [int(sib_t[j]), int(sib_t[j])]
            positions += [int(q[j]), int(q[j] + d[j])]
        n_aln += len(rr)
    print(f"{n_aln} pair alignments / {n_pairs} pairs "
          f"({time.time()-t0:.1f}s); writing BAM", flush=True)

    from bench import _fast_write_bam
    _fast_write_bam(out, names, [int(x) for x in tx_len], qnames,
                    np.asarray(flags), np.asarray(refids),
                    np.asarray(positions), rl)
    print(f"{out}: {os.path.getsize(out)/1e6:.1f} MB "
          f"({time.time()-t0:.1f}s total)", flush=True)


if __name__ == "__main__":
    main()
