"""BAM/BGZF + SAM reader tests: byte-level reader correctness and golden
parity of the -B/-S quantification paths against the reference binary."""

import subprocess

import numpy as np

from emsar_jax.cli import emsar as emsar_cli
from emsar_jax.io.bam import read_bam_records, write_bam
from emsar_jax.io.fasta import build_transcriptome, revcomp_bytes
from emsar_jax.io.sam import read_sam_records
from emsar_jax.sim import fragments_to_reads, simulate_fragments
from tests.aligner import align_se
from tests.util import (REF_EMSAR, random_transcriptome, run_ref_build,
                        write_fasta)
from tests.test_quantify_golden import _parse_fpkm


def _pe_records(rnames, r1s, r2s, names, seqs, max_insert):
    """(qname, flag, ref_id, pos, seq, md) pairs, mates adjacent."""
    name_to_ref = {n: i for i, n in enumerate(names)}
    recs = []
    for i, rid in enumerate(rnames):
        h1 = align_se(r1s[i], names, seqs)
        h2 = align_se(r2s[i], names, seqs)
        for s1, t1, p1 in h1:
            for s2, t2, p2 in h2:
                if t1 != t2 or s1 == s2:
                    continue
                if s1 == "+" and p2 < p1:
                    continue
                if s1 == "-" and p1 < p2:
                    continue
                if abs(p2 - p1) + len(r1s[i]) > max_insert:
                    continue
                f1 = 0x1 | 0x40 | (0x10 if s1 == "-" else 0) | \
                    (0x20 if s2 == "-" else 0)
                f2 = 0x1 | 0x80 | (0x10 if s2 == "-" else 0) | \
                    (0x20 if s1 == "-" else 0)
                sq1 = r1s[i] if s1 == "+" else revcomp_bytes(r1s[i])
                sq2 = r2s[i] if s2 == "+" else revcomp_bytes(r2s[i])
                md = str(len(r1s[i]))
                recs.append((rid, f1, name_to_ref[t1], p1, sq1, md))
                recs.append((rid, f2, name_to_ref[t2], p2, sq2, md))
    return recs


def _write_sam(path, names, lengths, records):
    with open(path, "w") as fh:
        for n, l in zip(names, lengths):
            fh.write(f"@SQ\tSN:{n}\tLN:{l}\n")
        for qname, flag, ref_id, pos, seq, md in records:
            fh.write(f"{qname}\t{flag}\t{names[ref_id]}\t{pos + 1}\t255\t"
                     f"{len(seq)}M\t*\t0\t0\t{seq.decode('latin-1')}\t*\t"
                     f"MD:Z:{md}\n")


def test_bam_writer_reader_roundtrip(tmp_path):
    names = ["a", "b"]
    lengths = [100, 50]
    recs = [("q1", 0x40 | 0x1, 0, 5, b"ACGTACGT", "8"),
            ("q1", 0x80 | 0x1 | 0x10, 0, 30, b"TTTTACGT", "4A3"),
            ("q2", 0, 1, 0, b"GGGGCCCC", None)]
    path = str(tmp_path / "t.bam")
    write_bam(path, names, lengths, iter(recs))
    out = list(read_bam_records(path))
    assert len(out) == 3
    for rec, (qname, flag, ref_id, pos, seq, md) in zip(out, recs):
        assert rec.qname == qname
        assert rec.flag == flag
        assert rec.rname == names[ref_id]
        assert rec.pos == pos
        assert rec.l_seq == len(seq)
        assert rec.md == md


def test_bam_matches_reference_samtools_reader(tmp_path):
    """Our BAM must be readable by the reference's vendored samtools
    (via the emsar binary) — the inverse golden check."""
    rng = np.random.default_rng(50)
    names, seqs = random_transcriptome(rng, 20, min_len=60, max_len=250,
                                       shared_frac=0.5)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    rsh = run_ref_build(fasta, 20, str(tmp_path), "idx", pe=True,
                        extra=["-F", "80"])

    tx = build_transcriptome(names, seqs)
    pos = simulate_fragments(tx, 50, 1500, rng)
    rnames, r1, r2 = fragments_to_reads(tx, pos, 20, 50, pe=True)
    recs = _pe_records(rnames, r1, r2, names, seqs, max_insert=80)

    bam = str(tmp_path / "aln.bam")
    write_bam(bam, names, [len(s) for s in seqs], iter(recs))
    sam = str(tmp_path / "aln.sam")
    _write_sam(sam, names, [len(s) for s in seqs], recs)

    ref_out = tmp_path / "refout"
    our_bam_out = tmp_path / "ourbam"
    our_sam_out = tmp_path / "oursam"
    subprocess.run([REF_EMSAR, "-q", "-P", "-B", "-I", rsh, str(ref_out),
                    "s", bam], check=True, capture_output=True)
    assert emsar_cli.main(["-q", "-P", "-B", "-I", rsh, str(our_bam_out),
                           "s", bam]) == 0
    assert emsar_cli.main(["-q", "-P", "-S", "-I", rsh, str(our_sam_out),
                           "s", sam]) == 0

    rnames_, rcols = _parse_fpkm(str(ref_out / "s.0.fpkm"))
    bnames, bcols = _parse_fpkm(str(our_bam_out / "s.0.fpkm"))
    snames, scols = _parse_fpkm(str(our_sam_out / "s.0.fpkm"))
    assert rnames_ == bnames == snames
    # BAM and SAM paths must agree exactly with each other
    np.testing.assert_array_equal(bcols, scols)
    # and with the reference at solver tolerance
    assert np.abs(bcols[:, 5] - rcols[:, 5]).max() <= 0.05
    assert np.abs(bcols[:, 0] - rcols[:, 0]).max() <= \
        1e-4 * max(rcols[:, 0].max(), 1.0)
