"""Brute-force exact-match aligner emitting bowtie1-format lines.

Simulates `bowtie -a -v 0` behavior for test fixtures: every exact
occurrence of a read (on either strand for unstranded libraries) is
reported; PE alignments pair opposite-strand hits on the same transcript.
Both the reference binary and our quantifier consume the same file, so
fixture fidelity to real bowtie is not required for parity testing.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from emsar_jax.io.fasta import revcomp_bytes


def _occurrences(hay: bytes, needle: bytes) -> Iterator[int]:
    start = 0
    while True:
        i = hay.find(needle, start)
        if i < 0:
            return
        yield i
        start = i + 1


def align_se(read: bytes, names: List[str], seqs: List[bytes]
             ) -> List[Tuple[str, str, int]]:
    """All (strand, tname, pos) exact hits of the read."""
    hits = []
    rc = revcomp_bytes(read)
    for name, seq in zip(names, seqs):
        for p in _occurrences(seq, read):
            hits.append(("+", name, p))
        for p in _occurrences(seq, rc):
            hits.append(("-", name, p))
    return hits


def bowtie_lines_se(read_id: str, read: bytes, names: List[str],
                    seqs: List[bytes]) -> List[str]:
    lines = []
    for strand, tname, pos in align_se(read, names, seqs):
        seq_out = read if strand == "+" else revcomp_bytes(read)
        lines.append(f"{read_id}\t{strand}\t{tname}\t{pos}\t"
                     f"{seq_out.decode('latin-1')}\tIIII\t0\t")
    return lines


def bowtie_lines_pe(read_id: str, r1: bytes, r2: bytes, names: List[str],
                    seqs: List[bytes], max_insert: int = 1000) -> List[str]:
    """Pairs of lines (mate1 then mate2) for every valid pairing."""
    lines = []
    h1 = align_se(r1, names, seqs)
    h2 = align_se(r2, names, seqs)
    for s1, t1, p1 in h1:
        for s2, t2, p2 in h2:
            if t1 != t2 or s1 == s2:
                continue
            # proper orientation: '+' mate upstream of '-' mate
            if s1 == "+" and not (p2 >= p1):
                continue
            if s1 == "-" and not (p1 >= p2):
                continue
            fraglen = abs(p2 - p1) + len(r1)
            if fraglen > max_insert:
                continue
            sq1 = r1 if s1 == "+" else revcomp_bytes(r1)
            sq2 = r2 if s2 == "+" else revcomp_bytes(r2)
            lines.append(f"{read_id}/1\t{s1}\t{t1}\t{p1}\t"
                         f"{sq1.decode('latin-1')}\tIIII\t0\t")
            lines.append(f"{read_id}/2\t{s2}\t{t2}\t{p2}\t"
                         f"{sq2.decode('latin-1')}\tIIII\t0\t")
    return lines
