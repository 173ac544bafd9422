import numpy as np

from emsar_jax.io.fasta import (Transcriptome, build_transcriptome,
                                parse_header, read_fasta)
from tests.util import random_transcriptome, write_fasta


def test_parse_header_ensembl():
    assert parse_header("ENST0001 cdna:foo", "E") == "ENST0001"
    assert parse_header("ENST0001\tx", "E") == "ENST0001"
    assert parse_header("ENST0001", "E") == "ENST0001"


def test_parse_header_refseq():
    assert parse_header("gi|123|ref|NM_0001.1|desc", "R") == "NM_0001.1"
    assert parse_header("a|b|c|name|", "R") == "name"
    assert parse_header("noname", "R") == ""


def test_concat_layout(tmp_path):
    names = ["a", "b"]
    seqs = [b"ACGT", b"ggnC"]
    tx = build_transcriptome(names, seqs)
    # f0@f1$rc(f1)@rc(f0)$
    assert tx.seq.tobytes() == b"ACGT@GGNC$GNCC@ACGT$"
    assert tx.borderpos == 9
    assert tx.seqlength == 19
    assert list(tx.cuml) == [0, 5, 10]
    assert tx.transcript_length(0) == 4
    assert tx.transcript_length(1) == 4


def test_read_fasta_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    names, seqs = random_transcriptome(rng, 20, n_frac=0.01)
    path = str(tmp_path / "t.fa")
    write_fasta(path, names, seqs)
    tx = read_fasta(path)
    assert tx.names == names
    ref = build_transcriptome(names, seqs)
    assert np.array_equal(tx.seq, ref.seq)
    assert np.array_equal(tx.cuml, ref.cuml)


def test_transcript_of_and_flip():
    names = ["a", "b", "c"]
    seqs = [b"ACGTACGT", b"CCCCC", b"TTTTTTTTTT"]
    tx = build_transcriptome(names, seqs)
    rl = 4
    # forward-half positions
    for tid in range(3):
        for k in range(tx.cuml[tid], tx.cuml[tid + 1] - rl):
            assert tx.transcript_of(np.array([k]), rl)[0] == tid
    # rc-half position maps back to the transcript of its flip
    k = tx.cuml[1]  # start of transcript b
    fk = tx.seqlength - k - rl
    assert tx.transcript_of(np.array([fk]), rl)[0] == 1
