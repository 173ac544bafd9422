"""SE variable read-length support: the reference learns the read-length
range by scanning the whole alignment file and builds one index over the
range; fragment length == per-read read length."""

import numpy as np
import subprocess

from emsar_jax.cli import emsar as emsar_cli
from emsar_jax.io.fasta import build_transcriptome
from emsar_jax.sim import simulate_fragments
from tests.aligner import bowtie_lines_se
from tests.test_quantify_golden import _parse_fpkm
from tests.util import REF_EMSAR, random_transcriptome, write_fasta


def test_se_variable_readlength_golden(tmp_path):
    rng = np.random.default_rng(95)
    names, seqs = random_transcriptome(rng, 25, min_len=80, max_len=300,
                                       shared_frac=0.5)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    tx = build_transcriptome(names, seqs)

    aln = str(tmp_path / "aln.bowtieout")
    with open(aln, "w") as fh:
        i = 0
        for rl in (18, 20, 22):
            pos = simulate_fragments(tx, rl, 600, rng)
            seq = tx.seq.tobytes()
            for p in pos:
                read = seq[p:p + rl]
                for ln in bowtie_lines_se(f"r{i}", read, names, seqs):
                    fh.write(ln + "\n")
                i += 1

    ref_out = tmp_path / "ref"
    our_out = tmp_path / "ours"
    subprocess.run([REF_EMSAR, "-q", "-x", fasta, str(ref_out), "s", aln],
                   check=True, capture_output=True)
    assert emsar_cli.main(["-q", "-x", fasta, str(our_out), "s", aln]) == 0

    rn, rc = _parse_fpkm(str(ref_out / "s.0.fpkm"))
    on, oc = _parse_fpkm(str(our_out / "s.0.fpkm"))
    assert rn == on
    # eff.length identical; TPM at solver tolerance
    np.testing.assert_allclose(oc[:, 2], rc[:, 2], rtol=0, atol=5e-6)
    assert np.abs(oc[:, 5] - rc[:, 5]).max() <= 0.05
