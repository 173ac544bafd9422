"""End-to-end golden tests: simulate reads, align, quantify with both the
reference binary and our pipeline, and compare outputs.

FPKM/TPM match at solver tolerance (the reference seeds srand(time) so its
own runs are not bit-reproducible); the combinatorial outputs
(.fraglength_effect counts, .segments structure) match exactly.
"""

import os
import subprocess

import numpy as np
import pytest

from emsar_jax.cli import emsar as emsar_cli
from emsar_jax.io.fasta import build_transcriptome
from emsar_jax.sim import fragments_to_reads, simulate_fragments
from tests.aligner import bowtie_lines_pe, bowtie_lines_se
from tests.util import (random_transcriptome, run_ref_build, write_fasta,
                        REF_EMSAR)


def _parse_fpkm(path):
    names, cols = [], []
    with open(path) as fh:
        next(fh)
        for line in fh:
            f = line.rstrip("\n").split("\t")
            names.append(f[0])
            cols.append([float(x) for x in f[1:]])
    return names, np.array(cols)


def _make_fixture(tmp_path, rng, n_tx, readlength, pe, fraglen, n_reads,
                  strand="ns", max_frag=None):
    names, seqs = random_transcriptome(rng, n_tx, min_len=60, max_len=300,
                                       shared_frac=0.5)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    extra = []
    if strand != "ns":
        extra += ["-s", strand]
    if max_frag is not None:
        extra += ["-F", str(max_frag)]
    rsh = run_ref_build(fasta, readlength, str(tmp_path), "idx", pe=pe,
                        extra=extra)

    tx = build_transcriptome(names, seqs)
    # forward-stranded libraries simulate from the fw half only; reverse
    # libraries simulate unstranded (the '+' reads are then filtered by
    # both tools identically)
    pos = simulate_fragments(tx, fraglen, n_reads, rng,
                             strand_specific=strand in ("ssf", "ssfr"))
    rnames, r1, r2 = fragments_to_reads(tx, pos, readlength, fraglen, pe)

    aln = str(tmp_path / "aln.bowtieout")
    with open(aln, "w") as fh:
        for i, name in enumerate(rnames):
            if pe:
                lines = bowtie_lines_pe(name, r1[i], r2[i], names, seqs,
                                        max_insert=max_frag or 400)
            else:
                lines = bowtie_lines_se(name, r1[i], names, seqs)
            for ln in lines:
                fh.write(ln + "\n")
    return fasta, rsh, aln


def _run_both(tmp_path, rsh, aln, pe, strand="ns", extra=()):
    ref_out = tmp_path / "refout"
    our_out = tmp_path / "ourout"
    args = ["-q", "-g"]
    if pe:
        args.append("-P")
    if strand != "ns":
        args += ["-s", strand]
    args += list(extra)
    subprocess.run([REF_EMSAR] + args + ["-I", rsh, str(ref_out), "s", aln],
                   check=True, capture_output=True)
    rc = emsar_cli.main(args + ["-I", rsh, str(our_out), "s", aln])
    assert rc == 0
    return str(ref_out / "s.0"), str(our_out / "s.0")


def _compare(refpref, ourpref, tpm_tol=0.05, fpkm_rel=1e-4):
    rnames, rcols = _parse_fpkm(refpref + ".fpkm")
    onames, ocols = _parse_fpkm(ourpref + ".fpkm")
    assert rnames == onames
    # eff.length must match to float-print precision
    np.testing.assert_allclose(ocols[:, 2], rcols[:, 2], rtol=0, atol=5e-6)
    # FPKM / TPM at solver tolerance
    scale = max(rcols[:, 0].max(), 1.0)
    assert np.abs(ocols[:, 0] - rcols[:, 0]).max() <= fpkm_rel * scale, \
        np.abs(ocols[:, 0] - rcols[:, 0]).max()
    tpm_diff = np.abs(ocols[:, 5] - rcols[:, 5]).max()
    assert tpm_diff <= tpm_tol
    # fraglength_effect: counts column must be identical
    with open(refpref + ".fraglength_effect") as fh:
        ref_fl = [ln.split("\t")[:2] for ln in fh]
    with open(ourpref + ".fraglength_effect") as fh:
        our_fl = [ln.split("\t")[:2] for ln in fh]
    assert ref_fl == our_fl
    # segments: structural columns identical
    with open(refpref + ".segments") as fh:
        ref_seg = [ln.split("\t")[:6] for ln in fh]
    with open(ourpref + ".segments") as fh:
        our_seg = [ln.split("\t")[:6] for ln in fh]
    assert ref_seg == our_seg
    return tpm_diff


def test_se_quantify_golden(tmp_path):
    rng = np.random.default_rng(42)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=40, readlength=20,
                                pe=False, fraglen=20, n_reads=4000)
    ref, ours = _run_both(tmp_path, rsh, aln, pe=False)
    d = _compare(ref, ours)
    print("SE TPM max diff:", d)


def test_pe_quantify_golden(tmp_path):
    rng = np.random.default_rng(43)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=30, readlength=20,
                                pe=True, fraglen=50, n_reads=3000,
                                max_frag=80)
    ref, ours = _run_both(tmp_path, rsh, aln, pe=True)
    d = _compare(ref, ours)
    print("PE TPM max diff:", d)


def test_se_stranded_quantify_golden(tmp_path):
    rng = np.random.default_rng(44)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=30, readlength=18,
                                pe=False, fraglen=18, n_reads=3000,
                                strand="ssf")
    ref, ours = _run_both(tmp_path, rsh, aln, pe=False, strand="ssf")
    _compare(ref, ours)


def test_se_reverse_stranded_quantify_golden(tmp_path):
    """ssr: reads from the '-' strand; the index is still built on the fw
    half, only the read strand filter flips."""
    rng = np.random.default_rng(45)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=25, readlength=18,
                                pe=False, fraglen=18, n_reads=2000,
                                strand="ssr")
    ref, ours = _run_both(tmp_path, rsh, aln, pe=False, strand="ssr")
    _compare(ref, ours)


def test_pe_reverse_stranded_quantify_golden(tmp_path):
    rng = np.random.default_rng(46)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=20, readlength=18,
                                pe=True, fraglen=45, n_reads=1500,
                                strand="ssrf", max_frag=70)
    ref, ours = _run_both(tmp_path, rsh, aln, pe=True, strand="ssrf")
    _compare(ref, ours)


def test_delta_flag_golden(tmp_path):
    """-d 1: the EUMAps 10^delta scaling shifts FPKM by 10^-delta but
    leaves TPM invariant; both tools must agree."""
    rng = np.random.default_rng(48)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=20, readlength=15,
                                pe=False, fraglen=15, n_reads=1500)
    ref, ours = _run_both(tmp_path, rsh, aln, pe=False, extra=("-d", "1"))
    _compare(ref, ours)


def test_max_repeat_flag_golden(tmp_path):
    """-k 3: reads with more than 3 alignments are discarded identically."""
    rng = np.random.default_rng(47)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=25, readlength=15,
                                pe=False, fraglen=15, n_reads=2000)
    ref, ours = _run_both(tmp_path, rsh, aln, pe=False, extra=("-k", "3"))
    _compare(ref, ours)


def test_sd_column_nonzero_on_collinear_modules(tmp_path):
    """-n (num_round) semantics: on non-identifiable collinear isoform
    groups the sd.of.FPKM column must report the restart spread like the
    reference (src/emsar_main.c:444-450), while the FPKM/TPM point
    estimate stays the deterministic round-0 solve (documented divergence
    in outputs.write_fpkm)."""
    from emsar_jax.config import QuantConfig, StrandType
    from emsar_jax.io.rsh import RshIndex
    from emsar_jax.cli.emsar import _collapse_python
    from emsar_jax.model.quantify import quantify_sample
    from emsar_jax.io.outputs import write_fpkm
    import os

    rng = np.random.default_rng(91)
    # two identical transcripts (a perfectly collinear pair) among decoys
    names, seqs = random_transcriptome(rng, 12, min_len=80, max_len=200,
                                       shared_frac=0.0)
    twin = seqs[0]
    names = names + ["TWIN1", "TWIN2"]
    seqs = seqs + [twin, twin]
    names[0] = "TWIN0"  # three-way identical group
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    rsh = run_ref_build(fasta, 20, str(tmp_path), "idx", pe=False)
    tx = build_transcriptome(names, seqs)
    pos = simulate_fragments(tx, 20, 3000, rng)
    rnames, r1, _ = fragments_to_reads(tx, pos, 20, 20, pe=False)
    aln = str(tmp_path / "aln.bowtieout")
    with open(aln, "w") as fh:
        for i, name in enumerate(rnames):
            for ln in bowtie_lines_se(name, r1[i], names, seqs):
                fh.write(ln + "\n")

    index = RshIndex.read_text(rsh)
    cfg = QuantConfig(verbose=0, strand=StrandType.parse("ns", False))
    cfg.min_fraglength = index.min_fraglength
    cfg.max_fraglength = index.max_fraglength
    name_to_tid = {n: i for i, n in enumerate(index.names)}
    counts = _collapse_python(index, name_to_tid, cfg, aln, [-1])
    result = quantify_sample(index, counts, cfg)

    out = str(tmp_path / "s.0.fpkm")
    write_fpkm(out, index.names, result.fpkm_rounds, result.ieuma,
               result.total_read_count, 0)
    rows = {}
    with open(out) as fh:
        next(fh)
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            rows[f[0]] = (float(f[1]), float(f[2]))
    twins = [rows[n] for n in ("TWIN0", "TWIN1", "TWIN2")]
    # the twins carry reads, so the group FPKM is positive and split is
    # non-identifiable: the restart spread must be substantial
    assert sum(f for f, _ in twins) > 0
    assert all(sd > 0.01 * max(f, 1.0) for f, sd in twins), twins
    # FPKM column = deterministic round 0
    np.testing.assert_allclose([f for f, _ in twins],
                               result.fpkm_rounds[0][
                                   [index.names.index(n)
                                    for n in ("TWIN0", "TWIN1", "TWIN2")]],
                               rtol=1e-6)
