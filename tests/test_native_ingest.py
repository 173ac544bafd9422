"""The C++ ingest engine must agree exactly with the Python path, and with
the reference binary end-to-end."""

import numpy as np
import pytest

from emsar_jax.config import QuantConfig, StrandType
from emsar_jax.ingest import native
from emsar_jax.cli.emsar import _collapse_python
from emsar_jax.io.rsh import RshIndex
from tests.test_quantify_golden import _make_fixture


requires_native = pytest.mark.skipif(not native.available(),
                                     reason="no g++/zlib")


def _counts_equal(a, b):
    np.testing.assert_array_equal(a.single_counts, b.single_counts)
    np.testing.assert_array_equal(a.multi_counts, b.multi_counts)
    np.testing.assert_array_equal(a.fraglength_counts, b.fraglength_counts)
    assert a.total_read_count == b.total_read_count


@requires_native
@pytest.mark.parametrize("pe,strand", [(False, "ns"), (True, "ns"),
                                       (False, "ssf"), (True, "ssfr")])
def test_native_matches_python_bowtie(tmp_path, pe, strand):
    rng = np.random.default_rng(60 + pe + (strand != "ns") * 2)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=25, readlength=18,
                                pe=pe, fraglen=40 if pe else 18,
                                n_reads=1500, strand=strand,
                                max_frag=70 if pe else None)
    index = RshIndex.read_text(rsh)
    cfg = QuantConfig(pe=pe, strand=StrandType.parse(strand, pe), verbose=0)
    cfg.min_fraglength = index.min_fraglength
    cfg.max_fraglength = index.max_fraglength
    name_to_tid = {n: i for i, n in enumerate(index.names)}

    py = _collapse_python(index, name_to_tid, cfg, aln, [index.readlength
                                                         if pe else -1])
    nc = native.NativeCollapser(index)
    nat = nc.collapse_file(aln, "bowtie", pe, cfg.strand.code,
                           cfg.max_repeat, cfg.min_fraglength,
                           cfg.max_fraglength,
                           [index.readlength if pe else -1])
    _counts_equal(py, nat)

    # range-parallel ingest must give exactly the sequential counts (the
    # file is split only at read-group boundaries)
    for nthreads in (2, 3, 7):
        thr = nc.collapse_file(aln, "bowtie", pe, cfg.strand.code,
                               cfg.max_repeat, cfg.min_fraglength,
                               cfg.max_fraglength,
                               [index.readlength if pe else -1],
                               nthreads=nthreads)
        _counts_equal(nat, thr)


@requires_native
def test_native_matches_python_bam_sam(tmp_path):
    from tests.test_bam_sam import _pe_records, _write_sam
    from emsar_jax.io.bam import write_bam
    from emsar_jax.io.fasta import build_transcriptome
    from emsar_jax.sim import fragments_to_reads, simulate_fragments
    from tests.util import random_transcriptome, run_ref_build, write_fasta

    rng = np.random.default_rng(70)
    names, seqs = random_transcriptome(rng, 20, min_len=60, max_len=250,
                                       shared_frac=0.5)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    rsh = run_ref_build(fasta, 20, str(tmp_path), "idx", pe=True,
                        extra=["-F", "80"])
    tx = build_transcriptome(names, seqs)
    pos = simulate_fragments(tx, 50, 800, rng)
    rnames, r1, r2 = fragments_to_reads(tx, pos, 20, 50, pe=True)
    recs = _pe_records(rnames, r1, r2, names, seqs, max_insert=80)
    bam = str(tmp_path / "a.bam")
    sam = str(tmp_path / "a.sam")
    write_bam(bam, names, [len(s) for s in seqs], iter(recs))
    _write_sam(sam, names, [len(s) for s in seqs], recs)

    index = RshIndex.read_text(rsh)
    cfg = QuantConfig(pe=True, strand=StrandType.parse("ns", True), verbose=0)
    cfg.min_fraglength = index.min_fraglength
    cfg.max_fraglength = index.max_fraglength
    name_to_tid = {n: i for i, n in enumerate(index.names)}
    nc = native.NativeCollapser(index)

    for fmt, path in (("bam", bam), ("sam", sam)):
        cfg.aln_format = fmt
        py = _collapse_python(index, name_to_tid, cfg, path,
                              [index.readlength])
        nat = nc.collapse_file(path, fmt, True, 0, cfg.max_repeat,
                               cfg.min_fraglength, cfg.max_fraglength,
                               [index.readlength], nthreads=1)
        _counts_equal(py, nat)
        # parallel ingest (BAM: parallel-inflate + group-split collapse;
        # SAM: byte-range split) must reproduce sequential counts exactly
        for nthreads in (2, 3, 7):
            thr = nc.collapse_file(path, fmt, True, 0, cfg.max_repeat,
                                   cfg.min_fraglength, cfg.max_fraglength,
                                   [index.readlength], nthreads=nthreads)
            _counts_equal(nat, thr)


@requires_native
def test_parallel_bam_odd_group_fallback(tmp_path):
    """A qname group with an odd number of mapped records makes the serial
    pairing frame cross group boundaries; the parallel path must detect the
    crossing at its split points and fall back to the exact serial pass."""
    from tests.test_bam_sam import _pe_records
    from emsar_jax.io.bam import write_bam
    from emsar_jax.io.fasta import build_transcriptome
    from emsar_jax.sim import fragments_to_reads, simulate_fragments
    from tests.util import random_transcriptome, run_ref_build, write_fasta

    rng = np.random.default_rng(71)
    names, seqs = random_transcriptome(rng, 12, min_len=80, max_len=200,
                                       shared_frac=0.3)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    rsh = run_ref_build(fasta, 20, str(tmp_path), "idx", pe=True,
                        extra=["-F", "80"])
    tx = build_transcriptome(names, seqs)
    pos = simulate_fragments(tx, 50, 400, rng)
    rnames, r1, r2 = fragments_to_reads(tx, pos, 20, 50, pe=True)
    recs = _pe_records(rnames, r1, r2, names, seqs, max_insert=80)
    # inject unmapped-mate groups throughout: [mapped, unmapped] keeps the
    # frame; a lone unmapped record shifts it by one
    out = []
    for i, rec in enumerate(recs):
        out.append(rec)
        if i % 97 == 0:
            out.append((f"odd{i}", 0x1 | 0x4, -1, 0, b"A" * 50, None))
    bam = str(tmp_path / "a.bam")
    write_bam(bam, names, [len(s) for s in seqs], iter(out))

    index = RshIndex.read_text(rsh)
    nc = native.NativeCollapser(index)
    base = nc.collapse_file(bam, "bam", True, 0, 100,
                            index.min_fraglength, index.max_fraglength,
                            [index.readlength], nthreads=1)
    for nthreads in (2, 5):
        thr = nc.collapse_file(bam, "bam", True, 0, 100,
                               index.min_fraglength, index.max_fraglength,
                               [index.readlength], nthreads=nthreads)
        _counts_equal(base, thr)


@requires_native
@pytest.mark.parametrize("pe", [False, True])
def test_native_posbias_matches_python(tmp_path, pe):
    """-m 1: the native posbias accrual must reproduce the Python
    PosBias arrays exactly (incl. the NumPy negative-index wraparound on
    freq_3 and the unavailability suffix sums), across thread counts."""
    from emsar_jax.ingest.collapse import PosBias
    from emsar_jax.io.fasta import read_fasta

    rng = np.random.default_rng(83 + pe)
    fasta, rsh, aln = _make_fixture(tmp_path, rng, n_tx=25, readlength=18,
                                    pe=pe, fraglen=40 if pe else 18,
                                    n_reads=1200, strand="ns",
                                    max_frag=70 if pe else None)
    index = RshIndex.read_text(rsh)
    cfg = QuantConfig(pe=pe, strand=StrandType.parse("ns", pe), verbose=0)
    cfg.min_fraglength = index.min_fraglength
    cfg.max_fraglength = index.max_fraglength
    name_to_tid = {n: i for i, n in enumerate(index.names)}
    tlen = read_fasta(fasta, "E").transcript_lengths()

    pb_py = PosBias(tlen, 100)
    _collapse_python(index, name_to_tid, cfg, aln,
                     [index.readlength if pe else -1], pb_py)
    assert pb_py.freq_5.sum() > 0  # the fixture exercises the accrual

    nc = native.NativeCollapser(index)
    for nthreads in (1, 3):
        pb_nat = PosBias(tlen, 100)
        nc.collapse_file(aln, "bowtie", pe, cfg.strand.code, cfg.max_repeat,
                         cfg.min_fraglength, cfg.max_fraglength,
                         [index.readlength if pe else -1],
                         nthreads=nthreads, posbias=pb_nat)
        np.testing.assert_allclose(pb_nat.freq_5, pb_py.freq_5, rtol=1e-12)
        np.testing.assert_allclose(pb_nat.freq_3, pb_py.freq_3, rtol=1e-12)
        np.testing.assert_allclose(pb_nat.unavail_5, pb_py.unavail_5,
                                   rtol=1e-12)
        np.testing.assert_allclose(pb_nat.unavail_3, pb_py.unavail_3,
                                   rtol=1e-12)


@requires_native
@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_native_posbias_sam_bam(tmp_path, fmt):
    """-m 1 posbias parity for the SAM/BAM parsers too (the CLI routes
    them through the same native flush path as bowtie, including the
    parallel SAM byte-range split and parallel BAM inflate)."""
    from tests.test_bam_sam import _pe_records, _write_sam
    from emsar_jax.io.bam import write_bam
    from emsar_jax.io.fasta import build_transcriptome, read_fasta
    from emsar_jax.ingest.collapse import PosBias
    from emsar_jax.sim import fragments_to_reads, simulate_fragments
    from tests.util import random_transcriptome, run_ref_build, write_fasta

    rng = np.random.default_rng(90)
    names, seqs = random_transcriptome(rng, 20, min_len=60, max_len=250,
                                       shared_frac=0.5)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    rsh = run_ref_build(fasta, 20, str(tmp_path), "idx", pe=True,
                        extra=["-F", "80"])
    tx = build_transcriptome(names, seqs)
    pos = simulate_fragments(tx, 50, 800, rng)
    rnames, r1, r2 = fragments_to_reads(tx, pos, 20, 50, pe=True)
    recs = _pe_records(rnames, r1, r2, names, seqs, max_insert=80)
    path = str(tmp_path / ("a." + fmt))
    if fmt == "bam":
        write_bam(path, names, [len(s) for s in seqs], iter(recs))
    else:
        _write_sam(path, names, [len(s) for s in seqs], recs)

    index = RshIndex.read_text(rsh)
    cfg = QuantConfig(pe=True, strand=StrandType.parse("ns", True),
                      verbose=0, aln_format=fmt)
    cfg.min_fraglength = index.min_fraglength
    cfg.max_fraglength = index.max_fraglength
    name_to_tid = {n: i for i, n in enumerate(index.names)}
    tlen = read_fasta(fasta, "E").transcript_lengths()

    pb_py = PosBias(tlen, 100)
    _collapse_python(index, name_to_tid, cfg, path, [index.readlength],
                     pb_py)
    assert pb_py.freq_5.sum() > 0

    nc = native.NativeCollapser(index)
    for nthreads in (1, 3):
        pb_nat = PosBias(tlen, 100)
        nc.collapse_file(path, fmt, True, cfg.strand.code, cfg.max_repeat,
                         cfg.min_fraglength, cfg.max_fraglength,
                         [index.readlength], nthreads=nthreads,
                         posbias=pb_nat)
        np.testing.assert_allclose(pb_nat.freq_5, pb_py.freq_5, rtol=1e-12)
        np.testing.assert_allclose(pb_nat.freq_3, pb_py.freq_3, rtol=1e-12)
        np.testing.assert_allclose(pb_nat.unavail_5, pb_py.unavail_5,
                                   rtol=1e-12)
        np.testing.assert_allclose(pb_nat.unavail_3, pb_py.unavail_3,
                                   rtol=1e-12)
