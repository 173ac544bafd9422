"""CLI path coverage: -x on-the-fly index, -M multisample, -R rsh emission,
stdin streaming, and the posbias surface."""

import io
import os
import subprocess
import sys

import numpy as np

from emsar_jax.cli import emsar as emsar_cli
from tests.test_quantify_golden import _make_fixture, _parse_fpkm, _run_both
from tests.util import REF_EMSAR


def test_fasta_on_the_fly_matches_rsh_path(tmp_path):
    """-x (build index during quantification) must equal the -I path."""
    rng = np.random.default_rng(80)
    fasta, rsh, aln = _make_fixture(tmp_path, rng, n_tx=25, readlength=18,
                                    pe=False, fraglen=18, n_reads=1500)
    out_i = tmp_path / "via_rsh"
    out_x = tmp_path / "via_fasta"
    assert emsar_cli.main(["-q", "-I", rsh, str(out_i), "s", aln]) == 0
    assert emsar_cli.main(["-q", "-x", fasta, str(out_x), "s", aln]) == 0
    _, a = _parse_fpkm(str(out_i / "s.0.fpkm"))
    _, b = _parse_fpkm(str(out_x / "s.0.fpkm"))
    np.testing.assert_array_equal(a, b)


def test_print_rsh_matches_reference_build(tmp_path):
    """-x -R must emit the same .rsh the reference builder produces."""
    rng = np.random.default_rng(81)
    fasta, rsh, aln = _make_fixture(tmp_path, rng, n_tx=20, readlength=18,
                                    pe=False, fraglen=18, n_reads=500)
    out = tmp_path / "r"
    assert emsar_cli.main(["-q", "-R", "-x", fasta, str(out), "s", aln]) == 0
    ours = open(out / "s.rsh", "rb").read()
    ref = open(rsh, "rb").read()
    assert ours == ref


def test_multisample(tmp_path):
    """-M with a list file: per-sample outputs, each equal to a
    single-sample run of that file."""
    rng = np.random.default_rng(82)
    _, rsh, aln1 = _make_fixture(tmp_path, rng, n_tx=25, readlength=18,
                                 pe=False, fraglen=18, n_reads=1200)
    # second sample: reuse fixture generator pieces with different reads
    sub = tmp_path / "s2"
    sub.mkdir()
    import shutil
    aln2 = str(tmp_path / "aln2.bowtieout")
    # sample 2 = first half of sample 1's lines (different counts)
    lines = open(aln1).readlines()
    with open(aln2, "w") as fh:
        fh.writelines(lines[: len(lines) // 2])

    listfile = str(tmp_path / "samples.list")
    with open(listfile, "w") as fh:
        fh.write(aln1 + "\n" + aln2 + "\n")

    out_m = tmp_path / "multi"
    assert emsar_cli.main(["-q", "-M", "-I", rsh, str(out_m), "s",
                           listfile]) == 0
    assert os.path.exists(out_m / "s.0.fpkm")
    assert os.path.exists(out_m / "s.1.fpkm")

    # reference multisample on the same list
    ref_m = tmp_path / "refmulti"
    subprocess.run([REF_EMSAR, "-q", "-M", "-I", rsh, str(ref_m), "s",
                    listfile], check=True, capture_output=True)
    for i in (0, 1):
        rn, rc = _parse_fpkm(str(ref_m / f"s.{i}.fpkm"))
        on, oc = _parse_fpkm(str(out_m / f"s.{i}.fpkm"))
        assert rn == on
        assert np.abs(oc[:, 5] - rc[:, 5]).max() <= 0.05

    # each sample must equal its single-sample run
    out_1 = tmp_path / "single1"
    assert emsar_cli.main(["-q", "-I", rsh, str(out_1), "s", aln1]) == 0
    _, a = _parse_fpkm(str(out_m / "s.0.fpkm"))
    _, b = _parse_fpkm(str(out_1 / "s.0.fpkm"))
    np.testing.assert_array_equal(a, b)


def test_multisample_batched_matches_loop(tmp_path):
    """-M --batch_samples (one sharded device solve over the sample axis)
    must match the per-sample loop at solver tolerance."""
    rng = np.random.default_rng(85)
    _, rsh, aln1 = _make_fixture(tmp_path, rng, n_tx=25, readlength=18,
                                 pe=False, fraglen=18, n_reads=1200)
    lines = open(aln1).readlines()
    aln2 = str(tmp_path / "aln2.bowtieout")
    with open(aln2, "w") as fh:
        fh.writelines(lines[: len(lines) // 2])
    listfile = str(tmp_path / "samples.list")
    with open(listfile, "w") as fh:
        fh.write(aln1 + "\n" + aln2 + "\n")

    out_loop = tmp_path / "loop"
    out_batch = tmp_path / "batch"
    assert emsar_cli.main(["-q", "-M", "-I", rsh, str(out_loop), "s",
                           listfile]) == 0
    assert emsar_cli.main(["-q", "-M", "--batch_samples", "-I", rsh,
                           str(out_batch), "s", listfile]) == 0
    for i in (0, 1):
        _, a = _parse_fpkm(str(out_loop / f"s.{i}.fpkm"))
        _, b = _parse_fpkm(str(out_batch / f"s.{i}.fpkm"))
        np.testing.assert_allclose(b[:, 0], a[:, 0], rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=0, atol=1e-6)


def test_stdin_streaming(tmp_path, monkeypatch):
    """Usage3: bowtie output piped on stdin (via the native path's fd 0 or
    the Python fallback)."""
    rng = np.random.default_rng(83)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=20, readlength=18,
                                pe=False, fraglen=18, n_reads=800)
    out_f = tmp_path / "file"
    out_s = tmp_path / "stdin"
    assert emsar_cli.main(["-q", "-I", rsh, str(out_f), "s", aln]) == 0
    # run as a subprocess with stdin redirected
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    with open(aln) as fh:
        subprocess.run([sys.executable, "-m", "emsar_jax.cli.emsar", "-q",
                        "-I", rsh, str(out_s), "s"],
                       stdin=fh, check=True, capture_output=True, env=env,
                       cwd=repo)
    _, a = _parse_fpkm(str(out_f / "s.0.fpkm"))
    _, b = _parse_fpkm(str(out_s / "s.0.fpkm"))
    np.testing.assert_array_equal(a, b)


def test_posbias_surface(tmp_path):
    rng = np.random.default_rng(84)
    fasta, rsh, aln = _make_fixture(tmp_path, rng, n_tx=20, readlength=18,
                                    pe=False, fraglen=18, n_reads=500)
    out = tmp_path / "pb"
    assert emsar_cli.main(["-q", "-m", "1", "-W", "200", "-x", fasta,
                           str(out), "s", aln]) == 0
    lines = open(out / "s.posbias").read().splitlines()
    assert lines[0].startswith("relative_position\t5-frag_count")
    assert len(lines) == 201
    # frequencies must sum to ~TotalReadCount (each read adds weight 1)
    tot5 = sum(float(ln.split("\t")[1]) for ln in lines[1:])
    assert tot5 > 0


def test_fallback_guard_refuses_host_path_at_scale():
    """A device-builder failure on a human-scale transcriptome must raise
    rather than silently dropping to the (multi-day) host backend."""
    import pytest
    from emsar_jax.config import QuantConfig
    from emsar_jax.index.build import _warn_fallback

    class FakeTx:
        seqlength = 300_000_001

    cfg = QuantConfig(verbose=0)
    with pytest.raises(RuntimeError, match="too large"):
        _warn_fallback(cfg, "jax", "synthetic failure", tx=FakeTx())
    # small transcriptomes still fall through (warning only)
    FakeTx.seqlength = 1_000_000
    _warn_fallback(cfg, "jax", "synthetic failure", tx=FakeTx())


def test_unknown_emsar_setting_is_refused(tmp_path, monkeypatch, capsys):
    """A setting this version does not read (a renamed or retired one)
    stops both CLIs before any work instead of being ignored."""
    import pytest
    from emsar_jax.cli import emsar_build
    from emsar_jax.cli.common import KNOWN_ENV, check_env

    for name in KNOWN_ENV:
        monkeypatch.setenv(name, "0")
    check_env()  # every known setting passes
    monkeypatch.setenv("EMSAR_RETIRED_SETTING", "1")
    for main, argv in ((emsar_cli.main, ["-q", "-I", "x.rsh", str(tmp_path),
                                         "s", "x.bowtieout"]),
                       (emsar_build.main, ["-q", "x.fa", "76", str(tmp_path),
                                           "s"])):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 1
        assert "EMSAR_RETIRED_SETTING" in capsys.readouterr().err
