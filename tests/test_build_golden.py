"""Golden tests: our index builder must produce byte-identical .rsh files to
the reference emsar-build binary (a pure-combinatorics output, so exact
equality is achievable)."""

import numpy as np
import pytest

from emsar_jax.config import BuildConfig, StrandType
from emsar_jax.index.build import build_pe_index, build_se_index
from emsar_jax.io.fasta import build_transcriptome
from tests.util import random_transcriptome, run_ref_build, write_fasta


def _diff(path_a, path_b):
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        a, b = fa.read(), fb.read()
    if a == b:
        return None
    la, lb = a.split(b"\n"), b.split(b"\n")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return f"line {i}: ours={x[:200]!r} ref={y[:200]!r}"
    return f"line count differs: ours={len(la)} ref={len(lb)}"


def _run_case(tmp_path, rng, n, readlength, pe, strand="ns",
              shared_frac=0.6, n_frac=0.0, backend="device",
              min_frag=1, max_frag=None, extra_ref=None):
    names, seqs = random_transcriptome(rng, n, min_len=25, max_len=250,
                                       shared_frac=shared_frac, n_frac=n_frac)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)

    extra = list(extra_ref or [])
    if strand != "ns":
        extra += ["-s", strand]
    if max_frag is not None:
        extra += ["-F", str(max_frag), "-f", str(min_frag)]
    ref_rsh = run_ref_build(fasta, readlength, str(tmp_path), "ref",
                            pe=pe, extra=extra)

    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(pe=pe, strand=StrandType.parse(strand, pe),
                      min_fraglength=min_frag,
                      max_fraglength=max_frag if max_frag is not None else 400,
                      verbose=0)
    if pe:
        idx = build_pe_index(tx, int(readlength), cfg, backend=backend)
    else:
        if "-" in str(readlength):
            lo, hi = str(readlength).split("-")
        else:
            lo = hi = readlength
        idx = build_se_index(tx, int(lo), int(hi), cfg, backend=backend)
    ours = str(tmp_path / "ours.rsh")
    idx.write_text(ours)
    d = _diff(ours, ref_rsh)
    assert d is None, d


def test_se_unstranded_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(10), n=40, readlength=20, pe=False)


def test_se_unstranded_with_N_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(11), n=30, readlength=15,
              pe=False, n_frac=0.02)


def test_se_stranded_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(12), n=40, readlength=20,
              pe=False, strand="ssf")


def test_se_readlength_range_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(13), n=25, readlength="18-21",
              pe=False)


def test_pe_unstranded_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(14), n=15, readlength=20,
              pe=True, max_frag=60, min_frag=1)


def test_pe_stranded_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(15), n=15, readlength=20,
              pe=True, strand="ssfr", max_frag=60, min_frag=1)


def test_pe_unstranded_with_N_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(16), n=12, readlength=15,
              pe=True, max_frag=50, n_frac=0.02)


def test_pe_cluster_chunk_path_golden(tmp_path, monkeypatch):
    """Pin the cluster-chunked expansion (the human-scale path): the
    delta-shift global pipeline handles every in-budget build, so this
    forces the budget to 0 to keep the big-build path under test."""
    from emsar_jax.index import device_build
    monkeypatch.setattr(device_build, "PE_GLOBAL_BUDGET", 0)
    _run_case(tmp_path, np.random.default_rng(23), n=15, readlength=20,
              pe=True, max_frag=60, min_frag=1)
    _run_case(tmp_path, np.random.default_rng(24), n=15, readlength=18,
              pe=True, strand="ssfr", max_frag=55, min_frag=1)


def test_pe_multislab_hash_golden(tmp_path, monkeypatch):
    """Pin the multi-slab rank hash pass (human-scale slab chunking —
    slab boundaries, unaligned rc bad-bit windows) at small scale via
    the EMSAR_PE_SLAB override, through both expansion paths."""
    from emsar_jax.index import device_build
    monkeypatch.setenv("EMSAR_PE_SLAB", "1024")
    _run_case(tmp_path, np.random.default_rng(25), n=25, readlength=21,
              pe=True, max_frag=70, min_frag=1)
    monkeypatch.setattr(device_build, "PE_GLOBAL_BUDGET", 0)
    _run_case(tmp_path, np.random.default_rng(26), n=25, readlength=21,
              pe=True, strand="ssfr", max_frag=70, min_frag=1)


def test_pe_stranded_chunk_with_N_golden(tmp_path, monkeypatch):
    """Fast singleton slab pass with N-containing sequences: invalid
    windows carry a zero neighbor-distance word and must drop exactly
    like the reference's noncanonical filter."""
    from emsar_jax.index import device_build
    monkeypatch.setattr(device_build, "PE_GLOBAL_BUDGET", 0)
    _run_case(tmp_path, np.random.default_rng(29), n=12, readlength=15,
              pe=True, strand="ssfr", max_frag=70, min_frag=1, n_frac=0.02)


def test_pe_wide_fraglen_chunk_golden(tmp_path, monkeypatch):
    """F1-400-like config (minfrag clamps to readlength, wide nFraglen)
    through the cluster-chunked path: ssfr exercises the fast singleton
    slab pass (neighbor-distance table), ns the legacy singleton chunks.
    Reference d-loop: src/emsar_functions.c:2854-2872."""
    from emsar_jax.index import device_build
    monkeypatch.setattr(device_build, "PE_GLOBAL_BUDGET", 0)
    _run_case(tmp_path, np.random.default_rng(27), n=12, readlength=20,
              pe=True, strand="ssfr", max_frag=120, min_frag=1)
    _run_case(tmp_path, np.random.default_rng(28), n=12, readlength=20,
              pe=True, max_frag=120, min_frag=1)


def test_se_numpy_backend_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(17), n=20, readlength=20,
              pe=False, backend="numpy")


def test_se_hostjax_backend_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(21), n=25, readlength=20,
              pe=False, backend="jax")


def test_pe_hostjax_backend_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(22), n=12, readlength=18,
              pe=True, max_frag=55, backend="jax")


def test_pe_numpy_backend_golden(tmp_path):
    _run_case(tmp_path, np.random.default_rng(18), n=10, readlength=18,
              pe=True, max_frag=55, backend="numpy")


def test_rsh_text_roundtrip(tmp_path):
    rng = np.random.default_rng(19)
    names, seqs = random_transcriptome(rng, 25, shared_frac=0.6)
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(verbose=0)
    idx = build_se_index(tx, 20, 20, cfg)
    p1 = str(tmp_path / "a.rsh")
    idx.write_text(p1)
    from emsar_jax.io.rsh import RshIndex
    idx2 = RshIndex.read_text(p1)
    p2 = str(tmp_path / "b.rsh")
    idx2.write_text(p2)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    # npz sidecar roundtrip
    idx.write_npz(p1 + ".npz")
    idx3 = RshIndex.read_npz(p1 + ".npz")
    p3 = str(tmp_path / "c.rsh")
    idx3.write_text(p3)
    assert open(p1, "rb").read() == open(p3, "rb").read()


def test_pe_stranded_chunk_min_frag_golden(tmp_path, monkeypatch):
    """Fast singleton slab pass with fl_min > readlength (d0 > 0): the
    separator/d-range guards bound d = d0 + slot, not the slot alone —
    the human F290-300 build overcounted singles by up to d0 before the
    rb shift (every earlier case used min_frag=1, d0=0)."""
    from emsar_jax.index import device_build
    monkeypatch.setattr(device_build, "PE_GLOBAL_BUDGET", 0)
    _run_case(tmp_path, np.random.default_rng(30), n=15, readlength=20,
              pe=True, strand="ssfr", max_frag=120, min_frag=50)
    _run_case(tmp_path, np.random.default_rng(31), n=15, readlength=20,
              pe=True, strand="ssfr", max_frag=80, min_frag=60)


def test_sig_table_golden(tmp_path, monkeypatch):
    """Signature-keyed dense record accumulation (the big-build path:
    directory probe + claim-insert + per-row dense fraglen vectors,
    collision/spill fallback to the append table) forced on at small
    scale through the PE global, PE cluster-chunked, and SE pipelines."""
    from emsar_jax.index import device_build
    monkeypatch.setenv("EMSAR_SIG_TABLE", "1")
    _run_case(tmp_path, np.random.default_rng(30), n=15, readlength=20,
              pe=True, max_frag=60, min_frag=1)
    _run_case(tmp_path, np.random.default_rng(31), n=40, readlength=20,
              pe=False)
    monkeypatch.setattr(device_build, "PE_GLOBAL_BUDGET", 0)
    _run_case(tmp_path, np.random.default_rng(32), n=15, readlength=18,
              pe=True, strand="ssfr", max_frag=55, min_frag=1)
    _run_case(tmp_path, np.random.default_rng(33), n=12, readlength=20,
              pe=True, max_frag=120, min_frag=1)


def test_sig_table_spill_golden(tmp_path, monkeypatch):
    """Row spill: a 2-row signature table forces nearly every signature
    through the claim-winner -> spill -> append-table fallback, which
    must still produce byte-identical output (routing is per-record and
    counts merge associatively at finalize)."""
    from emsar_jax.index import device_build
    monkeypatch.setenv("EMSAR_SIG_TABLE", "1")
    orig = device_build._caps_partitioned

    def tiny(ncand_hint, nfl=1):
        caps = orig(ncand_hint, nfl=nfl)
        if caps.get("SIGROWS"):
            caps["SIGROWS"] = 2
            caps["SIGSLOT"] = 64  # force slot collisions too
        return caps

    monkeypatch.setattr(device_build, "_caps_partitioned", tiny)
    _run_case(tmp_path, np.random.default_rng(34), n=15, readlength=20,
              pe=True, max_frag=60, min_frag=1)
    monkeypatch.setattr(device_build, "PE_GLOBAL_BUDGET", 0)
    _run_case(tmp_path, np.random.default_rng(35), n=15, readlength=18,
              pe=True, strand="ssfr", max_frag=55, min_frag=1)
