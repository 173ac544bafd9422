"""Differential tests for the device-resident builder: on random
transcriptomes, its .rsh must be byte-identical to the exact NumPy path
(which is itself golden-pinned against the reference binary)."""

import numpy as np
import pytest

from emsar_jax.config import BuildConfig, StrandType
from emsar_jax.index.build import build_pe_index, build_se_index
from emsar_jax.index import device_build
from emsar_jax.io.fasta import build_transcriptome
from tests.util import random_transcriptome, run_ref_build, write_fasta


def _text(idx, tmp_path, name):
    p = str(tmp_path / name)
    idx.write_text(p)
    with open(p, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("seed,pe,strand,n_frac,max_frag", [
    (101, True, "ns", 0.0, 65),
    (102, True, "ssfr", 0.01, 55),
    (103, False, "ns", 0.02, None),
    (104, False, "ssr", 0.0, None),
])
def test_device_matches_numpy(tmp_path, seed, pe, strand, n_frac, max_frag):
    rng = np.random.default_rng(seed)
    names, seqs = random_transcriptome(rng, 30, min_len=25, max_len=220,
                                       shared_frac=0.6, n_frac=n_frac)
    tx = build_transcriptome(names, seqs)
    rl = 19
    cfg = BuildConfig(pe=pe, strand=StrandType.parse(strand, pe),
                      min_fraglength=1,
                      max_fraglength=max_frag if max_frag else 400,
                      verbose=0)
    if pe:
        dev = build_pe_index(tx, rl, cfg, backend="device")
        ref = build_pe_index(tx, rl, cfg, backend="numpy")
    else:
        dev = build_se_index(tx, rl - 1, rl + 1, cfg, backend="device")
        ref = build_se_index(tx, rl - 1, rl + 1, cfg, backend="numpy")
    assert _text(dev, tmp_path, "d.rsh") == _text(ref, tmp_path, "n.rsh")


def test_multiset_hash_host_device_agree():
    """The host dual of the device multiset hash must agree exactly (the
    exemplar verification in _finalize_host depends on it)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    tids = rng.integers(0, 50000, size=257).astype(np.int32)
    host = device_build.sig_lanes_np(tids)
    dev = np.stack([np.asarray(x)
                    for x in device_build._sig_lanes(jnp.asarray(tids))],
                   axis=1)
    np.testing.assert_array_equal(host, dev)
    h = device_build.multiset_hash_np(tids)
    h_perm = device_build.multiset_hash_np(tids[::-1].copy())
    assert h == h_perm


@pytest.mark.parametrize("strand,limit", [("ns", 1 << 12), ("ns", 1 << 10),
                                          ("ssf", 1 << 11)])
def test_partitioned_se_matches_single(tmp_path, strand, limit,
                                       monkeypatch):
    """Forcing a tiny sort budget drives the prefix-partitioned path
    (bucket compaction, per-launch ids, tab folding, mem draining); output
    must stay byte-identical to the single-launch build."""
    rng = np.random.default_rng(140)
    names, seqs = random_transcriptome(rng, 40, min_len=60, max_len=400,
                                       shared_frac=0.5, n_frac=0.01)
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(strand=StrandType.parse(strand, False), verbose=0)
    single = build_se_index(tx, 20, 22, cfg, backend="device")
    cfg.device_sort_limit = limit
    # shrink live-buffer caps so folding and member draining actually run
    real_caps = device_build._caps_partitioned

    def tiny_caps(ncand, nfl=1):
        c = real_caps(ncand, nfl=nfl)
        c["TABCAP"] = min(c["TABCAP"], 1 << 13)
        c["MEMCAP"] = min(c["MEMCAP"], 1 << 12)
        return c

    monkeypatch.setattr(device_build, "_caps_partitioned", tiny_caps)
    part = build_se_index(tx, 20, 22, cfg, backend="device")
    assert _text(part, tmp_path, "p.rsh") == _text(single, tmp_path, "1.rsh")


@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_partitioned_pe_matches_single(tmp_path, strand):
    """Forcing a tiny sort budget drives the partitioned PE rank pass
    (bucketed ranks with global offsets, chunk-local candidate ids);
    output must stay byte-identical to the single-launch build."""
    rng = np.random.default_rng(141)
    names, seqs = random_transcriptome(rng, 30, min_len=100, max_len=400,
                                       shared_frac=0.5)
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(pe=True, strand=StrandType.parse(strand, True),
                      min_fraglength=60, max_fraglength=100, verbose=0)
    single = build_pe_index(tx, 24, cfg, backend="device")
    cfg.device_sort_limit = 1 << 11
    part = build_pe_index(tx, 24, cfg, backend="device")
    assert _text(part, tmp_path, "p.rsh") == _text(single, tmp_path, "1.rsh")


def test_small_chunk_budget_pe(tmp_path):
    """Many tiny chunks (cluster-boundary overlap logic) must not change
    the output."""
    rng = np.random.default_rng(105)
    names, seqs = random_transcriptome(rng, 20, min_len=30, max_len=150,
                                       shared_frac=0.7)
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(pe=True, strand=StrandType.parse("ns", True),
                      min_fraglength=1, max_fraglength=50, verbose=0)
    big = build_pe_index(tx, 16, cfg, backend="device")
    cfg.pe_chunk_candidates = 1 << 12  # force many chunks
    small = build_pe_index(tx, 16, cfg, backend="device")
    assert _text(big, tmp_path, "b.rsh") == _text(small, tmp_path, "s.rsh")


def test_device_ref_mirror_matches_host_pack():
    """DeviceRef ships the fw half only and mirrors the rc half on device
    (_mirror_ref_dev); the resulting packed-code and bad-bit tables must
    equal a direct host pack of the full code array."""
    from emsar_jax.index.device_build import (DeviceRef, _pad_to,
                                              _quantize_size)

    rng = np.random.default_rng(77)
    names, seqs = random_transcriptome(rng, 15, min_len=40, max_len=300,
                                       n_frac=0.05, shared_frac=0.3)
    tx = build_transcriptome(names, seqs)
    ref = DeviceRef(tx)

    L = int(tx.seqlength) + 1
    Lp = _pad_to(L + 64, 256)
    codes = tx.codes
    c = np.zeros(Lp, dtype=np.uint8)
    c[:L] = codes & 3
    packed = np.zeros(_quantize_size(Lp // 4 + 8), dtype=np.uint8)
    packed[:Lp // 4] |= c[0::4] << 6
    packed[:Lp // 4] |= c[1::4] << 4
    packed[:Lp // 4] |= c[2::4] << 2
    packed[:Lp // 4] |= c[3::4]
    badbits = np.zeros(Lp, dtype=bool)
    badbits[:L] = codes >= 4
    badbits[L:] = True
    bb = np.full(_quantize_size(Lp // 8), 0xFF, dtype=np.uint8)
    bb[:Lp // 8] = np.packbits(badbits)

    got_pk = np.asarray(ref._packed)
    got_bb = np.asarray(ref._badbits)
    # codes of bad positions are garbage on both sides — compare under
    # the bad mask at 2-bit granularity
    bad4 = badbits.reshape(-1, 4)
    mask = np.zeros(len(packed), dtype=np.uint8)
    m4 = np.where(bad4, 0, np.uint8(3))
    mask[:Lp // 4] = (m4[:, 0] << 6) | (m4[:, 1] << 4) | (m4[:, 2] << 2) \
        | m4[:, 3]
    np.testing.assert_array_equal(got_pk[:Lp // 4] & mask[:Lp // 4],
                                  packed[:Lp // 4] & mask[:Lp // 4])
    np.testing.assert_array_equal(got_bb[:Lp // 8], bb[:Lp // 8])


def BASES_STR(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_singleton_multi_d_drop(tmp_path, strand):
    """A singleton mate1 whose mate2 window repeats at two distinct d in
    the fragment range is a multi_d run (reference
    src/emsar_functions.c:1926) and must contribute nothing — exercised
    through the singleton-cluster fast path, byte-diffed against the
    reference binary."""
    rng = np.random.default_rng(404)
    base = BASES_STR(rng, 30)
    rep = BASES_STR(rng, 24)
    # mate1 lands in `base`; the same 16-mer mate2 window appears at two
    # offsets inside the fragment window
    t0 = base + rep + rep + BASES_STR(rng, 30)
    names = ["REP0"] + [f"D{i}" for i in range(6)]
    seqs = [t0.encode()] + [BASES_STR(rng, 90).encode() for _ in range(6)]
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    ref_rsh = run_ref_build(fasta, 16, str(tmp_path), "r", pe=True,
                            extra=["-f", "40", "-F", "80"])
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(pe=True, strand=StrandType.parse(strand, True),
                      min_fraglength=40, max_fraglength=80, verbose=0)
    if strand != "ns":
        ref_rsh = run_ref_build(fasta, 16, str(tmp_path), "rs", pe=True,
                                extra=["-f", "40", "-F", "80", "-s", strand])
    idx = build_pe_index(tx, 16, cfg, backend="device")
    ours = str(tmp_path / "ours.rsh")
    idx.write_text(ours)
    assert open(ours, "rb").read() == open(ref_rsh, "rb").read()


def test_partitioned_rank_fast_singles(tmp_path, monkeypatch):
    """Partitioned rank pass + cluster-chunked expansion + fast singleton
    slab pass together (the human F1-400 combination): the
    neighbor-distance table derives from the bucket-major stream AFTER
    the partition copies are freed (_dd_from_stream; building it inside
    the bucket loop OOMed at human scale)."""
    from emsar_jax.index import device_build
    monkeypatch.setattr(device_build, "PE_GLOBAL_BUDGET", 0)
    rng = np.random.default_rng(142)
    names, seqs = random_transcriptome(rng, 30, min_len=100, max_len=400,
                                       shared_frac=0.5)
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(pe=True, strand=StrandType.parse("ssfr", True),
                      min_fraglength=1, max_fraglength=100, verbose=0)
    single = build_pe_index(tx, 24, cfg, backend="device")
    cfg.device_sort_limit = 1 << 11
    part = build_pe_index(tx, 24, cfg, backend="device")
    assert _text(part, tmp_path, "p.rsh") == _text(single, tmp_path,
                                                   "1.rsh")


def test_single_sort_dense_records_fit_table(tmp_path, monkeypatch):
    """Single-sort SE builds whose sorted rows are dense with multi runs
    (gene families share exons, so up to half the rows start a record)
    must accumulate on the device: each launch covers at most TABCAP/2
    rows, so its records fit the TABCAP/4 block.  A shrunken table makes
    a small fixture as dense as a slab of the human-scale one."""
    from emsar_jax.sim import gene_family_transcriptome

    rng = np.random.default_rng(150)
    names, seqs, _ = gene_family_transcriptome(rng, 30, n_exons=8,
                                               min_exon=60, max_exon=200)
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(strand=StrandType.parse("ns", False), verbose=0)
    real_caps = device_build._caps_partitioned

    def small_table(ncand, nfl=1):
        c = real_caps(ncand, nfl=nfl)
        c["TABCAP"] = device_build._next_pow2(ncand) // 4
        return c

    monkeypatch.setattr(device_build, "_caps_partitioned", small_table)
    dev = device_build.build_se_index_device(tx, 25, 25, cfg)  # no fallback
    ref = build_se_index(tx, 25, 25, cfg, backend="numpy")
    assert _text(dev, tmp_path, "d.rsh") == _text(ref, tmp_path, "n.rsh")
