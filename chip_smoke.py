#!/usr/bin/env python3
"""Smoke run of emsar's main path on NVIDIA GPUs.

One card (default): ``emsar-build`` and ``emsar`` run in this process,
through their ``main(argv)`` entry points, at human transcriptome scale,
and every result is checked against the repository's plain references:

  (b) index oracle: device builds on slabs of the fixture, one per device
      route, byte-compared with the NumPy builder;
  (c) PE quantify of a simulated BAM against the slab's PE index;
  (a) human-scale SE: build (42,000 genes, ~150k transcripts, ~300 Mbp,
      l76, unstranded) and quantify 3M reads;
  (d) quantify oracle for (a) and (c): a host float64 NumPy SQUAREM solve
      of the same likelihood;
  (e) options users reach: --solver_mode csr, --solver_dtype float64,
      and -M over a few samples with restart rounds;
  then the tests marked ``gpu``.

``--multi-gpu`` (four cards) runs only the multi-device paths and what
they are compared with: the process-sharded PE build (4 processes, one
card each) against one process, the shard-merged quantify against one
process, and ``-M --batch_samples`` over a mesh of all four cards against
the per-sample loop.

Fixtures are generated from fixed seeds into ``bench_cache/smoke/`` and
NumPy oracle indexes are cached there, keyed by seed and size.  The last
line of stdout is one JSON object, {"ok": true, "device": {...}}; it is
printed only when every phase passed.  Without a GPU, or when any phase
fails, the script exits non-zero and prints no result.

    python chip_smoke.py [--multi-gpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, "bench_cache", "smoke")
FIXTURE_SEED = 20260820  # tools/make_scale_fixture.py
# log-likelihood gap to the float64 oracle, relative to |logL| or to the
# read count where that is larger (the Poisson terms R log(lam) - lam
# cancel towards 0 in small problems, which would make any gap "large")
LL_RTOL = 1e-6
# gene-level TPM: share of the 1e6 TPM total that moves between genes
GENE_TPM_TV = 1e-3
# compile time = lowering to MLIR + XLA backend compile (tracing nests
# across jit levels, so it is left in the warm time)
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")


@dataclasses.dataclass
class Sizes:
    """Fixture sizes.  The defaults are the real run; tests shrink them."""

    genes: int = 42_000          # BASELINE config 3: ~150k tx, ~300 Mbp
    se_reads: int = 3_000_000
    se_rl: int = 76
    se_slab_genes: int = 2_000   # NumPy SE oracle ~20 s
    se_slab_sort_limit: int = 1 << 22  # forces the radix-partitioned route
    pe_slab_genes: int = 150     # NumPy PE oracles ~1 min (ssfr + ns)
    pe_pairs: int = 300_000
    pe_rl: int = 101
    pe_fmin: int = 290
    pe_fmax: int = 300
    ms_samples: int = 3
    ms_reads: int = 300_000


# settings that choose a host path (a builder backend, the Python ingest)
HOST_PATH_ENV = ("EMSAR_BUILD_BACKEND", "EMSAR_NO_NATIVE")
# what a CLI prints when it takes a host path instead of the device builder
# or the native ingest library
HOST_PATH_LINES = ("[emsar-build] falling back",
                   "[emsar] native ingest build failed")


class CheckFailed(AssertionError):
    pass


class HostFallback(RuntimeError):
    pass


class Recorder:
    """Per-phase wall time split into compile and warm time, device memory,
    and pass/fail verdicts."""

    def __init__(self, device=None):
        import jax

        self.device = device
        self.compile_s = 0.0
        self._jax = jax
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def close(self):
        self._jax.monitoring.unregister_event_duration_listener(
            self._on_event)

    def _on_event(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.compile_s += duration

    def peak_bytes(self):
        stats = self.device.memory_stats() if self.device is not None \
            else None
        return None if not stats else stats.get("peak_bytes_in_use")

    @contextlib.contextmanager
    def phase(self, name: str):
        c0, t0 = self.compile_s, time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        comp = self.compile_s - c0
        print(f"[phase] {name}: wall {wall:.3f} s = compile {comp:.3f} s + "
              f"warm {wall - comp:.3f} s; peak_bytes_in_use (process so "
              f"far) {self.peak_bytes()}", flush=True)

    @staticmethod
    def check(name: str, ok: bool, detail: str) -> None:
        print(f"[check] {name}: {'PASS' if ok else 'FAIL'} ({detail})",
              flush=True)
        if not ok:
            raise CheckFailed(f"{name}: {detail}")


# --------------------------------------------------------------------------
# fixtures (generated from seeds, cached by seed and size)
# --------------------------------------------------------------------------


def _cached(path: str, make) -> str:
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        make(tmp)
        os.replace(tmp, path)
    return path


def fixture_fasta(cache: str, genes: int) -> str:
    from tools.make_scale_fixture import write_fixture

    def make(p):
        n_tx, bases = write_fixture(genes, p, seed=FIXTURE_SEED)
        print(f"[info] fixture: {genes} genes, {n_tx} transcripts, "
              f"{bases / 1e6:.1f} Mbp (seed {FIXTURE_SEED})", flush=True)
    return _cached(os.path.join(cache, f"fx_s{FIXTURE_SEED}_g{genes}.fa"),
                   make)


def se_reads(cache: str, genes: int, n: int, rl: int, seed: int) -> str:
    from tools.make_scale_reads import write_reads
    return _cached(
        os.path.join(cache, f"se_g{genes}_n{n}_l{rl}_s{seed}.bowtieout"),
        lambda p: write_reads(genes, n, rl, p, seed=seed))


def pe_bam(cache: str, genes: int, n: int, sz: Sizes, seed: int = 11) -> str:
    from tools.make_scale_pe_reads import write_pe_bam
    name = (f"pe_g{genes}_n{n}_l{sz.pe_rl}_F{sz.pe_fmin}-{sz.pe_fmax}"
            f"_s{seed}.bam")
    return _cached(os.path.join(cache, name),
                   lambda p: write_pe_bam(genes, n, sz.pe_rl, sz.pe_fmin,
                                          sz.pe_fmax, p, seed=seed))


def numpy_oracle_rsh(cache: str, fasta: str, tag: str, build) -> str:
    """The NumPy builder's .rsh for one fixture and configuration."""
    def make(p):
        from emsar_jax.io.fasta import read_fasta
        build(read_fasta(fasta, "E")).write_text(p)
    return _cached(os.path.join(cache, f"oracle_{tag}.rsh"), make)


# --------------------------------------------------------------------------
# guards: no host builder, no Python ingest, named device routes
# --------------------------------------------------------------------------


@contextlib.contextmanager
def no_host_paths():
    """Fail instead of falling back to a host builder backend or to the
    Python ingest path."""
    from emsar_jax.index import build as build_mod
    from emsar_jax.ingest import native

    for name in HOST_PATH_ENV:
        if os.environ.get(name):
            raise HostFallback(f"{name} is set: it would choose a host path")
    if not native.available():
        raise HostFallback("the native ingest library did not build "
                           "(g++ and zlib are required); the Python ingest "
                           "path would run")

    def refuse(cfg, backend, reason, tx=None):
        raise HostFallback(f"device builder fell back to the host "
                           f"'{backend}' backend: {reason}")

    saved = build_mod._warn_fallback
    build_mod._warn_fallback = refuse
    try:
        yield
    finally:
        build_mod._warn_fallback = saved


@contextlib.contextmanager
def route_probe(names: List[str]):
    """Count calls of named device_build functions (the route markers)."""
    from emsar_jax.index import device_build as db

    calls: Dict[str, list] = {n: [] for n in names}
    saved = {n: getattr(db, n) for n in names}

    def wrap(n, f):
        def counted(*a, **k):
            out = f(*a, **k)
            # keep plain results (capacity dicts), never device arrays
            calls[n].append(out if isinstance(out, dict) else None)
            return out
        return counted

    for n in names:
        setattr(db, n, wrap(n, saved[n]))
    try:
        yield calls
    finally:
        for n, f in saved.items():
            setattr(db, n, f)


@contextlib.contextmanager
def device_build_settings(pe_global_budget: Optional[int] = None,
                          env: Optional[Dict[str, str]] = None):
    from emsar_jax.index import device_build as db

    saved_budget = db.PE_GLOBAL_BUDGET
    saved_env = {k: os.environ.get(k) for k in (env or {})}
    if pe_global_budget is not None:
        db.PE_GLOBAL_BUDGET = pe_global_budget
    os.environ.update(env or {})
    try:
        yield
    finally:
        db.PE_GLOBAL_BUDGET = saved_budget
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# --------------------------------------------------------------------------
# quantify oracle: host float64 NumPy SQUAREM on the same likelihood
# --------------------------------------------------------------------------


def read_fpkm(path: str):
    """(names, FPKM, sd.of.FPKM, TPM) columns of an .fpkm file."""
    names, cols = [], []
    with open(path) as fh:
        next(fh)
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            names.append(f[0])
            cols.append((float(f[1]), float(f[2]), float(f[6])))
    a = np.asarray(cols, dtype=np.float64).reshape(-1, 3)
    return names, a[:, 0], a[:, 1], a[:, 2]


def collapse(index, path: str, fmt: str, pe: bool, strand_code: int):
    from emsar_jax.ingest.native import NativeCollapser
    rl = [index.readlength if index.readlength > 0 else -1]
    return NativeCollapser(index).collapse_file(
        path, fmt, pe, strand_code, 100, index.min_fraglength,
        index.max_fraglength, rl if pe else None)


def host_oracle(index, counts, max_cycles: int = 20000):
    """(problem, theta, loglik, seconds): the NumPy float64 SQUAREM run
    from the read-attribution start until a cycle gains < 1e-10."""
    from emsar_jax.config import QuantConfig
    from emsar_jax.model.quantify import _host_loglik, sample_problem
    from emsar_jax.model.solver import polish_host_f64

    t0 = time.perf_counter()
    p = sample_problem(index, counts, QuantConfig(verbose=0)).problem
    num0 = np.bincount(p.edge_tid, weights=p.edge_mult * p.reads[p.edge_cid],
                       minlength=p.n_transcripts)
    pos = p.denom > 0
    theta0 = np.where(pos, num0 / np.where(pos, p.denom, 1.0), 0.0)
    theta = polish_host_f64(p, theta0, epsilon=1e-10, max_cycles=max_cycles,
                            native=False)
    return p, theta, _host_loglik(p, theta), time.perf_counter() - t0


def _intensity(p, theta):
    s = np.bincount(p.edge_cid, weights=p.edge_mult * theta[p.edge_tid],
                    minlength=len(p.eumaps))
    return p.eumaps * s


def _gene_tpm(names, tpm):
    genes = np.asarray([n.rsplit("T", 1)[0] for n in names])
    uniq, inv = np.unique(genes, return_inverse=True)
    return np.bincount(inv, weights=tpm, minlength=len(uniq))


def compare_to_oracle(rec: Recorder, label: str, fpkm_path: str, oracle,
                      gene_tpm: bool = True) -> float:
    """Log-likelihood gap, segment intensities and gene TPM of a CLI
    output against the oracle; returns the output's log-likelihood."""
    from emsar_jax.model.quantify import _host_loglik

    p, theta_o, ll_o, _ = oracle
    names, fpkm, _, tpm = read_fpkm(fpkm_path)
    ll = _host_loglik(p, fpkm)
    gap = abs(ll - ll_o) / max(abs(ll_o), float(p.reads.sum()))
    rec.check(f"{label} log-likelihood vs float64 oracle", gap <= LL_RTOL,
              f"ours {ll:.6f}, oracle {ll_o:.6f}, relative gap {gap:.3e}, "
              f"tolerance {LL_RTOL:g}")
    lam, lam_o = _intensity(p, fpkm), _intensity(p, theta_o)
    m = p.reads > 0
    rel = float(np.max(np.abs(lam[m] - lam_o[m])
                       / np.maximum(lam_o[m], 1.0))) if m.any() else 0.0
    # segment intensities (expected reads per segment) are identifiable;
    # reported, not gated: slow EM directions leave small differences
    # that the likelihood gate already bounds
    print(f"[info] {label} segment intensities vs oracle: max "
          f"|dlam|/max(lam, 1 read) {rel:.3e} over {int(m.sum())} "
          f"read-bearing segments", flush=True)
    if gene_tpm:
        tot = theta_o.sum()
        tpm_o = theta_o * 1e6 / tot if tot > 0 else theta_o
        g, g_o = _gene_tpm(names, tpm), _gene_tpm(names, tpm_o)
        tv = float(np.abs(g - g_o).sum() / 2e6)
        rec.check(f"{label} gene TPM vs oracle", tv <= GENE_TPM_TV,
                  f"{len(g)} genes, max |dTPM| {np.abs(g - g_o).max():.4f}, "
                  f"moved share {tv:.3e}, tolerance {GENE_TPM_TV:g}")
    return ll


def _cli(module, argv: List[str]) -> None:
    """Run a CLI's main(argv) in this process; it must return 0."""
    rc = module.main(argv)
    if rc != 0:
        raise RuntimeError(f"{module.__name__} {argv} returned {rc}")


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# --------------------------------------------------------------------------
# one card
# --------------------------------------------------------------------------


class Smoke:
    """The one-card phases.  ``cache`` holds fixtures and oracles, ``work``
    this run's outputs."""

    def __init__(self, rec: Recorder, sizes: Sizes, cache: str, work: str):
        self.rec, self.sz, self.cache, self.work = rec, sizes, cache, work
        self.pe_rsh: Dict[str, str] = {}
        self.se_rsh: Optional[str] = None
        self.se_oracle = None

    def _dir(self, name):
        d = os.path.join(self.work, name)
        os.makedirs(d, exist_ok=True)
        return d

    def _build_cli(self, argv):
        from emsar_jax.cli import emsar_build
        _cli(emsar_build, argv)

    def _quant_cli(self, argv):
        from emsar_jax.cli import emsar
        _cli(emsar, argv)

    # (b) ------------------------------------------------------------------

    def phase_b(self):
        """Every device route of the builder, byte-compared with the NumPy
        builder on slabs of the human-scale fixture."""
        from emsar_jax.config import BuildConfig, StrandType
        from emsar_jax.index.build import build_pe_index, build_se_index
        from emsar_jax.io.fasta import read_fasta

        sz, rec = self.sz, self.rec
        se_fa = fixture_fasta(self.cache, sz.se_slab_genes)
        pe_fa = fixture_fasta(self.cache, sz.pe_slab_genes)
        out = self._dir("b")

        def se_cfg(limit=None):
            c = BuildConfig(verbose=0)
            c.strand = StrandType.parse("ns", False)
            if limit is not None:
                c.device_sort_limit = limit
            return c

        def pe_cfg(strand):
            c = BuildConfig(verbose=0, pe=True, min_fraglength=sz.pe_fmin,
                            max_fraglength=sz.pe_fmax)
            c.strand = StrandType.parse(strand, True)
            return c

        with rec.phase("b.numpy-oracles"):
            se_or = numpy_oracle_rsh(
                self.cache, se_fa,
                f"se_g{sz.se_slab_genes}_l{sz.se_rl}_ns",
                lambda tx: build_se_index(tx, sz.se_rl, sz.se_rl, se_cfg(),
                                          backend="numpy"))
            pe_or = {s: numpy_oracle_rsh(
                self.cache, pe_fa,
                f"pe_g{sz.pe_slab_genes}_l{sz.pe_rl}_F{sz.pe_fmin}-"
                f"{sz.pe_fmax}_{s}",
                lambda tx, s=s: build_pe_index(tx, sz.pe_rl, pe_cfg(s),
                                               backend="numpy"))
                for s in ("ssfr", "ns")}

        # SE single sort, through the CLI
        with rec.phase("b.se-single-sort"), \
                route_probe(["_sort_payload4", "_radix_dst"]) as calls:
            self._build_cli(["-q", se_fa, str(sz.se_rl), out, "se"])
        rec.check("b route SE single-sort taken",
                  len(calls["_sort_payload4"]) > 0 and not calls["_radix_dst"],
                  f"{len(calls['_sort_payload4'])} global sorts, "
                  f"{len(calls['_radix_dst'])} radix partitions")
        rec.check("b SE single-sort .rsh == NumPy builder",
                  _same_bytes(os.path.join(out, "se.rsh"), se_or),
                  "byte comparison")

        # SE radix-partitioned: a small per-sort budget (library call, the
        # CLI has no flag for it)
        tx_se = read_fasta(se_fa, "E")
        with rec.phase("b.se-radix-partitioned"), \
                route_probe(["_radix_dst"]) as calls:
            idx = build_se_index(tx_se, sz.se_rl, sz.se_rl,
                                 se_cfg(sz.se_slab_sort_limit))
            path = os.path.join(out, "se_part.rsh")
            idx.write_text(path)
        rec.check("b route SE radix-partitioned taken",
                  len(calls["_radix_dst"]) > 0,
                  f"{len(calls['_radix_dst'])} radix partitions, sort limit "
                  f"{sz.se_slab_sort_limit}")
        rec.check("b SE radix-partitioned .rsh == NumPy builder",
                  _same_bytes(path, se_or), "byte comparison")

        pe_args = ["-q", "--PE", "-f", str(sz.pe_fmin), "-F", str(sz.pe_fmax)]
        for strand in ("ssfr", "ns"):
            # PE delta-shift global (the default for streams in budget)
            name = f"pe_{strand}"
            with rec.phase(f"b.pe-global-{strand}"), \
                    route_probe(["_build_pe_global"]) as calls:
                self._build_cli(pe_args + ["-s", strand, pe_fa,
                                           str(sz.pe_rl), out, name])
            rec.check(f"b route PE global {strand} taken",
                      len(calls["_build_pe_global"]) == 1,
                      f"{len(calls['_build_pe_global'])} global builds")
            path = os.path.join(out, name + ".rsh")
            rec.check(f"b PE global {strand} .rsh == NumPy builder",
                      _same_bytes(path, pe_or[strand]), "byte comparison")
            self.pe_rsh[strand] = path
            # PE cluster-chunked: no global budget
            name = f"pe_{strand}_chunked"
            with rec.phase(f"b.pe-chunked-{strand}"), \
                    device_build_settings(pe_global_budget=0), \
                    route_probe(["_build_pe_global",
                                 "_pe_chunk_accum"]) as calls:
                self._build_cli(pe_args + ["-s", strand, pe_fa,
                                           str(sz.pe_rl), out, name])
            rec.check(f"b route PE cluster-chunked {strand} taken",
                      not calls["_build_pe_global"]
                      and len(calls["_pe_chunk_accum"]) > 0,
                      f"{len(calls['_pe_chunk_accum'])} chunk launches")
            rec.check(f"b PE cluster-chunked {strand} .rsh == NumPy builder",
                      _same_bytes(os.path.join(out, name + ".rsh"),
                                  pe_or[strand]), "byte comparison")

        # signature-table record path (the big-build accumulator), forced
        name = "pe_ssfr_sigtable"
        with rec.phase("b.pe-signature-table-ssfr"), \
                device_build_settings(pe_global_budget=0,
                                      env={"EMSAR_SIG_TABLE": "1"}), \
                route_probe(["_caps_partitioned",
                             "_pe_chunk_accum"]) as calls:
            self._build_cli(pe_args + ["-s", "ssfr", pe_fa, str(sz.pe_rl),
                                       out, name])
        sig = [c["SIGROWS"] for c in calls["_caps_partitioned"]]
        rec.check("b route signature table taken",
                  bool(sig) and min(sig) > 0
                  and len(calls["_pe_chunk_accum"]) > 0,
                  f"SIGROWS {sig}, {len(calls['_pe_chunk_accum'])} chunk "
                  f"launches")
        rec.check("b signature-table .rsh == NumPy builder",
                  _same_bytes(os.path.join(out, name + ".rsh"),
                              pe_or["ssfr"]), "byte comparison")

    # (c) + (d) for it -----------------------------------------------------

    def phase_c(self):
        """PE quantify of a simulated ssfr BAM against the slab's PE index,
        checked against the float64 oracle."""
        from emsar_jax.io.rsh import RshIndex

        sz, rec = self.sz, self.rec
        rsh = self.pe_rsh.get("ssfr")
        if rsh is None:
            raise RuntimeError("phase (b) produced no PE ssfr index")
        bam = pe_bam(self.cache, sz.pe_slab_genes, sz.pe_pairs, sz)
        out = self._dir("c")
        with rec.phase(f"c.pe-quantify ({sz.pe_pairs} pairs)"):
            self._quant_cli(["-q", "-P", "-B", "-s", "ssfr", "-I", rsh, out,
                             "s", bam])
        with rec.phase("d.pe-oracle (host float64)"):
            index = RshIndex.load(rsh)
            oracle = host_oracle(index, collapse(index, bam, "bam", True,
                                                 ord("+")))
        compare_to_oracle(rec, "c PE quantify", os.path.join(out, "s.0.fpkm"),
                          oracle)

    # (a) + (d) for it -----------------------------------------------------

    def phase_a(self):
        """Human-scale SE: emsar-build, then emsar -I on 3M reads."""
        from emsar_jax.io.rsh import RshIndex
        from emsar_jax.utils.timing import phase_times, reset_phases

        sz, rec = self.sz, self.rec
        with rec.phase(f"a.fixture ({sz.genes} genes, {sz.se_reads} reads; "
                       f"host)"):
            fa = fixture_fasta(self.cache, sz.genes)
            reads = se_reads(self.cache, sz.genes, sz.se_reads, sz.se_rl, 7)
        out = self._dir("a")
        with rec.phase(f"a.se-build l{sz.se_rl} ns ({sz.genes} genes)"):
            self._build_cli(["-q", fa, str(sz.se_rl), out, "scale"])
        rsh = os.path.join(out, "scale.rsh")
        index = RshIndex.load(rsh)
        print(f"[info] a: index {index.n_transcripts} transcripts, "
              f"{index.n_multi} multi signatures", flush=True)
        reset_phases()
        with rec.phase(f"a.se-quantify ({sz.se_reads} reads)"):
            self._quant_cli(["-q", "-I", rsh, out, "s", reads])
        _print_layers("a.se-quantify", phase_times())
        self.se_rsh, self.se_reads_path = rsh, reads
        with rec.phase("d.se-oracle (host float64)"):
            counts = collapse(index, reads, "bowtie", False, 0)
            self.se_oracle = host_oracle(index, counts)
        self.se_index, self.se_counts = index, counts
        compare_to_oracle(rec, "a SE quantify", os.path.join(out, "s.0.fpkm"),
                          self.se_oracle)

    # (e) ------------------------------------------------------------------

    def phase_e(self):
        """--solver_mode csr, --solver_dtype float64 and -M on the (a)
        problem, plus warm float32 vs float64 EM-solve times."""
        from emsar_jax.config import QuantConfig
        from emsar_jax.model.quantify import quantify_sample
        from emsar_jax.utils.timing import phase_times, reset_phases

        sz, rec = self.sz, self.rec
        if self.se_oracle is None:
            raise RuntimeError("phase (a) produced no SE problem")
        rsh, reads = self.se_rsh, self.se_reads_path
        for opt, val in (("--solver_mode", "csr"),
                         ("--solver_dtype", "float64")):
            out = self._dir(f"e_{val}")
            reset_phases()
            with rec.phase(f"e.quantify {opt} {val}"):
                self._quant_cli(["-q", opt, val, "-I", rsh, out, "s", reads])
            _print_layers(f"e.{val}", phase_times())
            compare_to_oracle(rec, f"e {opt} {val}",
                              os.path.join(out, "s.0.fpkm"), self.se_oracle)

        # warm EM-solve times on one problem (compiled by the runs above)
        times = {}
        for dt in ("float32", "float64"):
            cfg = QuantConfig(verbose=0, solver_dtype=dt, num_round=1)
            cfg.min_fraglength = self.se_index.min_fraglength
            cfg.max_fraglength = self.se_index.max_fraglength
            quantify_sample(self.se_index, self.se_counts, cfg)  # warm-up
            reset_phases()
            quantify_sample(self.se_index, self.se_counts, cfg)
            times[dt] = phase_times()["EM solve"]
        print(f"[info] e: warm EM solve on the (a) problem (both with the "
              f"host float64 polish): float32 {times['float32']:.3f} s, "
              f"float64 {times['float64']:.3f} s", flush=True)

        # -M over a few samples: restart rounds must populate sd.of.FPKM
        paths = [se_reads(self.cache, sz.genes, sz.ms_reads, sz.se_rl,
                          100 + i) for i in range(sz.ms_samples)]
        out = self._dir("e_multisample")
        lst = os.path.join(out, "samples.list")
        with open(lst, "w") as fh:
            fh.write("\n".join(paths) + "\n")
        with rec.phase(f"e.quantify -M ({sz.ms_samples} samples x "
                       f"{sz.ms_reads} reads)"):
            self._quant_cli(["-q", "-M", "-I", rsh, out, "s", lst])
        for i in range(sz.ms_samples):
            _, fpkm, sd, tpm = read_fpkm(os.path.join(out, f"s.{i}.fpkm"))
            ok = (np.isfinite(fpkm).all() and np.isfinite(sd).all()
                  and abs(tpm.sum() - 1e6) <= 1.0 and (sd > 0).any())
            rec.check(f"e -M sample {i}", ok,
                      f"TPM total {tpm.sum():.3f}, {int((sd > 0).sum())} "
                      f"transcripts with sd.of.FPKM > 0")

    # gpu-marked tests ------------------------------------------------------

    def phase_gpu_tests(self):
        """tests/test_gpu.py on the card, through pytest in this process
        (its conftest pins the CPU, so it is left out)."""
        import pytest

        class Outcomes:
            def __init__(self):
                self.passed, self.other = [], []

            def pytest_runtest_logreport(self, report):
                if report.passed and report.when == "call":
                    self.passed.append(report.nodeid)
                elif not report.passed:
                    self.other.append(f"{report.nodeid} {report.outcome}")

        got = Outcomes()
        with self.rec.phase("gpu-tests tests/test_gpu.py"):
            rc = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                              "--rootdir", REPO,
                              os.path.join(REPO, "tests", "test_gpu.py")],
                             plugins=[got])
        self.rec.check("tests/test_gpu.py on the card",
                       rc == 0 and got.passed and not got.other,
                       f"exit {rc}, {len(got.passed)} passed, not passed: "
                       f"{got.other}")


def _print_layers(label: str, times: Dict[str, float]) -> None:
    keys = ("building native ingest tables", "fragment-length weighting",
            "module decomposition", "problem build", "EM solve", "iEUMA",
            "restart rounds")
    parts = [f"{k} {times[k]:.3f} s" for k in keys if k in times]
    ingest = sum(v for k, v in times.items()
                 if k.startswith("reading alignment"))
    print(f"[layers] {label}: ingest {ingest:.3f} s; " + "; ".join(parts),
          flush=True)


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _wall_phase(name: str):
    """Wall time of a phase run by child processes (their compile time is
    not visible here)."""
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: wall {time.perf_counter() - t0:.3f} s (child "
          f"processes, compile included)", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_children(argvs: List[List[str]], envs: List[Dict[str, str]],
                 timeout: float) -> None:
    """Run CLI processes side by side (verbose, so that a host fallback
    shows); every one must exit 0 and take no host path.  All are killed
    if one fails or the time runs out."""
    procs = []
    try:
        for argv, env in zip(argvs, envs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m"] + argv, cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                .decode(errors="replace") for p in procs]
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"{' '.join(p.args[2:])} exited "
                                   f"{p.returncode}:\n{o[-3000:]}")
            hits = [ln for ln in o.splitlines()
                    if ln.startswith(HOST_PATH_LINES)]
            if hits:
                raise HostFallback(f"{' '.join(p.args[2:])}: {hits[0]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _child_env(platform: str, card: Optional[int], coord=None, nproc=1,
               pid=0) -> Dict[str, str]:
    """This process's environment without the host-path settings, for a
    child on ``platform`` that sees only ``card``."""
    env = {k: v for k, v in os.environ.items() if k not in HOST_PATH_ENV}
    env["JAX_PLATFORMS"] = platform
    if platform == "cpu":
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(card)
    if coord is not None:
        env.update(EMSAR_COORDINATOR=coord, EMSAR_NUM_PROCS=str(nproc),
                   EMSAR_PROCESS_ID=str(pid))
    return env


class MultiSmoke:
    """The four-card phases.  Until ``phase_batched`` this process stays
    off JAX's backends: each child process owns one card."""

    def __init__(self, sizes: Sizes, cache: str, work: str, n: int = 4,
                 platform: str = "cuda", timeout: float = 600.0):
        self.sz, self.cache, self.work = sizes, cache, work
        self.n, self.platform, self.timeout = n, platform, timeout

    def _card(self, i):
        return i if self.platform == "cuda" else None

    def phase_sharded_build(self):
        sz = self.sz
        fa = fixture_fasta(self.cache, sz.pe_slab_genes)
        argv = ["emsar_jax.cli.emsar_build", "--PE", "-s", "ssfr",
                "-f", str(sz.pe_fmin), "-F", str(sz.pe_fmax), fa,
                str(sz.pe_rl)]
        one = os.path.join(self.work, "build_1proc")
        many = os.path.join(self.work, f"build_{self.n}proc")
        with _wall_phase("m.pe-build 1 process"):
            run_children([argv + [one, "s"]],
                         [_child_env(self.platform, self._card(0))],
                         self.timeout)
        coord = f"localhost:{_free_port()}"
        with _wall_phase(f"m.pe-build {self.n} processes"):
            run_children([argv + [many, "s"]] * self.n,
                         [_child_env(self.platform, self._card(i), coord,
                                     self.n, i) for i in range(self.n)],
                         self.timeout)
        Recorder.check(f"m {self.n}-process PE build .rsh == 1 process",
                       _same_bytes(os.path.join(one, "s.rsh"),
                                   os.path.join(many, "s.rsh")),
                       "byte comparison of the merged index")

    def _samples(self, k, seed0):
        sz = self.sz
        return [se_reads(self.cache, sz.se_slab_genes, sz.ms_reads,
                         sz.se_rl, seed0 + i) for i in range(k)]

    def _slab_index(self):
        """The SE slab index, built by one child process."""
        sz = self.sz
        out = os.path.join(self.work, "se_index")
        rsh = os.path.join(out, "se.rsh")
        if not os.path.exists(rsh):
            fa = fixture_fasta(self.cache, sz.se_slab_genes)
            with _wall_phase("m.se-build 1 process"):
                run_children([["emsar_jax.cli.emsar_build", fa,
                               str(sz.se_rl), out, "se"]],
                             [_child_env(self.platform, self._card(0))],
                             self.timeout)
        return rsh

    def phase_shard_merge(self):
        rsh = self._slab_index()
        shards = self._samples(self.n, 200)
        lst = os.path.join(self.work, "shards.list")
        with open(lst, "w") as fh:
            fh.write("\n".join(shards) + "\n")
        argv = ["emsar_jax.cli.emsar", "-M", "--dist_merge_shards",
                "-I", rsh]
        one = os.path.join(self.work, "merge_1proc")
        many = os.path.join(self.work, f"merge_{self.n}proc")
        with _wall_phase("m.shard-merged quantify 1 process"):
            run_children([argv + [one, "s", lst]],
                         [_child_env(self.platform, self._card(0))],
                         self.timeout)
        coord = f"localhost:{_free_port()}"
        with _wall_phase(f"m.shard-merged quantify {self.n} processes"):
            run_children([argv + [many, "s", lst]] * self.n,
                         [_child_env(self.platform, self._card(i), coord,
                                     self.n, i) for i in range(self.n)],
                         self.timeout)
        # the merged counts are exact integers and the dense solve is
        # compiled without autotuning, so both outputs are byte-equal
        for f in ("s.0.fpkm", "s.0.fraglength_effect"):
            Recorder.check(f"m {self.n}-process shard-merged {f} == 1 "
                           f"process", _same_bytes(os.path.join(one, f),
                                                   os.path.join(many, f)),
                           "byte comparison")
        # and the merged run is right: against the oracle of the merged
        # counts
        from emsar_jax.io.rsh import RshIndex
        index = RshIndex.load(rsh)
        parts = [collapse(index, p, "bowtie", False, 0) for p in shards]
        merged = dataclasses.replace(
            parts[0],
            single_counts=sum(c.single_counts for c in parts),
            multi_counts=sum(c.multi_counts for c in parts),
            fraglength_counts=sum(c.fraglength_counts for c in parts),
            total_read_count=sum(c.total_read_count for c in parts))
        compare_to_oracle(Recorder, "m shard-merged 1 process",
                          os.path.join(one, "s.0.fpkm"),
                          host_oracle(index, merged))

    def phase_batched(self, rec: Recorder):
        """-M --batch_samples on a mesh of every device of this process vs
        the per-sample loop, each sample against its float64 oracle."""
        import jax

        from emsar_jax.cli import emsar
        from emsar_jax.io.rsh import RshIndex

        rsh = self._slab_index()
        samples = self._samples(self.n, 300)
        lst = os.path.join(self.work, "batch.list")
        with open(lst, "w") as fh:
            fh.write("\n".join(samples) + "\n")
        loop = os.path.join(self.work, "loop")
        batched = os.path.join(self.work, "batched")
        with rec.phase(f"m.-M per-sample loop ({len(samples)} samples, "
                       f"one device)"):
            _cli(emsar, ["-q", "-M", "-I", rsh, loop, "s", lst])
        with rec.phase(f"m.-M --batch_samples ({len(jax.devices())} "
                       f"devices)"):
            _cli(emsar, ["-q", "-M", "--batch_samples", "-I", rsh, batched,
                         "s", lst])
        index = RshIndex.load(rsh)
        for i, path in enumerate(samples):
            oracle = host_oracle(index, collapse(index, path, "bowtie",
                                                 False, 0))
            ll = {label: compare_to_oracle(rec, f"m sample {i} {label}",
                                           os.path.join(d, f"s.{i}.fpkm"),
                                           oracle, gene_tpm=False)
                  for label, d in (("loop", loop), ("batched", batched))}
            gap = abs(ll["batched"] - ll["loop"]) / max(
                abs(ll["loop"]), float(oracle[0].reads.sum()))
            rec.check(f"m sample {i} batched vs per-sample loop",
                      gap <= LL_RTOL, f"relative log-likelihood gap "
                      f"{gap:.3e}, tolerance {LL_RTOL:g}")


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def card_lines() -> List[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def require_gpu():
    """Pin JAX to CUDA; the first device must be a GPU.  No fallback."""
    import jax

    jax.config.update("jax_platforms", "cuda")
    jax.config.update("jax_enable_x64", True)
    try:
        devs = jax.devices()
    except Exception as e:  # noqa: BLE001 - any backend failure: no card
        raise SystemExit(f"chip_smoke: JAX found no CUDA device "
                         f"({type(e).__name__}: {e})")
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: first device is {devs[0]}, not a GPU")
    return devs


def run_phases(phases) -> List[str]:
    failed = []
    t_start = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            status = "passed"
        except Exception:  # noqa: BLE001 - reported, and the run fails
            traceback.print_exc()
            failed.append(name)
            status = "FAILED"
        print(f"[phase {name}] {status} in {time.perf_counter() - t0:.1f} s "
              f"(elapsed {time.perf_counter() - t_start:.1f} s)", flush=True)
    return failed


def _open_card():
    """(devices, Recorder) on the pinned CUDA backend, compile cache on."""
    devs = require_gpu()
    from emsar_jax.utils import jitcache
    jitcache.enable()
    return devs, Recorder(devs[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="four cards: only the multi-device paths")
    args = ap.parse_args(argv)
    sz = Sizes()
    lines = card_lines()
    for ln in lines:
        print(f"[card] {ln}", flush=True)
    os.makedirs(CACHE, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run_", dir=CACHE)
    try:
        if args.multi_gpu:
            multi = MultiSmoke(dataclasses.replace(sz, ms_reads=100_000),
                               CACHE, work, timeout=100.0)
            # children first: this process opens the cards only after
            failed = run_phases([("sharded-build", multi.phase_sharded_build),
                                 ("shard-merge", multi.phase_shard_merge)])
            devs, rec = _open_card()
            with no_host_paths():
                failed += run_phases([("batched",
                                       lambda: multi.phase_batched(rec))])
        else:
            devs, rec = _open_card()
            print(f"[info] phase (a) at full size: {sz.genes} genes, "
                  f"{sz.se_reads} reads (no cut)", flush=True)
            smoke = Smoke(rec, sz, CACHE, work)
            with no_host_paths():
                failed = run_phases([("b", smoke.phase_b),
                                     ("c", smoke.phase_c),
                                     ("a", smoke.phase_a),
                                     ("e", smoke.phase_e),
                                     ("gpu-tests", smoke.phase_gpu_tests)])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for ln in lines:
        print(f"[card] {ln}", flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}",
              file=sys.stderr, flush=True)
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
