#!/usr/bin/env python3
"""Bitwise reproducibility of one sample's quantify solve.

Merges the counts of single-end alignment shards (as ``emsar
--dist_merge_shards`` does), then runs the solver stages of
``quantify_sample`` twice in this process and prints, per run, a sha256
prefix of each stage's output: the device solve (dense size classes and
the CSR remainder apart), the host float64 polish and the restart rounds.

Run it in several processes, each with its own empty
``JAX_COMPILATION_CACHE_DIR``, and compare the lines.  Lines that agree
within a process but differ across processes point at compilation (for
example the GEMM autotuner's choice); lines that differ within a process
point at the execution itself (for example atomic scatter-adds).

Each line also gives the stages' wall times; the second run's are warm.
``--autotune`` compiles the dense solves with XLA's default GEMM
autotuning, which ``model/dense.py`` turns off, to time that choice
(compare processes with and without it on one machine, alternating).

    python tools/solve_determinism.py [--autotune] INDEX.rsh SHARD [...]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _h(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--autotune", action="store_true",
                    help="dense solves with XLA's default GEMM autotuning")
    ap.add_argument("index")
    ap.add_argument("shards", nargs="+")
    args = ap.parse_args(argv)
    from emsar_jax.cli.common import setup_jax
    setup_jax()
    import jax

    from emsar_jax.config import QuantConfig
    from emsar_jax.ingest.native import NativeCollapser
    from emsar_jax.io.rsh import RshIndex
    from emsar_jax.model import dense as D
    from emsar_jax.model import quantify as Q
    from emsar_jax.model.solver import polish_host_f64

    if args.autotune:
        for name in ("_dense_solve_jax", "_dense_restart_jax"):
            setattr(D, name, jax.jit(
                getattr(D, name).__wrapped__,
                static_argnames=("B", "C", "T", "block_iters", "max_blocks")))
    index = RshIndex.load(args.index)
    cfg = QuantConfig(verbose=0)
    cfg.min_fraglength = index.min_fraglength
    cfg.max_fraglength = index.max_fraglength
    col = NativeCollapser(index)
    parts = [col.collapse_file(p, "bowtie", False, 0, cfg.max_repeat,
                               cfg.min_fraglength, cfg.max_fraglength, None)
             for p in args.shards]
    counts = dataclasses.replace(
        parts[0], single_counts=sum(c.single_counts for c in parts),
        multi_counts=sum(c.multi_counts for c in parts),
        fraglength_counts=sum(c.fraglength_counts for c in parts),
        total_read_count=sum(c.total_read_count for c in parts))
    sp = Q.sample_problem(index, counts, cfg)
    dtype = Q._resolve_dtype(cfg)
    print(f"device {jax.devices()[0].device_kind}, solver dtype "
          f"{np.dtype(dtype).name}, XLA_FLAGS "
          f"{os.environ.get('XLA_FLAGS', '')!r}, GEMM autotuning "
          f"{'on' if args.autotune else 'off'}", flush=True)
    for rep in range(2):
        t0 = time.perf_counter()
        fpkm, blocks, part = Q._solve_auto(sp.graph, sp.modules, sp.eumaps,
                                           sp.read_count, sp.problem, cfg,
                                           dtype)
        t1 = time.perf_counter()
        dense = np.zeros(index.n_transcripts, dtype=bool)
        for b in part.batches:
            dense[b.tid_map[b.tid_map >= 0]] = True
        pol = polish_host_f64(sp.problem, fpkm,
                              epsilon=max(cfg.epsilon, 1e-9), max_cycles=200)
        t2 = time.perf_counter()
        rounds = Q._make_rounds(sp.problem, pol, cfg, dtype, part=part,
                                graph=sp.graph, modules=sp.modules,
                                eumaps=sp.eumaps, read_count=sp.read_count)
        t3 = time.perf_counter()
        print(f"run {rep}: classes {[b.shape for b in part.batches]}, "
              f"{len(part.csr_sids)} CSR modules, {blocks} blocks | dense "
              f"{_h(fpkm[dense])} csr {_h(fpkm[~dense])} polished "
              f"{_h(pol)} rounds {_h(rounds)} | device solve {t1 - t0:.4f} "
              f"s, host polish {t2 - t1:.4f} s, restart rounds "
              f"{t3 - t2:.4f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
