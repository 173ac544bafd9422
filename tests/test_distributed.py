"""Multi-host distribution tests: per-process alignment shards, cross-host
count merge, process-0 output (parallel/dist.py).

The 2-process case runs two real `emsar` CLI processes wired through a
TCP coordinator (jax.distributed on the CPU backend) and must produce
outputs byte-identical to the single-process run over the same shards.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from emsar_jax.cli import emsar as emsar_cli
from tests.test_quantify_golden import _make_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _split_shards(tmp_path, aln, n_shards):
    """Split a bowtie file into shard files at read-group boundaries."""
    with open(aln) as fh:
        lines = fh.readlines()
    groups = []
    cur_id = None
    for ln in lines:
        rid = ln.split("\t", 1)[0]
        if rid != cur_id:
            groups.append([])
            cur_id = rid
        groups[-1].append(ln)
    paths = []
    for s in range(n_shards):
        p = str(tmp_path / f"shard{s}.bowtieout")
        with open(p, "w") as fh:
            for g in groups[s::n_shards]:
                fh.writelines(g)
        paths.append(p)
    listfile = str(tmp_path / "shards.list")
    with open(listfile, "w") as fh:
        fh.write("\n".join(paths) + "\n")
    return listfile


def test_dist_merge_shards_single_process(tmp_path):
    """--dist_merge_shards in one process: the in-process shard loop must
    reproduce the whole-file run exactly."""
    rng = np.random.default_rng(200)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=25, readlength=18,
                                pe=False, fraglen=18, n_reads=1200)
    listfile = _split_shards(tmp_path, aln, 3)

    whole = tmp_path / "whole"
    assert emsar_cli.main(["-q", "-I", rsh, str(whole), "s", aln]) == 0
    sharded = tmp_path / "sharded"
    assert emsar_cli.main(["-q", "-M", "--dist_merge_shards", "-I", rsh,
                           str(sharded), "s", listfile]) == 0
    a = (whole / "s.0.fpkm").read_bytes()
    b = (sharded / "s.0.fpkm").read_bytes()
    assert a == b


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dist_merge_shards_two_processes(tmp_path):
    """Two real CLI processes over a TCP coordinator produce outputs
    identical to the single-process sharded run."""
    rng = np.random.default_rng(201)
    _, rsh, aln = _make_fixture(tmp_path, rng, n_tx=25, readlength=18,
                                pe=False, fraglen=18, n_reads=1200)
    listfile = _split_shards(tmp_path, aln, 4)

    single = tmp_path / "single"
    assert emsar_cli.main(["-q", "-M", "--dist_merge_shards", "-I", rsh,
                           str(single), "s", listfile]) == 0

    port = _free_port()
    out2 = tmp_path / "two"
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
            EMSAR_COORDINATOR=f"127.0.0.1:{port}",
            EMSAR_NUM_PROCS="2",
            EMSAR_PROCESS_ID=str(pid),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "emsar_jax.cli.emsar", "-q", "-M",
             "--dist_merge_shards", "-I", rsh, str(out2), "s", listfile],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    a = (single / "s.0.fpkm").read_bytes()
    b = (out2 / "s.0.fpkm").read_bytes()
    assert a == b


def test_sharded_pe_build_in_process(tmp_path, monkeypatch):
    """Process-sharded PE build: per-shard partial indexes merged with
    RshIndex.merge must equal the unsharded build byte-for-byte (each
    mate1 cluster is owned by exactly one chunk, so shard counts are
    disjoint sums)."""
    from emsar_jax.config import BuildConfig, StrandType
    from emsar_jax.index import device_build
    from emsar_jax.index.build import build_pe_index
    from emsar_jax.io.fasta import build_transcriptome
    from emsar_jax.io.rsh import RshIndex
    from tests.util import random_transcriptome, write_fasta, run_ref_build

    monkeypatch.setattr(device_build, "PE_GLOBAL_BUDGET", 0)
    rng = np.random.default_rng(401)
    names, seqs = random_transcriptome(rng, 15, min_len=60, max_len=200,
                                       shared_frac=0.6)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    ref_rsh = run_ref_build(fasta, 18, str(tmp_path), "ref", pe=True,
                            extra=["-F", "60", "-f", "1", "-s", "ssfr"])
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(pe=True, strand=StrandType.parse("ssfr", True),
                      min_fraglength=1, max_fraglength=60, verbose=0)
    whole = build_pe_index(tx, 18, cfg, backend="device")
    parts = [build_pe_index(tx, 18, cfg, backend="device", shard=(i, 3))
             for i in range(3)]
    merged = RshIndex.merge(parts)
    a, b = str(tmp_path / "whole.rsh"), str(tmp_path / "merged.rsh")
    whole.write_text(a)
    merged.write_text(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(b, "rb").read() == open(ref_rsh, "rb").read()


def test_sharded_pe_build_two_processes(tmp_path):
    """Two real emsar-build CLI processes over a TCP coordinator produce
    a final .rsh byte-identical to the single-process build."""
    from tests.util import random_transcriptome, write_fasta
    from emsar_jax.cli import emsar_build as build_cli

    rng = np.random.default_rng(402)
    names, seqs = random_transcriptome(rng, 15, min_len=60, max_len=200,
                                       shared_frac=0.6)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)

    single = tmp_path / "single"
    assert build_cli.main(["-q", "--PE", "-s", "ssfr", "-f", "1", "-F",
                           "60", fasta, "18", str(single), "s"]) == 0

    port = _free_port()
    out2 = tmp_path / "two"
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
            EMSAR_COORDINATOR=f"127.0.0.1:{port}",
            EMSAR_NUM_PROCS="2",
            EMSAR_PROCESS_ID=str(pid),
            EMSAR_PE_GLOBAL_BUDGET="0",
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "emsar_jax.cli.emsar_build", "-q",
             "--PE", "-s", "ssfr", "-f", "1", "-F", "60", fasta, "18",
             str(out2), "s"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    a = (single / "s.rsh").read_bytes()
    b = (out2 / "s.rsh").read_bytes()
    assert a == b
