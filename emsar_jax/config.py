"""Configuration objects mirroring the reference CLIs.

Defaults follow the reference flag tables (reference: src/emsar_main.c:64-91,
src/emsar_build_main.c:37-52).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# reference: src/emsar.h:14-23
MAX_NTID_PER_SID = 5000
EUMACUT_INCREMENT = 2.0
INIT_RSHBUCKET_MAX_T_SIZE = 10
MAX_N_ALNFILES = 1000


@dataclasses.dataclass
class StrandType:
    """Library strand type (reference: src/emsar_functions.c:16-22).

    ``code`` is 0 for unstranded, '+' / '-' for stranded, matching the
    reference's ``library_strand_type`` char.
    """

    name: str = "ns"
    code: int = 0  # 0, ord('+'), ord('-')

    @staticmethod
    def parse(s: str, pe: bool) -> "StrandType":
        table = {
            (False, "ns"): 0,
            (False, "ssf"): ord("+"),
            (False, "ssr"): ord("-"),
            (True, "ns"): 0,
            (True, "ssfr"): ord("+"),
            (True, "ssrf"): ord("-"),
        }
        key = (bool(pe), s)
        if key not in table:
            raise ValueError(f"invalid strand type {s!r} for {'PE' if pe else 'SE'}")
        return StrandType(name=s, code=table[key])

    @property
    def stranded(self) -> bool:
        return self.code != 0


@dataclasses.dataclass
class BuildConfig:
    """emsar-build options (reference: src/emsar_build_main.c)."""

    pe: bool = False
    strand: StrandType = dataclasses.field(default_factory=StrandType)
    min_fraglength: int = 1
    max_fraglength: int = 400
    max_repeat: int = 100
    header_fmt: str = "E"  # 'E' Ensembl | 'R' RefSeq
    binsize: int = 5000  # kept for CLI parity; the device build does not bin
    taglen: int = 2  # kept for CLI parity; radix partitioning is automatic
    max_threads: int = 1  # kept for CLI parity; XLA manages parallelism
    verbose: int = 1
    print_sfa: bool = False
    # device-build knobs
    chunk_positions: int = 1 << 20  # positions per device sort chunk
    pe_chunk_candidates: int = 1 << 24  # (position, d) candidates per PE chunk
    device_sort_limit: int = 1 << 28  # windows per device sort; larger
    # builds are hash-partitioned (device_build.build_se_index_device);
    # the PE rank pass clamps this to 1<<26 (its sort carries 6 operands)


@dataclasses.dataclass
class QuantConfig:
    """emsar quantifier options (reference: src/emsar_main.c:63-101)."""

    pe: bool = False
    strand: StrandType = dataclasses.field(default_factory=StrandType)
    multisample: bool = False
    aln_format: str = "bowtie"  # 'bowtie' | 'sam' | 'bam'
    min_fraglength: int = 1
    max_fraglength: int = 400
    max_repeat: int = 100
    header_fmt: str = "E"
    binsize: int = 5000
    taglen: int = 2
    # 0 = auto (one ingest thread per CPU; identical counts at any thread
    # count, unlike the reference's racy -p); -p N pins it
    max_threads: int = 0
    num_round: int = 4
    epsilon: float = 1e-9
    epsilon_stepsize: float = 1e-15
    delta: float = 0.0
    max_niter_mle: int = 200000
    max_nloop_mle: int = 100
    print_segments: bool = False
    print_sfa: bool = False
    print_rsh: bool = False
    posmodel: int = 0
    perpos_freq_len: int = 1000
    perpos_freq_impute_len: int = 200
    verbose: int = 1
    # device-solve knobs
    batch_samples: bool = False  # -M: one batched device solve over samples
    # -M + --dist_merge_shards: the file list holds shards of ONE sample;
    # each jax.distributed process ingests its slice, counts are merged
    # across hosts, process 0 writes the single output (parallel/dist.py)
    dist_merge_shards: bool = False
    solver_mode: str = "auto"  # 'auto' (dense batches + CSR rest) | 'csr'
    # 'auto': float64 on the CPU, float32 plus the host float64 polish on
    # a GPU (model/quantify.py::_resolve_dtype)
    solver_dtype: str = "auto"  # 'auto' | 'float32' | 'float64'
    solver_block_iters: int = 8  # SQUAREM cycles fused per convergence check
    rng_seed: Optional[int] = None
