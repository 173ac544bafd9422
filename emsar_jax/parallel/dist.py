"""Multi-process distribution runtime.

The reference is strictly single-process (SURVEY §2 C23); this layer is
new design per BASELINE.json's north star: per-process alignment shards
are collapsed locally into SampleCounts, merged across processes, and
the EM solve runs SPMD over the global device mesh with
``jax.lax.psum``-merged sufficient statistics.

Runbook (2 processes on one machine, one GPU each; on the CPU set
``JAX_PLATFORMS=cpu`` and drop ``CUDA_VISIBLE_DEVICES``):

    CUDA_VISIBLE_DEVICES=0 EMSAR_COORDINATOR=127.0.0.1:9911 \
    EMSAR_NUM_PROCS=2 EMSAR_PROCESS_ID=0 \
      emsar -q -M --dist_merge_shards -I idx.rsh out s shards.list &
    CUDA_VISIBLE_DEVICES=1 EMSAR_COORDINATOR=127.0.0.1:9911 \
    EMSAR_NUM_PROCS=2 EMSAR_PROCESS_ID=1 \
      emsar -q -M --dist_merge_shards -I idx.rsh out s shards.list &
    wait   # process 0 writes out/s.0.fpkm

Give each process its own card (``CUDA_VISIBLE_DEVICES``): a JAX process
reserves most of the memory of every card it can see.  ``shards.list``
lists alignment shards of ONE sample (e.g. a BAM split by read groups);
process i ingests lines i, i+N, ... and the merged counts equal the
single-process run's exactly.  On several hosts each host runs one
process per card and the same flags apply (coordinator on host 0).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def maybe_init_from_env() -> bool:
    """Initialize jax.distributed from EMSAR_{COORDINATOR,NUM_PROCS,
    PROCESS_ID}; returns True when running multi-process."""
    coord = os.environ.get("EMSAR_COORDINATOR")
    if not coord:
        return False
    import jax

    nprocs = int(os.environ["EMSAR_NUM_PROCS"])
    pid = int(os.environ["EMSAR_PROCESS_ID"])
    try:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nprocs, process_id=pid)
    except RuntimeError:
        pass  # already initialized
    return nprocs > 1


def process_index() -> int:
    import jax

    return jax.process_index()


def process_count() -> int:
    import jax

    return jax.process_count()


def is_main() -> bool:
    return process_index() == 0


def shard_list(items: List[str]) -> List[str]:
    """This process's strided slice of a work list."""
    return list(items[process_index()::process_count()])


def allreduce_counts(counts):
    """Sum SampleCounts across processes (cross-host collective on the
    global mesh); every process returns the identical merged counts.
    The dense solve of those counts is bitwise reproducible across
    processes and cards (``model/dense.py``, ``_COMPILE``), so process
    0 writes what a single-process run writes.  The CSR remainder's
    segment sums are scatter-adds, whose order a GPU does not fix."""
    import jax

    from ..ingest.collapse import SampleCounts

    if jax.process_count() == 1:
        return counts

    from jax.experimental import multihost_utils

    def reduce_one(arr: np.ndarray) -> np.ndarray:
        # gather per-process arrays, integer-sum on host: exact
        gathered = multihost_utils.process_allgather(arr)
        return np.sum(np.asarray(gathered), axis=0).astype(np.int64)

    return SampleCounts(
        single_counts=reduce_one(counts.single_counts),
        multi_counts=reduce_one(counts.multi_counts),
        fraglength_counts=reduce_one(counts.fraglength_counts),
        total_read_count=int(reduce_one(np.asarray(
            [counts.total_read_count]))[0]))


def barrier() -> None:
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("emsar_jax_barrier")
