"""Shared CLI helpers."""

from __future__ import annotations

import os
import sys

# every EMSAR_* environment setting this version reads
KNOWN_ENV = frozenset({
    "EMSAR_BUILD_BACKEND", "EMSAR_COORDINATOR", "EMSAR_DEVBUILD_PROFILE",
    "EMSAR_EPS_CPU", "EMSAR_NO_NATIVE", "EMSAR_NUM_PROCS",
    "EMSAR_PE_FAST_SINGLES", "EMSAR_PE_GLOBAL_BUDGET", "EMSAR_PE_SLAB",
    "EMSAR_PROCESS_ID", "EMSAR_SIG_TABLE"})


def check_env() -> None:
    """Refuse EMSAR_* settings this version does not read.  A renamed or
    retired setting left in a launcher would otherwise change the run
    without a word: N independent quantifies instead of one sharded run,
    or the default builder backend instead of the one asked for."""
    unknown = sorted(k for k in os.environ
                     if k.startswith("EMSAR_") and k not in KNOWN_ENV)
    if unknown:
        die(f"error: unknown environment setting(s) {', '.join(unknown)}; "
            f"this version reads only {', '.join(sorted(KNOWN_ENV))}")


def setup_jax(enable_x64: bool = True) -> None:
    """Initialize JAX: 64-bit types, the multi-process runtime when its
    environment is set (``parallel/dist.py``), and the persistent compile
    cache (``utils/jitcache.py``).  Unknown EMSAR_* settings are refused
    first."""
    check_env()
    import jax

    if enable_x64:
        jax.config.update("jax_enable_x64", True)
    # jax.distributed must initialize before any backend use (no-op
    # without EMSAR_COORDINATOR)
    from ..parallel import dist
    dist.maybe_init_from_env()
    from ..utils import jitcache
    jitcache.enable()


def die(msg: str) -> None:
    print(msg, file=sys.stderr)
    raise SystemExit(1)
