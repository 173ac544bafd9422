"""Drive the 337 Mbp human-scale device builds vs the reference goldens.

SE (default): l76 unstranded vs bench_cache/refscale76.rsh.
PE (--pe):    l101 F290-300 ssfr (the BASELINE config-4 slice) vs
              bench_cache/refscale_pe290p1.rsh — the SINGLE-THREADED
              reference output: at this scale the reference's -p 2 PE
              build loses single-EUMA increments to its unsynchronized
              bucket updates (BASELINE_MEASURED round-4), so -p 1 is the
              only valid byte-comparison target.

Generate fixtures first: tools/make_scale_fixture.py, then the
reference builds, e.g.
  emsar-build -q bench_cache/scale.fa 76 bench_cache refscale76
  emsar-build -q --PE -s ssfr -f 290 -F 300 bench_cache/scale.fa 101 \
      bench_cache refscale_pe290p1
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CACHE = os.path.join(REPO, "bench_cache")

from emsar_jax.utils import jitcache  # noqa: E402
jitcache.enable()
os.environ.setdefault("EMSAR_DEVBUILD_PROFILE", "1")

from emsar_jax.io.fasta import read_fasta  # noqa: E402
from emsar_jax.config import BuildConfig, StrandType  # noqa: E402
from emsar_jax.index.device_build import (build_pe_index_device,  # noqa: E402
                                          build_se_index_device)


def main():
    pe = "--pe" in sys.argv
    f1400 = "--f1400" in sys.argv
    t0 = time.perf_counter()
    tx = read_fasta(os.path.join(CACHE, "scale.fa"), "E")
    print(f"[scale] fasta read: {time.perf_counter()-t0:.1f}s  "
          f"{tx.n_transcripts} tx, {tx.borderpos/1e6:.0f} M fw chars",
          flush=True)
    t0 = time.perf_counter()
    if f1400:
        # BASELINE config 4, full range: PE l101 F1-400 ssfr, ~101 G
        # candidates (reference d-loop src/emsar_functions.c:2854-2872).
        # Golden: the reference's own -p 2 run (13,142 s) — its PE race
        # affects multi-thread runs; diffs are adjudicated against -p 1
        # semantics like the F290-300 case (BASELINE_MEASURED round-4).
        cfg = BuildConfig(verbose=2, pe=True, min_fraglength=1,
                          max_fraglength=400)
        cfg.strand = StrandType.parse("ssfr", True)
        idx = build_pe_index_device(tx, 101, cfg)
        golden = os.path.join(CACHE, "refscale_pe400.rsh")
        ours = os.path.join(CACHE, "scale_pe400.ours.rsh")
        ref_note = "reference: 13142 s -p2 (racy)"
    elif pe:
        cfg = BuildConfig(verbose=2, pe=True, min_fraglength=290,
                          max_fraglength=300)
        cfg.strand = StrandType.parse("ssfr", True)
        idx = build_pe_index_device(tx, 101, cfg)
        golden = os.path.join(CACHE, "refscale_pe290p1.rsh")
        ours = os.path.join(CACHE, "scale_pe290.ours.rsh")
        ref_note = "reference: 810 s -p2 (racy) / ~1300 s -p1"
    else:
        cfg = BuildConfig(verbose=2)
        cfg.strand = StrandType.parse("ns", False)
        idx = build_se_index_device(tx, 76, 76, cfg)
        golden = os.path.join(CACHE, "refscale76.rsh")
        ours = os.path.join(CACHE, "scale76.ours.rsh")
        ref_note = "reference: 577-675 s"
    t_build = time.perf_counter() - t0
    print(f"[scale] device build: {t_build:.1f}s", flush=True)
    t0 = time.perf_counter()
    idx.write_text(ours)
    print(f"[scale] write: {time.perf_counter()-t0:.1f}s", flush=True)
    same = open(ours, "rb").read() == open(golden, "rb").read()
    print(f"RESULT build={t_build:.1f}s identical={same} ({ref_note})",
          flush=True)


if __name__ == "__main__":
    main()
