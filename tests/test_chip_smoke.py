"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to
run without a GPU.  The real run happens on the card; here the phase
functions are called directly."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = cs.Sizes(genes=20, se_reads=5000, se_slab_genes=150,
                se_slab_sort_limit=1 << 19, pe_slab_genes=4, pe_pairs=3000,
                ms_samples=2, ms_reads=2000)


def _run(args, cwd, **env):
    """The script with no card visible, even on a machine that has one."""
    return subprocess.run([sys.executable] + args, cwd=cwd, timeout=300,
                          capture_output=True, text=True,
                          env=dict(os.environ, JAX_PLATFORMS="cpu",
                                   CUDA_VISIBLE_DEVICES="", **env))


def _printed_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return False
    try:
        return bool(json.loads(lines[-1]).get("ok"))
    except ValueError:
        return False


def test_script_refuses_without_gpu():
    r = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert r.returncode != 0 and not _printed_result(r.stdout)


def test_require_gpu_refuses_cpu_only_jax():
    r = _run(["-c", "import chip_smoke; chip_smoke.require_gpu()"], REPO)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr or "not a GPU" in r.stderr


def test_script_alone_refuses(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path),
             PYTHONPATH="")
    assert r.returncode != 0 and not _printed_result(r.stdout)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    rec = cs.Recorder(None)
    sm = cs.Smoke(rec, TINY, str(root / "cache"), str(root / "work"))
    with cs.no_host_paths():
        yield sm
    rec.close()


def test_phase_b_routes_match_numpy(smoke):
    """Every device route is taken and byte-equal to the NumPy builder."""
    smoke.phase_b()
    assert set(smoke.pe_rsh) == {"ssfr", "ns"}


def test_phase_c_pe_quantify_matches_oracle(smoke):
    if not smoke.pe_rsh:
        smoke.phase_b()
    smoke.phase_c()


def test_phase_a_and_e_match_oracle(smoke):
    smoke.phase_a()
    assert smoke.se_oracle is not None
    smoke.phase_e()


def test_oracle_catches_a_wrong_solution(smoke, tmp_path):
    """The likelihood check fails on an estimate that is off by 1%."""
    if smoke.se_oracle is None:
        smoke.phase_a()
    src = os.path.join(smoke.work, "a", "s.0.fpkm")
    bad = str(tmp_path / "bad.fpkm")
    with open(src) as fi, open(bad, "w") as fo:
        fo.write(next(fi))
        for i, ln in enumerate(fi):
            f = ln.rstrip("\n").split("\t")
            if i % 2 == 0:
                f[1] = f"{float(f[1]) * 1.01:.6f}"
            fo.write("\t".join(f) + "\n")
    with pytest.raises(cs.CheckFailed):
        cs.compare_to_oracle(smoke.rec, "perturbed", bad, smoke.se_oracle)


def test_host_fallback_is_refused(smoke):
    """A device-builder fallback to a host backend fails the phase."""
    from emsar_jax.index import build

    with pytest.raises(cs.HostFallback):
        build._warn_fallback(None, "jax", "forced")


def test_multi_gpu_phases_on_cpu(tmp_path):
    """The four-card phases' plumbing, with two CPU processes."""
    import jax

    ms = cs.MultiSmoke(TINY, str(tmp_path / "cache"), str(tmp_path / "w"),
                       n=2, platform="cpu", timeout=240)
    os.makedirs(ms.work)
    ms.phase_sharded_build()
    ms.phase_shard_merge()
    rec = cs.Recorder(jax.devices()[0])
    try:
        ms.phase_batched(rec)
    finally:
        rec.close()


@pytest.mark.parametrize("name", cs.HOST_PATH_ENV)
def test_host_path_setting_is_refused(monkeypatch, name):
    """A setting that picks a host path fails the guard, and child
    processes never inherit it."""
    monkeypatch.setenv(name, "numpy")
    with pytest.raises(cs.HostFallback, match=name):
        with cs.no_host_paths():
            pass
    assert name not in cs._child_env("cpu", None)


def test_child_host_fallback_is_refused(tmp_path):
    """A child CLI that prints a host-path line fails its phase: -T makes
    the builder fall back to a host backend."""
    fa = cs.fixture_fasta(str(tmp_path), 4)
    with pytest.raises(cs.HostFallback, match="falling back"):
        cs.run_children([["emsar_jax.cli.emsar_build", "-T", fa, "76",
                          str(tmp_path / "out"), "s"]],
                        [cs._child_env("cpu", None)], 240)
