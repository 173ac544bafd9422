"""Checks that only mean something on a GPU.  They skip elsewhere;
``chip_smoke.py`` runs this file on the card (without tests/conftest.py,
which pins the CPU)."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return devs[0]


def test_dense_einsums_are_not_tf32(gpu_device):
    """The dense solver's float32 products must run at full float32
    precision: TF32 (~1e-3 relative) would swamp the convergence
    epsilon.  Compared with a float64 NumPy product at a real size class."""
    import jax
    import jax.numpy as jnp

    from emsar_jax.model import dense

    rng = np.random.default_rng(0)
    B, (C, T) = 64, dense.SIZE_CLASSES[-1]
    m = (rng.random((B, C, T)) < 0.3).astype(np.float32)
    theta = rng.uniform(0.5, 2.0, size=(B, T)).astype(np.float32)
    reads = rng.uniform(1.0, 50.0, size=(B, C)).astype(np.float32)
    inv = rng.uniform(0.1, 1.0, size=(B, T)).astype(np.float32)
    with jax.default_device(gpu_device):
        got = np.asarray(jax.jit(dense._em_iter_dense)(
            jnp.asarray(m), jnp.asarray(reads), jnp.asarray(inv),
            jnp.asarray(theta)))
    m64, th64 = m.astype(np.float64), theta.astype(np.float64)
    s = np.einsum("bct,bt->bc", m64, th64)
    ratio = np.where(s > 0, reads / np.where(s > 0, s, 1.0), 0.0)
    want = th64 * np.einsum("bct,bc->bt", m64, ratio) * inv
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert rel.max() < 1e-5, rel.max()


@pytest.mark.parametrize("pe", [False, True])
def test_device_build_matches_numpy(gpu_device, tmp_path, pe):
    """Device builds are byte-identical to the NumPy builder on the card,
    where scatters run in parallel."""
    import jax

    from emsar_jax.config import BuildConfig, StrandType
    from emsar_jax.index.build import build_pe_index, build_se_index
    from emsar_jax.io.fasta import build_transcriptome
    from emsar_jax.sim import gene_family_transcriptome

    rng = np.random.default_rng(5)
    names, seqs, _ = gene_family_transcriptome(rng, 40, n_exons=6,
                                               min_exon=60, max_exon=200)
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(verbose=0, pe=pe, min_fraglength=60,
                      max_fraglength=90)
    cfg.strand = StrandType.parse("ns", pe)
    out = []
    for backend in ("device", "numpy"):
        with jax.default_device(gpu_device):
            idx = (build_pe_index(tx, 25, cfg, backend=backend) if pe
                   else build_se_index(tx, 25, 25, cfg, backend=backend))
        path = str(tmp_path / f"{backend}.rsh")
        idx.write_text(path)
        out.append(open(path, "rb").read())
    assert out[0] == out[1]
