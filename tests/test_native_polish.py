"""The C++ SQUAREM polish (csrc/solver.cc) must match the NumPy
implementation it mirrors (model/solver.py::polish_host_f64)."""

import numpy as np
import pytest

from emsar_jax.ingest import native as native_mod
from emsar_jax.model.solver import SolverProblem, polish_host_f64

pytestmark = pytest.mark.skipif(not native_mod.available(),
                                reason="native library unavailable")


def _random_problem(seed, C=4000, T=1200):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 5, C)
    e_cid = np.repeat(np.arange(C, dtype=np.int32), sizes)
    e_tid = rng.integers(0, T, len(e_cid)).astype(np.int32)
    mult = rng.integers(1, 3, len(e_cid)).astype(np.float64)
    E = rng.random(C) * 10
    R = rng.poisson(E * 2).astype(np.float64)
    denom = np.zeros(T)
    np.add.at(denom, e_tid, mult * E[e_cid])
    return SolverProblem(T, e_cid, e_tid, mult, E, R, denom)


def _loglik(p, th):
    s = np.zeros(len(p.eumaps))
    np.add.at(s, p.edge_cid, p.edge_mult * th[p.edge_tid])
    lam = p.eumaps * s
    m = lam > 0
    assert not ((~m) & (p.reads > 0)).any()
    return float(np.sum(p.reads[m] * np.log(lam[m]) - lam[m]))


@pytest.mark.parametrize("seed", [0, 1])
def test_native_polish_matches_numpy_per_cycle(seed):
    """Bounded cycle counts: the two implementations run the identical
    update sequence, so results agree to float rounding."""
    p = _random_problem(seed)
    th0 = np.where(p.denom > 0, 1.0, 0.0)
    for cycles in (1, 3, 10):
        a = polish_host_f64(p, th0, epsilon=1e-30, max_cycles=cycles,
                            native=False)
        b = polish_host_f64(p, th0, epsilon=1e-30, max_cycles=cycles,
                            native=True)
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12)


def test_native_polish_converges_to_same_optimum():
    """Run to convergence: the stopping cycle may differ by float-sum
    order, so compare the (identifiable) likelihood, not coordinates."""
    p = _random_problem(2)
    th0 = np.where(p.denom > 0, 1.0, 0.0)
    a = polish_host_f64(p, th0, epsilon=1e-9, max_cycles=500, native=False)
    b = polish_host_f64(p, th0, epsilon=1e-9, max_cycles=500, native=True)
    la, lb = _loglik(p, a), _loglik(p, b)
    assert abs(la - lb) <= 1e-7 * abs(la)
