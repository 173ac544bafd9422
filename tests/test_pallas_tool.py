"""tools/pallas_vs_xla.py: the Pallas form of the dense SQUAREM block
(interpret mode here) lands on the same likelihood as the XLA solve."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import pallas_vs_xla as P  # noqa: E402
from emsar_jax.model import dense as D  # noqa: E402


@pytest.mark.parametrize("C,T", D.SIZE_CLASSES[:2])
def test_pallas_block_matches_xla(C, T):
    batch, _ = D._pad_b(P.synth(C, T, 4, np.random.default_rng(C)))
    thx, _ = P.run_xla(batch, 1e-5)
    thp, _ = P.run_pallas(batch, 1e-5)
    llx, llp = P.loglik(batch, thx), P.loglik(batch, thp)
    assert abs(llp - llx) <= 1e-6 * max(abs(llx), float(batch.reads.sum()))
