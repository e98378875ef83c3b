"""The port's counterpart of ``tests/test_below_knee.py``: at ``m_acc =
knee - 2`` SR training through the port's ``qdot`` reaches the
wide-accumulator loss while RNE stalls.

It is the suite's longest test (93 SR ``qdot`` steps through the plain
versions at K 8192), so it has a file of its own: under ``--dist
loadfile`` it then runs on a worker apart from the rest of
``tests/test_torch_sr.py``, whose helper ``below_knee_losses`` it uses.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_sr import below_knee_losses


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the test's many small plain-version ops gain
    nothing from every core, and beside other pytest workers a full-width
    OpenMP pool each oversubscribes the cores (measured on 8 cores: this
    file and the other long one side by side took about 500 s each at 8
    threads, 20-30 s at 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
def test_below_knee_sr_converges_where_rne_swamps():
    """At ``m_acc = knee - 2`` SR training reaches the wide-accumulator
    loss (within 2x) while RNE stalls far above it (the JAX gate)."""
    wide, rne, sr = below_knee_losses()
    assert rne > 5 * wide, (wide, rne)
    assert sr < 2 * wide, (wide, sr)
    assert sr < 0.25 * rne, (rne, sr)
