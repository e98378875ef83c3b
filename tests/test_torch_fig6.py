"""``repro_torch.paper.fig6_convergence.run(steps=6)`` on the CPU returns
finite deltas and the four tails.

It trains the smoke model 4 x 6 steps through the plain versions, most of
``tests/test_torch_paper.py``'s time once, so it has a file of its own:
under ``--dist loadfile`` it then runs on a worker apart from the other
paper scripts.
"""

from __future__ import annotations

import math

import pytest
import torch

from test_torch_paper import _stdout


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


def test_fig6_run_returns_finite_deltas():
    from repro_torch.paper.fig6_convergence import run

    out, text = _stdout(run, steps=6, device="cpu")
    assert math.isfinite(out["pp0_delta"]) and out["pp0_delta"] >= 0
    assert math.isfinite(out["pp-4_delta"])
    assert set(out["tails"]) == {"exact", "PP= 0", "PP=-2", "PP=-4"}
    assert all(math.isfinite(v) for v in out["tails"].values())
    assert "predictions" in text.splitlines()[-1]
