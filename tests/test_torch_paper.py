"""The port's paper scripts and examples against the JAX package's, on the
CPU at a tiny size.

Table 1, Fig. 5 and Fig. 5c are closed-form: every output line and the
returned values equal the JAX scripts' (``benchmarks/``).  The precision
assignment example's lines equal JAX's (``examples/``) for the same
architecture and shape.  ``quickstart`` and ``train_lowprec`` (its
supervisor leg included) exit 0 at a few steps.  ``fig6_convergence``'s
run is ``tests/test_torch_fig6.py``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(rel: str):
    """A JAX-side script of ``benchmarks/`` or ``examples/`` by path (neither
    folder is a package)."""
    path = os.path.join(REPO, rel)
    spec = importlib.util.spec_from_file_location(
        "jax_" + rel.replace("/", "_")[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


@pytest.mark.parametrize("name", ["table1_precisions", "fig5_variance_lost",
                                  "fig5c_chunk_sweep"])
def test_analysis_scripts_equal_jax(name):
    import importlib

    port = importlib.import_module(f"repro_torch.paper.{name}")
    ref = _jax_script(f"benchmarks/{name}.py")
    got, got_text = _stdout(port.run)
    want, want_text = _stdout(ref.run)
    assert got == want
    assert got_text == want_text
    assert got_text.count("\n") > 5


@pytest.mark.parametrize("argv", [[], ["--shape", "decode_32k", "--nzr",
                                       "0.5", "--m-p", "4"]])
def test_precision_assignment_equals_jax(monkeypatch, argv):
    from repro_torch.examples import precision_assignment as port

    ref = _jax_script("examples/precision_assignment.py")
    _, got = _stdout(port.main, argv)
    monkeypatch.setattr(sys, "argv", ["precision_assignment.py", "--arch",
                                      "qwen2-1.5b", *argv])
    _, want = _stdout(ref.main)
    assert got == want
    assert "qwen2-1.5b @" in got


def _run_module(*argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", *argv], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def test_quickstart_exits_0():
    p = _run_module("repro_torch.examples.quickstart", "--device", "cpu",
                    "--steps", "10")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "minimal m_acc for n=1048576" in p.stdout
    assert "step  10  loss" in p.stdout


def test_train_lowprec_with_supervisor_exits_0():
    p = _run_module("repro_torch.examples.train_lowprec", "--device", "cpu",
                    "--steps", "8", "--batch", "2", "--seq", "16")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "FAULT INJECTION: dying at step 4" in p.stdout
    assert "resumed from step 4" in p.stdout
    assert "supervisor exit: 0" in p.stdout
