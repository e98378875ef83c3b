"""Port vs JAX package: the data pipeline and its random numbers.

``tests/test_data.py``'s invariants on the port's ``SyntheticLM`` (the JAX
assert on a seed mismatch is a ``ValueError`` here); ``repro_torch.data
.prng`` bitwise ``jax.random`` (raw threefry2x32 keys, partitionable
layout, 32-bit draws); and ``SyntheticLM``'s tokens bitwise the JAX
pipeline's over seeds, steps, host ids and vocabularies.  Tolerance: none,
every comparison is exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro_torch.data import prng
from repro_torch.data.pipeline import DataConfig, SyntheticLM

# --------------------------------------------------------------------------
# tests/test_data.py's invariants
# --------------------------------------------------------------------------


def test_batches_deterministic():
    c = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3)
    a = SyntheticLM(c).batch_at(7)["tokens"]
    b = SyntheticLM(c).batch_at(7)["tokens"]
    assert torch.equal(a, b)


def test_steps_differ():
    d = SyntheticLM(DataConfig(vocab_size=100, seq_len=16, global_batch=4))
    assert not torch.equal(d.batch_at(0)["tokens"], d.batch_at(1)["tokens"])


def test_tokens_in_vocab_range():
    c = DataConfig(vocab_size=37, seq_len=64, global_batch=8)
    t = SyntheticLM(c).batch_at(0)["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < 37
    assert t.dtype == torch.int32


def test_host_sharding_disjoint_and_covers():
    hosts = [SyntheticLM(DataConfig(vocab_size=100, seq_len=8, global_batch=8,
                                    host_id=h, n_hosts=2)).batch_at(5)["tokens"]
             for h in range(2)]
    assert all(t.shape == (4, 8) for t in hosts)
    assert not torch.equal(hosts[0], hosts[1])


def test_learnable_structure():
    # zero noise: the next token is a function of the current one only
    c = DataConfig(vocab_size=101, seq_len=128, global_batch=4, noise=0.0)
    t = SyntheticLM(c).batch_at(0)["tokens"].numpy()
    mapping = {}
    for row in t:
        for a, b in zip(row[:-1], row[1:]):
            assert mapping.setdefault(int(a), int(b)) == int(b)


def test_cursor_roundtrip():
    c = DataConfig(vocab_size=100, seq_len=8, global_batch=2, seed=9)
    d = SyntheticLM(c)
    next(d)
    next(d)
    d2 = SyntheticLM(c)
    d2.load_state_dict(d.state_dict())
    assert torch.equal(next(d)["tokens"], next(d2)["tokens"])


def test_seed_mismatch_rejected():
    d = SyntheticLM(DataConfig(vocab_size=10, seq_len=4, global_batch=2,
                               seed=1))
    with pytest.raises(ValueError):
        d.load_state_dict({"step": 0, "seed": 2})


def test_batch_not_divisible_raises():
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(vocab_size=10, seq_len=4, global_batch=3,
                               n_hosts=2))


# --------------------------------------------------------------------------
# prng bitwise jax.random
# --------------------------------------------------------------------------

SEEDS = (0, 1, 7919, 2 ** 31 - 1, -1, -2 ** 31, 2 ** 32 + 5)


def _keys():
    for s in SEEDS:
        yield s, jax.random.PRNGKey(s), prng.prng_key(s)


def _same(want, got: torch.Tensor) -> None:
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    if want.dtype == np.float32:
        want, got = want.view(np.uint32), got.view(np.uint32)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.dtype, got.dtype, want.shape, got.shape)
    np.testing.assert_array_equal(got, want)


def test_prng_key_fold_in_split_bitwise_jax():
    for _, jk, tk in _keys():
        _same(jk, tk)
        for d in (0, 1, 5, 2 ** 31, 2 ** 32 - 1):
            _same(jax.random.fold_in(jk, d), prng.fold_in(tk, d))
        for n in (1, 2, 3, 4, 9):
            _same(jax.random.split(jk, n), prng.split(tk, n))
    with pytest.raises(OverflowError):
        prng.fold_in(prng.prng_key(0), -1)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.prng_key(0), 2 ** 32)


@pytest.mark.parametrize("shape", [(), (5,), (2, 3, 4)])
def test_prng_draws_bitwise_jax(shape):
    spans = [(0, 1), (0, 10), (0, 151936), (0, 1001), (-5, 3), (7, 7), (3, 1),
             (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1), (0, 2 ** 16),
             (0, 2 ** 16 + 1)]
    for _, jk, tk in _keys():
        _same(jax.random.bits(jk, shape, jnp.uint32),
              prng.random_bits(tk, shape))
        for lo, hi in spans:
            _same(jax.random.randint(jk, shape, lo, hi),
                  prng.randint(tk, shape, lo, hi))
        for lo, hi in ((0.0, 1.0), (-2.5, 3.1), (1e-3, 7.0), (-1e6, 1e-6)):
            _same(jax.random.uniform(jk, shape, minval=lo, maxval=hi),
                  prng.uniform(tk, shape, lo, hi))
        for p in (0.0, 0.02, 0.05, 0.5, 1.0):
            _same(jax.random.bernoulli(jk, p, shape),
                  prng.bernoulli(tk, p, shape))
    for lo, hi in ((0, 2 ** 31), (-2 ** 31 - 1, 0)):
        with pytest.raises(OverflowError):
            jax.random.randint(jax.random.PRNGKey(0), shape, lo, hi)
        with pytest.raises(OverflowError):
            prng.randint(prng.prng_key(0), shape, lo, hi)


def test_prng_uniform_fma_large_draw():
    """The fused multiply-add of ``uniform``'s scaling over many draws
    (the sums that round differently unfused)."""
    jk, tk = jax.random.PRNGKey(42), prng.prng_key(42)
    for lo, hi in ((-2.5, 3.1), (0.1, 0.3), (-7.0, -3.0)):
        _same(jax.random.uniform(jk, (4096,), minval=lo, maxval=hi),
              prng.uniform(tk, (4096,), lo, hi))


# --------------------------------------------------------------------------
# SyntheticLM bitwise the JAX pipeline
# --------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [256, 151936, 1001])
def test_synthetic_lm_tokens_bitwise_jax(vocab):
    for seed in (0, 123):
        for host_id, n_hosts, batch in ((0, 1, 4), (0, 2, 4), (1, 2, 4),
                                        (2, 3, 3)):
            kw = dict(vocab_size=vocab, seq_len=33, global_batch=batch,
                      seed=seed, noise=0.05, host_id=host_id,
                      n_hosts=n_hosts)
            jd, td = JSyntheticLM(JDataConfig(**kw)), SyntheticLM(
                DataConfig(**kw))
            assert td.host_batch == jd.host_batch
            for step in (0, 1000):
                want = np.asarray(jd.batch_at(step)["tokens"])
                got = td.batch_at(step)["tokens"]
                _same(want, got)


def test_synthetic_lm_long_sequence_bitwise_jax():
    """One 4096-token batch at the full vocabulary and noise 0.02 (the
    convergence scripts' setting), through the iterator."""
    kw = dict(vocab_size=151936, seq_len=4096, global_batch=2, seed=5,
              noise=0.02)
    jd, td = JSyntheticLM(JDataConfig(**kw)), SyntheticLM(DataConfig(**kw))
    for _ in range(2):
        _same(next(jd)["tokens"], next(td)["tokens"])
