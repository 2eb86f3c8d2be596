"""The port's threefry key chains (repro_torch.core.prng) against
jax.random on the CPU, bit for bit: key layout, split, bits and
categorical draws, one key over a batch (the one-shot path) and one key
per lane (the scheduler's vmap), over seeds up to one past 2^32 (keys
in the scheduler's [seed >> 32, seed & 0xffffffff] layout, which is
jax.random.PRNGKey's for seeds below 2^32). Gumbel floats agree within
1e-6 absolute (XLA and torch round log differently, by an ulp or two,
and -log(-log(u)) amplifies that near u = 1/e); the draws are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.serve.scheduler import _prng_keys

SEEDS = [0, 7, 2**31 + 3, 123456789012]


def _jkey(seed):
    return jnp.asarray(_prng_keys([seed])[0])


def _tkey(seed):
    return prng.prng_key(seed)


def test_key_layout_matches_prngkey():
    for seed in (0, 7, 2**31 - 1, 2**31, 3_000_000_000):
        np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                      np.asarray(jax.random.PRNGKey(seed)))
    for seed in SEEDS:
        np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                      _prng_keys([seed])[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_bits_bit_exact(seed):
    jk, tk = _jkey(seed), _tkey(seed)
    for _ in range(3):                   # along the chain
        want = np.asarray(jax.random.split(jk))
        new, sub = prng.split(tk)
        np.testing.assert_array_equal(new.numpy(), want[0])
        np.testing.assert_array_equal(sub.numpy(), want[1])
        bits = np.asarray(jax.random.bits(jk, (3, 1000)))
        np.testing.assert_array_equal(
            prng.random_bits(tk, 3000).reshape(3, 1000).numpy(), bits)
        jk, tk = jnp.asarray(want[0]), new
    g = np.asarray(jax.random.gumbel(jk, (3, 1000)))
    tg = prng.gumbel_from_bits(prng.random_bits(tk, 3000)).numpy()
    assert np.abs(tg.reshape(3, 1000) - g).max() <= 1e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_one_key_over_a_batch(seed):
    """sample_token's draw: split once per step, one categorical over
    the whole [B, V] array (counters across rows)."""
    logits = np.random.RandomState(seed % 997).randn(3, 1000).astype(
        np.float32)
    jk, tk = _jkey(seed), _tkey(seed)
    for _ in range(40):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        want = np.asarray(jax.random.categorical(jsub,
                                                 jnp.asarray(logits) / 0.8))
        got = prng.categorical(tsub, torch.from_numpy(logits) / 0.8)
        np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_one_key_per_lane():
    """sample_token_lanes' draw: vmap(split) and vmap(categorical), each
    lane's counters 0..V-1 under its own key; the chains advance 30
    steps."""
    keys = _prng_keys(SEEDS)
    logits = np.random.RandomState(1).randn(len(SEEDS), 1024).astype(
        np.float32)
    jk = jnp.asarray(keys)
    tk = torch.from_numpy(keys.astype(np.int64))
    for step in range(30):
        sp = jax.vmap(jax.random.split)(jk)
        new, sub = prng.split(tk)
        np.testing.assert_array_equal(new.numpy(), np.asarray(sp[:, 0]))
        np.testing.assert_array_equal(sub.numpy(), np.asarray(sp[:, 1]))
        want = jax.vmap(lambda k, l: jax.random.categorical(k, l / 0.8))(
            sp[:, 1], jnp.asarray(logits))
        got = prng.categorical_rows(sub, torch.from_numpy(logits) / 0.8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"step {step}")
        jk, tk = sp[:, 0], new
