"""The port's threefry random numbers (``ops.prng``) against ``jax.random``.

JAX 0.9.0 runs threefry in its partitionable mode
(``jax_threefry_partitionable``, asserted below). The integer words (keys,
splits, random bits, the uniform floats made from them) must equal JAX's
bit for bit; the Gumbel noise goes through two ``log``s, whose last bit may
differ between XLA's CPU ``log`` and torch's, so it is held to an absolute
2e-6 (worst seen: 4.8e-7 over 100,000 draws) and the ``categorical``
tokens drawn with it exactly. ``chip_smoke.PRNG_WORDS`` writes a few words
down for the card, where there is no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops import prng as P

SEEDS = [0, 1, 11, 12345, 2**31 - 1, 2**31, 2**32 - 1]


def _jkey(seed):
    return jax.random.PRNGKey(np.uint32(seed))


def _np(t):
    return t.numpy().astype(np.uint64)


def test_jax_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    k = P.prng_key(seed)
    np.testing.assert_array_equal(_np(k), np.asarray(_jkey(seed)))
    for n in (2, 5):
        np.testing.assert_array_equal(
            _np(P.split(k, n)), np.asarray(jax.random.split(_jkey(seed), n)))
    # a chain of splits, as the engine fast-forwards a replayed request
    jk, tk = _jkey(seed), k
    for _ in range(4):
        jk = jax.random.split(jk)[0]
        tk = P.split(tk)[0]
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))


def test_batched_split_matches_vmap():
    keys = torch.stack([P.prng_key(s) for s in SEEDS])
    jkeys = jnp.stack([_jkey(s) for s in SEEDS])
    np.testing.assert_array_equal(
        _np(P.split(keys)), np.asarray(jax.vmap(jax.random.split)(jkeys)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4)])
def test_random_bits_match_jax(shape):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            _np(P.random_bits(P.prng_key(seed), shape)),
            np.asarray(jax.random.bits(_jkey(seed), shape)))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (float(np.finfo(np.float32)
                                                     .tiny), 1.0),
                                   (-2.0, 3.0)])
def test_uniform_matches_jax_bit_for_bit(lo, hi):
    for seed in SEEDS:
        got = P.uniform(P.prng_key(seed), (4, 257), lo, hi).numpy()
        want = np.asarray(jax.random.uniform(_jkey(seed), (4, 257),
                                             minval=lo, maxval=hi))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert got.min() >= lo and got.max() < hi


def test_gumbel_matches_jax_within_tolerance():
    worst = 0.0
    for seed in (0, 3, 2**31, 2**32 - 1):
        got = P.gumbel(P.prng_key(seed), (100000,)).numpy()
        want = np.asarray(jax.random.gumbel(_jkey(seed), (100000,)))
        assert np.isfinite(got).all()
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= 2e-6, worst


def _logits(rng, shape, n_inf):
    lg = rng.standard_normal(shape).astype(np.float32) * 3
    flat = lg.reshape(-1, shape[-1])
    for row in flat:
        row[rng.choice(shape[-1], n_inf, replace=False)] = -np.inf
    return lg


@pytest.mark.parametrize("shape", [(97,), (4, 1000)])
def test_categorical_tokens_match_jax(shape):
    rng = np.random.default_rng(0)
    for seed in SEEDS:
        lg = _logits(rng, shape, shape[-1] // 3)
        got = P.categorical(P.prng_key(seed), torch.from_numpy(lg)).numpy()
        want = np.asarray(jax.random.categorical(_jkey(seed), lg))
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(np.take_along_axis(
            lg.reshape(-1, shape[-1]), got.reshape(-1, 1), -1)).all()


def test_categorical_rows_match_vmap():
    rng = np.random.default_rng(1)
    lg = _logits(rng, (len(SEEDS), 512), 400)
    keys = torch.stack([P.prng_key(s) for s in SEEDS])
    jkeys = jnp.stack([_jkey(s) for s in SEEDS])
    for _ in range(3):
        got = P.categorical_rows(keys, torch.from_numpy(lg)).numpy()
        want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, lg))
        np.testing.assert_array_equal(got, want)
        keys = P.split(keys)[:, 0]
        jkeys = jax.vmap(jax.random.split)(jkeys)[:, 0]


def test_known_words_equal_jax_and_the_port():
    """``chip_smoke.PRNG_WORDS`` (what the card is held to) against JAX
    and against the port on the CPU."""
    K = _jkey
    jax_words = {
        "split(PRNGKey(11))": jax.random.split(K(11)),
        "split(PRNGKey(2**32 - 1))": jax.random.split(K(2**32 - 1)),
        "split(PRNGKey(2**31), 3)": jax.random.split(K(2**31), 3),
        "bits(PRNGKey(0), (5,))": jax.random.bits(K(0), (5,)),
        "bits(PRNGKey(7), (300000,))[-3:]":
            jax.random.bits(K(7), (300000,))[-3:],
    }
    assert {k: np.asarray(v).tolist() for k, v in jax_words.items()} \
        == chip_smoke.PRNG_WORDS
    assert chip_smoke.prng_words(P, "cpu") == chip_smoke.PRNG_WORDS
