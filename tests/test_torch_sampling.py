"""The port's on-device sampler (``repro_torch.serving.sampling``) against the
JAX package's ``serving/sampling.py`` on the CPU.

The threefry keys, ``fold_in``, the 32-bit draws and the uniforms are exact.
The Gumbel noise is within 2 ulps of ``gumbel_noise``, where an ulp of the
inner ``log`` reaches the noise as 2^-23 absolute (``d log y = dy / y``):
the port rounds each ``log`` correctly, XLA's f32 ``log`` is off by one ulp
for ~14% of inputs.  Tokens are equal to the reference's ``sample_tokens``
and its numpy ``sample_oracle`` on mixed greedy / temperature / top-k /
top-p batches, at a small vocab with tied logits and at granite's 49155.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.serving import sampling as jsampling

from repro_torch.serving import sampling

GUMBEL_ULPS = 2


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _seeds(n, rng):
    return (rng.integers(0, 2**31 - 1, n).astype(np.int64),
            rng.integers(0, 5000, n).astype(np.int64))


def test_keys_fold_in_and_bits_are_exact():
    seeds, idx = _seeds(12, np.random.default_rng(0))
    seeds[0], idx[0] = 0, 0
    seeds[1] = 2**31 - 2
    key = sampling.fold_in(sampling.prng_key(torch.from_numpy(seeds)),
                           torch.from_numpy(idx))
    bits = sampling.random_bits(key, 1500).numpy()
    for i, (s, d) in enumerate(zip(seeds, idx)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(int(s)), int(d))
        want = np.asarray(jax.random.key_data(jkey)).astype(np.int64)
        assert (int(key[0][i]), int(key[1][i])) == tuple(want)
        jbits = np.asarray(jax.random.bits(jkey, (1500,), jnp.uint32))
        np.testing.assert_array_equal(bits[i], jbits.astype(np.int64))


def test_uniform_is_exact():
    seeds, idx = _seeds(6, np.random.default_rng(1))
    key = sampling.fold_in(sampling.prng_key(torch.from_numpy(seeds)),
                           torch.from_numpy(idx))
    u = sampling.uniform(sampling.random_bits(key, 4000)).numpy()
    tiny = np.finfo(np.float32).tiny
    for i, (s, d) in enumerate(zip(seeds, idx)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(int(s)), int(d))
        want = np.asarray(jax.random.uniform(jkey, (4000,), jnp.float32,
                                             minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(u[i], want)
    # the extremes of the draw: all-zero and all-one mantissas
    edge = sampling.uniform(torch.tensor([0, 2**32 - 1])).numpy()
    assert edge[0] == tiny and edge[1] == np.float32(1.0) - 2.0**-23


@pytest.mark.parametrize("n", [97, 49155])
def test_gumbel_within_two_ulps(n):
    seeds, idx = _seeds(16, np.random.default_rng(n))
    want = np.asarray(jsampling.gumbel_noise(seeds, idx, n))
    got = sampling.gumbel_noise(torch.from_numpy(seeds),
                                torch.from_numpy(idx), n).numpy()
    assert got.dtype == np.float32 and got.shape == (16, n)
    bound = GUMBEL_ULPS * (np.spacing(np.abs(want)) + 2.0**-23)
    assert np.all(np.abs(got - want) <= bound)
    assert np.mean(got == want) > 0.5


def _batch(rng, b, v, tied):
    """Logits with one row of each policy kind (greedy, temperature, top-k,
    top-p, top-k + top-p), vocab-masked beyond ``v - 3``; ``tied``: values on
    a coarse grid, so ties sit at the top-k and nucleus thresholds."""
    x = rng.standard_normal((b, v)).astype(np.float32) * 3
    if tied:
        x = np.round(x * 2) / 2
    x[:, v - 3:] = -1e30
    kinds = np.arange(b) % 5
    temp = np.where(kinds == 0, 0.0, rng.uniform(0.5, 1.5, b)).astype(
        np.float32)
    topk = np.where((kinds == 2) | (kinds == 4), rng.integers(1, 20, b),
                    0).astype(np.int32)
    topp = np.where(kinds >= 3, rng.uniform(0.3, 0.95, b), 1.0).astype(
        np.float32)
    seeds, idx = _seeds(b, rng)
    return x, temp, topk, topp, seeds, idx.astype(np.int32)


@pytest.mark.parametrize("v,tied", [(64, True), (49155, False)])
def test_sample_tokens_match_reference_and_oracle(v, tied):
    rng = np.random.default_rng(v)
    x, temp, topk, topp, seeds, idx = _batch(rng, 10, v, tied)
    got = sampling.sample_tokens(
        torch.from_numpy(x), torch.from_numpy(temp), torch.from_numpy(topk),
        torch.from_numpy(topp), torch.from_numpy(seeds),
        torch.from_numpy(idx))
    assert got.dtype == torch.int32
    want = np.asarray(jsampling.sample_tokens(
        jnp.asarray(x), jnp.asarray(temp), jnp.asarray(topk),
        jnp.asarray(topp), jnp.asarray(seeds, jnp.uint32),
        jnp.asarray(idx)))
    oracle = jsampling.sample_oracle(x, temp, topk, topp,
                                     seeds.astype(np.uint32), idx)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracle)
    # greedy rows are the plain argmax, and pad lanes never come out
    greedy = temp <= 0
    np.testing.assert_array_equal(got.numpy()[greedy],
                                  np.argmax(x[greedy], -1))
    assert got.max() < v - 3


def test_request_seed_and_policy_errors_match_reference():
    for seed, rid in ((0, 0), (7, 3), (2**31 - 1, 10**6), (123456789, 42)):
        assert (sampling.request_seed(seed, rid)
                == jsampling.request_seed(seed, rid))
    for kw in ({"kind": "beam"}, {"kind": "temperature", "temperature": 0.0},
               {"kind": "top_k", "top_k": 0}, {"kind": "top_p", "top_p": 0.0},
               {"kind": "top_p", "top_p": 1.5}):
        with pytest.raises(ValueError) as mine:
            sampling.SamplingParams(**kw)
        with pytest.raises(ValueError) as ref:
            jsampling.SamplingParams(**kw)
        assert str(mine.value) == str(ref.value)
    for kw in ({}, {"kind": "temperature", "temperature": 0.7},
               {"kind": "top_k", "top_k": 5, "top_p": 0.3},
               {"kind": "top_p", "top_p": 0.9, "top_k": 4}):
        assert (sampling.SamplingParams(**kw).row()
                == jsampling.SamplingParams(**kw).row())
    assert sampling.SAMPLING_KINDS == jsampling.SAMPLING_KINDS
