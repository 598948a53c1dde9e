"""The port's sampler against the JAX package's, on the CPU.

JAX keys and ``torch.Generator``s draw different bits from one seed, so the
greedy path is compared exactly and the sampled paths by their distribution:
on a vocabulary of 8, each side's frequencies over 20000 draws must lie
within 0.02 of the exact probabilities (about 7 standard errors at p = 0.5)
and put no mass outside the top-k / top-p support.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.serving.sampler import sample as jax_sample
from opsagent_tpu_torch.serving.sampler import sample

V, DRAWS, TOL = 8, 20000, 0.02
LOGITS = np.array([2.0, 1.5, 1.0, 0.2, -0.5, -1.0, 0.7, -2.0], np.float32)


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def _draw(temperature, top_k, top_p):
    """Frequencies of DRAWS tokens from each sampler, one row per draw."""
    logits = np.tile(LOGITS, (DRAWS, 1))
    t = np.full((DRAWS,), temperature, np.float32)
    k = np.full((DRAWS,), top_k, np.int32)
    p = np.full((DRAWS,), top_p, np.float32)
    jt = np.asarray(jax_sample(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(t),
        jnp.asarray(k), jnp.asarray(p),
    ))
    tt = sample(
        torch.from_numpy(logits), torch.Generator().manual_seed(0),
        torch.from_numpy(t), torch.from_numpy(k), torch.from_numpy(p),
    ).numpy()
    return (np.bincount(jt, minlength=V) / DRAWS,
            np.bincount(tt, minlength=V) / DRAWS)


def test_greedy_is_exact():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 300)).astype(np.float32)
    zeros = np.zeros((16,), np.float32)
    jt = np.asarray(jax_sample(
        jnp.asarray(logits), jax.random.PRNGKey(1), jnp.asarray(zeros),
        jnp.zeros((16,), jnp.int32), jnp.ones((16,), jnp.float32),
    ))
    tt = sample(
        torch.from_numpy(logits), torch.Generator().manual_seed(1),
        torch.from_numpy(zeros), torch.zeros(16, dtype=torch.int32),
        torch.ones(16),
    ).numpy()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tt, logits.argmax(-1))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0),      # full-vocab Gumbel-argmax
    (1.0, 3, 1.0),      # top-k
    (1.0, 0, 0.6),      # top-p
])
def test_sampled_distributions_match(temperature, top_k, top_p):
    probs = _softmax(LOGITS / temperature)
    order = np.argsort(-probs)
    keep = np.zeros(V, bool)
    if top_k:
        keep[order[:top_k]] = True
    else:
        keep[order[np.cumsum(probs[order]) - probs[order] < top_p]] = True
    want = np.where(keep, probs, 0.0)
    want /= want.sum()
    jf, tf = _draw(temperature, top_k, top_p)
    assert np.abs(jf - want).max() < TOL
    assert np.abs(tf - want).max() < TOL
    assert tf[~keep].sum() == 0 and jf[~keep].sum() == 0
