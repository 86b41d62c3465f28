"""The port's Gumbel-max categorical sample
(urban_tpu_torch.models.policy.categorical_sample, torch's Philox stream)
against jax.random.categorical (threefry) on the same masked logits: the
HLG trainer's land-use width (E = 3000 edge slots, 40% of them masked to
MASK_PAD), one peaked row and one flat row, 40,000 draws of each from
each sampler.

The two streams give other draws, so they are held in distribution:
each sampler's counts against the exact softmax probabilities (a
chi-squared goodness-of-fit test, cells with an expected count under 5
pooled), and the two samplers' counts against each other (a chi-squared
test of homogeneity on the same cells), each at p > 1e-3. A masked action
is never drawn.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

from urban_tpu_torch.models.policy import MASK_PAD, categorical_sample

torch.set_num_threads(1)

WIDTH = 3000
DRAWS = 40_000
CHUNK = 5_000
P_MIN = 1e-3


def _row(kind):
    rng = np.random.default_rng(7)
    mask = rng.random(WIDTH) >= 0.4
    if kind == 'peaked':          # a handful of actions hold most mass
        logits = rng.normal(size=WIDTH) * 3.0
    else:                         # every legal action alike
        logits = np.full(WIDTH, 0.25)
    return np.where(mask, logits, MASK_PAD).astype(np.float32), mask


def _port_counts(logits):
    gen = torch.Generator().manual_seed(0)
    row = torch.as_tensor(logits)
    counts = np.zeros(WIDTH, np.int64)
    for _ in range(DRAWS // CHUNK):
        a = categorical_sample(row.expand(CHUNK, WIDTH), gen)
        counts += np.bincount(a.numpy(), minlength=WIDTH)
    return counts


def _jax_counts(logits):
    counts = np.zeros(WIDTH, np.int64)
    for key in jax.random.split(jax.random.PRNGKey(0), DRAWS // CHUNK):
        a = jax.random.categorical(key, jnp.asarray(logits), shape=(CHUNK,))
        counts += np.bincount(np.asarray(a), minlength=WIDTH)
    return counts


def _cells(p):
    """Cell index of each action: its own where the expected count is at
    least 5, one pooled cell for the rest."""
    own = p * DRAWS >= 5
    cell = np.full(WIDTH, own.sum())
    cell[own] = np.arange(own.sum())
    return cell, own.sum() + 1


@pytest.mark.parametrize('kind', ['peaked', 'flat'])
def test_port_sample_matches_jax_categorical_in_distribution(kind):
    logits, mask = _row(kind)
    z = np.exp(logits.astype(np.float64) - logits.max())
    p = z / z.sum()
    port, jx = _port_counts(logits), _jax_counts(logits)
    assert port.sum() == jx.sum() == DRAWS
    assert port[~mask].sum() == 0 and jx[~mask].sum() == 0
    cell, n_cells = _cells(p)
    expected = np.bincount(cell, weights=p, minlength=n_cells) * DRAWS
    assert n_cells > (5 if kind == 'peaked' else 1000)
    for name, counts in (('port', port), ('jax', jx)):
        observed = np.bincount(cell, weights=counts, minlength=n_cells)
        keep = expected > 0
        res = stats.chisquare(observed[keep], expected[keep])
        assert res.pvalue > P_MIN, (name, kind, res)
    table = np.stack([np.bincount(cell, weights=c, minlength=n_cells)
                      for c in (port, jx)])
    table = table[:, table.sum(0) > 0]
    res = stats.chi2_contingency(table)
    assert res.pvalue > P_MIN, (kind, res.statistic, res.pvalue)
