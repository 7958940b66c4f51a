"""Port parity: the batched samplers (core/sampling.py
`make_batched_sampler`, `batched_filter_logits`, `batched_filtered_probs`).

Logits come from numpy with a seed, with no two equal in a row and no
exclusive cumulative probability within 1e-4 of a row's top_p, so that
the stable sort's tie order and f32 summation order cannot decide what a
filter keeps.  The keep-masks and kept logits must equal the JAX
package's, the filtered distributions agree within 1e-6; greedy rows
(temp 0) take the argmax of the unfiltered logits; drawn rows follow
softmax(filtered / temp) by a chi-square test at a fixed seed (p > 1e-3
with 20,000 draws a row), and are exactly torch.multinomial's draws from
the same generator state.
"""

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.core import sampling as jsampling
from mlx_vlm_tpu_torch.core import sampling as tsampling

torch.set_num_threads(2)

V = 300
# per-row parameter sets: (temp, top_p, min_p, top_k)
PARAM_SETS = {
    "mixed": [(0.0, 0.0, 0.0, -1), (1.0, 0.9, 0.0, -1), (0.7, 0.0, 0.05, -1),
              (1.3, 0.0, 0.0, 20), (0.9, 0.8, 0.02, 50), (0.5, 0.95, 0.1, 5)],
    "off": [(1.0, 0.0, 0.0, -1), (0.8, 1.0, 0.0, 0), (0.0, 0.0, 0.0, -1)],
    "tight": [(1.0, 0.3, 0.0, -1), (1.0, 0.0, 0.5, -1), (1.0, 0.0, 0.0, 1),
              (2.0, 0.5, 0.2, 3)],
}


def _params(rows, lib):
    cols = list(zip(*rows))
    if lib == "jax":
        return {"temp": jnp.asarray(cols[0], jnp.float32),
                "top_p": jnp.asarray(cols[1], jnp.float32),
                "min_p": jnp.asarray(cols[2], jnp.float32),
                "top_k": jnp.asarray(cols[3], jnp.int32)}
    return {"temp": torch.tensor(cols[0], dtype=torch.float32),
            "top_p": torch.tensor(cols[1], dtype=torch.float32),
            "min_p": torch.tensor(cols[2], dtype=torch.float32),
            "top_k": torch.tensor(cols[3], dtype=torch.int64)}


def _top_p_clear(x, rows, gap=1e-4) -> bool:
    """No row's exclusive cumulative probability lies within `gap` of its
    top_p (in float64)."""
    for r, (_, top_p, _, _) in zip(x, rows):
        if 0 < top_p < 1:
            p = np.sort(np.exp(r - r.max()).astype(np.float64))[::-1]
            p /= p.sum()
            if np.abs(np.cumsum(p) - p - top_p).min() <= gap:
                return False
    return True


def _logits(rows, seed, scale=2.0, n=V):
    """Seeded logits [len(rows), n] with no ties in a row and every row's
    top_p boundary broken away from the exclusive cumulative sums: draws
    from the seeded generator until both hold."""
    rng = np.random.default_rng(seed)
    while True:
        x = (rng.standard_normal((len(rows), n)) * scale).astype(np.float32)
        if (all(len(np.unique(r)) == n for r in x)
                and _top_p_clear(x, rows)):
            return x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(PARAM_SETS))
def test_batched_filter_logits_matches_jax(case, seed):
    rows = PARAM_SETS[case]
    x = _logits(rows, seed)
    ref = np.asarray(jsampling.batched_filter_logits(jnp.asarray(x),
                                                     _params(rows, "jax")))
    got = tsampling.batched_filter_logits(torch.from_numpy(x),
                                          _params(rows, "torch")).numpy()
    keep = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), keep)
    assert np.array_equal(got[keep], ref[keep])
    assert np.all(got[~keep] == -np.inf)
    assert keep.sum(axis=1).min() >= 1


@pytest.mark.parametrize("case", list(PARAM_SETS))
def test_batched_filtered_probs_matches_jax(case):
    rows = PARAM_SETS[case]
    T = 3
    x = np.stack([_logits(rows, 10 + t) for t in range(T)], axis=1)
    ref = np.asarray(jsampling.batched_filtered_probs(jnp.asarray(x),
                                                      _params(rows, "jax")))
    got = tsampling.batched_filtered_probs(torch.from_numpy(x),
                                           _params(rows, "torch")).numpy()
    assert got.shape == (len(rows), T, V)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_greedy_rows_take_the_unfiltered_argmax():
    """temp 0 rows ignore their filters and the generator."""
    rows = [(0.0, 0.3, 0.5, 2), (0.0, 0.0, 0.0, -1)]
    x = _logits(rows, 5)
    sample = tsampling.make_batched_sampler()
    for seed in range(3):
        got = sample(torch.from_numpy(x), _params(rows, "torch"),
                     torch.Generator().manual_seed(seed))
        assert got.tolist() == x.argmax(-1).tolist()
    ref = jsampling.make_batched_sampler()(
        jnp.asarray(x), _params(rows, "jax"), jax.random.PRNGKey(0))
    assert np.asarray(ref).tolist() == x.argmax(-1).tolist()


DRAWS = 20000


@pytest.mark.parametrize("case", ["mixed", "tight"])
def test_drawn_rows_follow_the_filtered_softmax(case):
    """Each drawn row, 20,000 times from one generator seeded 0, against
    softmax(filtered / temp) of the JAX package's filter: no token outside
    the keep-mask, and a chi-square goodness of fit with p > 1e-3."""
    rows = [r for r in PARAM_SETS[case] if r[0] > 0]
    x = _logits(rows, 7, scale=1.0, n=24)
    B, n = len(rows), x.shape[1]
    filt = np.asarray(jsampling.batched_filter_logits(
        jnp.asarray(x), _params(rows, "jax")), np.float64)
    temps = np.array([r[0] for r in rows])[:, None]
    want = np.exp((filt - filt.max(-1, keepdims=True)) / temps)
    want /= want.sum(-1, keepdims=True)
    big = torch.from_numpy(np.tile(x, (DRAWS, 1)))
    params = {k: v.repeat(DRAWS) for k, v in _params(rows, "torch").items()}
    toks = tsampling.make_batched_sampler()(
        big, params, torch.Generator().manual_seed(0)).numpy().reshape(
            DRAWS, B)
    for b in range(B):
        counts = np.bincount(toks[:, b], minlength=n)
        kept = want[b] > 0
        assert counts[~kept].sum() == 0
        if kept.sum() == 1:
            assert counts[kept].sum() == DRAWS
            continue
        chi2 = stats.chisquare(counts[kept], DRAWS * want[b][kept])
        assert chi2.pvalue > 1e-3, (b, chi2)


def test_drawn_rows_are_multinomials_draw():
    """The exponential race of a drawn row draws what torch.multinomial
    draws from softmax(filtered / temp) with the same generator state."""
    rows = PARAM_SETS["mixed"][1:]
    x = torch.from_numpy(_logits(rows, 3))
    params = _params(rows, "torch")
    temp = params["temp"][:, None]
    probs = torch.softmax(tsampling.batched_filter_logits(x, params) / temp,
                          dim=-1)
    sample = tsampling.make_batched_sampler()
    for seed in range(4):
        want = torch.multinomial(probs, 1, generator=torch.Generator()
                                 .manual_seed(seed))[:, 0]
        got = sample(x, params, torch.Generator().manual_seed(seed))
        assert torch.equal(got, want)
