"""Port parity: the sampler's top-n-sigma, typical-p and XTC filters and the
presence / frequency penalties (core/sampling.py) against the JAX
package's.

Logits come from numpy with a seed, with no two equal in a row, so that a
stable sort's tie order cannot decide what a filter keeps; rows whose
decision lies within 1e-4 of a filter's bound (in float64) are redrawn,
so that f32 summation order cannot decide it either.  The keep-sets of
top-n-sigma and typical-p must equal the JAX package's; XTC at
probability 1 drops what the reference drops and at probability 0 keeps
every token; the penalized logits agree within 1e-6.  On a GPU (marked
`cuda`), a sampler with every filter and the processors run inside a
captured CUDA graph, and each replay draws what the same calls draw
eagerly from the same generator state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.core import sampling as jsampling
from mlx_vlm_tpu_torch.core import sampling as tsampling

torch.set_num_threads(2)

V = 300


def _logits(seed: int, rows: int = 6, scale: float = 3.0) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal((rows, V)) * scale
         ).astype(np.float32)
    for r in x:
        assert len(np.unique(r)) == V
    return x


def _sigma_clear(x: np.ndarray, n: float, gap: float = 1e-4) -> bool:
    """No logit lies within `gap` of its row's top-n-sigma bound."""
    x64 = x.astype(np.float64)
    bound = x64.max(-1, keepdims=True) - n * x64.std(-1, keepdims=True)
    return bool(np.abs(x64 - bound).min() > gap)


def _typical_clear(x: np.ndarray, t: float, gap: float = 1e-4) -> bool:
    """No row's exclusive cumulative mass in typical order lies within `gap`
    of `t`, and the deviations from the entropy on either side of the cut
    lie more than `gap` apart."""
    x64 = x.astype(np.float64)
    lp = x64 - x64.max(-1, keepdims=True)
    lp -= np.log(np.exp(lp).sum(-1, keepdims=True))
    p = np.exp(lp)
    ent = -(p * lp).sum(-1, keepdims=True)
    dev = np.abs(-lp - ent)
    for d, pr in zip(dev, p):
        o = np.argsort(d, kind="stable")
        excl = np.cumsum(pr[o]) - pr[o]
        if np.abs(excl - t).min() <= gap:
            return False
        cut = int((excl < t).sum())
        if 0 < cut < len(o) and d[o[cut]] - d[o[cut - 1]] <= gap:
            return False
    return True


def _clear_seed(pred, start: int = 0) -> np.ndarray:
    for seed in range(start, start + 50):
        x = _logits(seed)
        if pred(x):
            return x
    raise AssertionError("no clear seed")


@pytest.mark.parametrize("n_sigma", [0.5, 1.0, 2.0])
def test_top_n_sigma_keeps_what_the_reference_keeps(n_sigma):
    x = _clear_seed(lambda a: _sigma_clear(a, n_sigma))
    ref = np.asarray(jsampling._apply_top_n_sigma(jnp.asarray(x), n_sigma))
    got = tsampling._apply_top_n_sigma(torch.from_numpy(x), n_sigma).numpy()
    assert np.array_equal(np.isfinite(ref), np.isfinite(got))
    assert np.array_equal(ref[np.isfinite(ref)], got[np.isfinite(got)])
    assert 0 < np.isfinite(got).sum() < got.size


def test_top_n_sigma_counts_masked_entries_as_zero():
    """After top-k the row holds -inf entries: the deviation is taken over
    the whole row with those entries at 0, as the reference takes it."""
    x = _logits(3)
    k = torch.from_numpy(x)
    masked = tsampling._apply_top_k(k, 40)
    jmasked = jsampling._apply_top_k(jnp.asarray(x), 40)
    ref = np.asarray(jsampling._apply_top_n_sigma(jmasked, 1.0))
    got = tsampling._apply_top_n_sigma(masked, 1.0).numpy()
    assert np.array_equal(np.isfinite(ref), np.isfinite(got))


@pytest.mark.parametrize("typical_p", [0.2, 0.5, 0.9])
def test_typical_p_keeps_what_the_reference_keeps(typical_p):
    x = _clear_seed(lambda a: _typical_clear(a, typical_p))
    ref = np.asarray(jsampling._apply_typical_p(jnp.asarray(x), typical_p))
    got = tsampling._apply_typical_p(torch.from_numpy(x), typical_p).numpy()
    assert np.array_equal(np.isfinite(ref), np.isfinite(got))
    assert np.array_equal(ref[np.isfinite(ref)], got[np.isfinite(got)])


def test_typical_p_ties_rank_by_index():
    """Equal deviations (a row of equal logits) rank by index, as
    jnp.argsort's stable sort ranks them: the kept tokens are the first
    ones."""
    x = np.zeros((1, 10), np.float32)
    ref = np.asarray(jsampling._apply_typical_p(jnp.asarray(x), 0.35))
    got = tsampling._apply_typical_p(torch.from_numpy(x), 0.35).numpy()
    assert np.array_equal(np.isfinite(ref), np.isfinite(got))
    assert np.isfinite(got[0, :4]).all() and not np.isfinite(got[0, 4:]).any()


@pytest.mark.parametrize("threshold", [0.01, 0.05, 0.2])
def test_xtc_at_probability_one_drops_as_the_reference(threshold):
    x = _logits(5, scale=2.0)
    ref = np.asarray(jsampling._apply_xtc(jnp.asarray(x), 1.0, threshold,
                                          jax.random.PRNGKey(0)))
    got = tsampling._apply_xtc(torch.from_numpy(x), 1.0, threshold,
                               torch.Generator().manual_seed(0)).numpy()
    assert np.array_equal(np.isfinite(ref), np.isfinite(got))
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    for r in range(x.shape[0]):
        above = np.flatnonzero(p[r] >= threshold)
        kept = np.isfinite(got[r])
        if len(above) > 1:  # every token above but the least likely dropped
            assert kept[above].sum() == 1 and kept[np.argmin(
                np.where(p[r] >= threshold, p[r], np.inf))]
        assert kept.sum() == V - max(len(above) - 1, 0)


def test_xtc_at_probability_zero_keeps_every_token():
    x = _logits(6)
    got = tsampling._apply_xtc(torch.from_numpy(x), 0.0, 0.01,
                               torch.Generator().manual_seed(1)).numpy()
    assert np.array_equal(got, x)


def test_xtc_coin_comes_from_the_generator():
    """At probability 0.5 the rows that fire follow the generator: the same
    seed fires the same rows, and a row fires when its uniform draw from
    that generator is below the probability."""
    x = np.tile(_logits(7, rows=1, scale=4.0), (64, 1))
    gen = torch.Generator().manual_seed(3)
    got = tsampling._apply_xtc(torch.from_numpy(x), 0.5, 0.01, gen).numpy()
    coin = torch.rand((64, 1), generator=torch.Generator().manual_seed(3))
    fired = ~np.isfinite(got).all(-1)
    assert np.array_equal(fired, (coin[:, 0] < 0.5).numpy())
    assert 10 < fired.sum() < 54


def test_make_sampler_takes_the_new_options_in_the_reference_order():
    """Greedy ignores the filters; a sampler with every filter draws only
    tokens that the reference's filter chain keeps."""
    x = _logits(8, rows=4)
    opts = dict(top_k=80, top_n_sigma=2.0, top_p=0.95, min_p=0.01,
                typical_p=0.9, xtc_probability=1.0, xtc_threshold=0.02)
    greedy = tsampling.make_sampler(0.0, **{k: v for k, v in opts.items()
                                            if k != "top_k"})
    assert torch.equal(greedy(torch.from_numpy(x)),
                       torch.from_numpy(x.argmax(-1)))
    jx = jnp.asarray(x)
    jx = jsampling._apply_top_k(jx, 80)
    jx = jsampling._apply_top_n_sigma(jx, 2.0)
    jx = jsampling._apply_top_p(jx, 0.95)
    jx = jsampling._apply_min_p(jx, 0.01)
    jx = jsampling._apply_typical_p(jx, 0.9)
    jx = jsampling._apply_xtc(jx, 1.0, 0.02, jax.random.PRNGKey(0))
    keep = np.isfinite(np.asarray(jx))
    sample = tsampling.make_sampler(0.8, **opts)
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        tok = sample(torch.from_numpy(x), gen).numpy()
        assert keep[np.arange(4), tok].all()


def _history(seed: int, B: int = 3, W: int = 24) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 40, (B, W)).astype(np.int64)  # repeats on purpose
    h[0, :7] = -1  # a ring not yet full
    h[2, :] = -1  # nothing generated yet
    return h


@pytest.mark.parametrize("pp,fp", [(0.5, None), (None, 0.3), (0.7, 0.25),
                                   (-0.4, 1.5)])
def test_presence_and_frequency_penalties_match_the_reference(pp, fp):
    x = _logits(9, rows=3)
    h = _history(9)
    jp = jsampling.make_logits_processors(presence_penalty=pp,
                                          frequency_penalty=fp)
    tp = tsampling.make_logits_processors(presence_penalty=pp,
                                          frequency_penalty=fp)
    assert len(jp) == len(tp) == 1
    ref = np.asarray(jp[0](jnp.asarray(h, jnp.int32), jnp.asarray(x)))
    got = tp[0](torch.from_numpy(h), torch.from_numpy(x)).numpy()
    assert np.abs(ref - got).max() <= 1e-6
    assert not np.array_equal(got[0], x[0])
    assert np.array_equal(got[2], x[2])  # an empty ring changes nothing


def test_penalties_compose_with_bias_and_repetition_in_order():
    x = _logits(10, rows=3)
    h = _history(10)
    kw = dict(logit_bias={3: 2.0, 17: -1.0}, repetition_penalty=1.3,
              repetition_context_size=8, presence_penalty=0.2,
              frequency_penalty=0.1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for jproc, tproc in zip(jsampling.make_logits_processors(**kw),
                            tsampling.make_logits_processors(**kw)):
        jx = jproc(jnp.asarray(h, jnp.int32), jx)
        tx = tproc(torch.from_numpy(h), tx)
    assert np.abs(np.asarray(jx) - tx.numpy()).max() <= 1e-6
    assert len(tsampling.make_logits_processors(**kw)) == 3


def test_zero_penalties_add_no_processor():
    assert tsampling.make_logits_processors(presence_penalty=0.0,
                                            frequency_penalty=None) == []


# ----------------------------------------------------------- on a GPU only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sampler_and_processors_run_in_a_captured_graph(cuda_device):
    """Every filter and processor in one step captured as a CUDA graph: each
    replay's token equals the same step run eagerly from the same generator
    state, and nothing is read on the host."""
    from mlx_vlm_tpu_torch.ops._cuda import Graph

    dev = cuda_device
    x = torch.from_numpy(_logits(11, rows=2)).to(dev)
    hist = torch.from_numpy(_history(11, B=2)).to(dev)
    sample = tsampling.make_sampler(
        0.9, top_k=100, top_n_sigma=2.5, top_p=0.97, min_p=0.005,
        typical_p=0.95, xtc_probability=0.5, xtc_threshold=0.02)
    procs = tsampling.make_logits_processors(
        logit_bias={1: 1.0}, repetition_penalty=1.2, presence_penalty=0.3,
        frequency_penalty=0.2)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        y = x
        for p in procs:
            y = p(hist, y)
        return sample(y, gen)

    step()  # the processors' device tables are made on the first call
    torch.cuda.synchronize()
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    graph = Graph()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph.capture(lambda: out.copy_(step()), stream, generators=(gen,))
    torch.cuda.synchronize()
    for seed in range(5):
        gen.manual_seed(seed)
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = out.clone()
        gen.manual_seed(seed)
        assert torch.equal(got, step())

