"""Samplers and logits processors.

Port of mlx_vlm_tpu/core/sampling.py (the filters :29-91, make_sampler
:94, make_batched_sampler :137, batched_filter_logits :159,
batched_filtered_probs :188, make_logits_processors :210) for
temperature, top-k, top-n-sigma, top-p, min-p, typical-p and XTC
sampling, the top-k / top-p / min-p filters with per-row parameters
(continuous batching), and the logit-bias, repetition-penalty and
presence / frequency-penalty processors.
A sampler is `(logits [B, V] f32, generator) -> tokens [B] int64`, a
batched sampler `(logits, params, generator)` with `params` a dict of [B]
device tensors; random draws come from the `torch.Generator` it is given.
Every sampler and processor built here reads nothing on the host and
uploads nothing after its first call on a device, so a decode step that
runs them can be captured in a CUDA graph (generate/ar.py,
generate/batch.py).  XTC draws its coin from the sampler's generator.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["make_sampler", "make_batched_sampler", "batched_filter_logits",
           "batched_filtered_probs", "make_logits_processors"]

_NEG_INF = float("-inf")


def _apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    vals = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values
    return logits.masked_fill(logits < vals[..., -1:], _NEG_INF)


def _apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep tokens while the exclusive cumulative
    probability of the sorted distribution is below top_p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    masked = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = masked.amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, _NEG_INF)


def _apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True)
    return logits.masked_fill(probs < min_p * pmax, _NEG_INF)


def _apply_top_n_sigma(logits: torch.Tensor, n_sigma: float) -> torch.Tensor:
    """Keep the logits within n_sigma standard deviations of the largest:
    the population deviation over the whole row, -inf entries counted as 0,
    as the reference computes it."""
    mx = logits.amax(dim=-1, keepdim=True)
    finite = torch.where(torch.isfinite(logits), logits,
                         torch.zeros_like(logits))
    std = finite.std(dim=-1, keepdim=True, correction=0)
    return logits.masked_fill(logits < mx - n_sigma * std, _NEG_INF)


def _apply_typical_p(logits: torch.Tensor, typical_p: float) -> torch.Tensor:
    """Locally typical sampling: keep the tokens whose surprisal is closest
    to the entropy until their mass reaches typical_p.  Ranks come from a
    stable sort, as `jnp.argsort`'s: tied deviations rank by index."""
    lp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(lp)
    ent = -(p * torch.where(torch.isfinite(lp), lp,
                            torch.zeros_like(lp))).sum(-1, keepdim=True)
    dev = (-lp - ent).abs()
    order = torch.sort(dev, dim=-1, stable=True).indices
    p_sorted = p.gather(-1, order)
    cum = torch.cumsum(p_sorted, dim=-1)
    keep_sorted = (cum - p_sorted) < typical_p
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return logits.masked_fill(~keep, _NEG_INF)


def _apply_xtc(logits: torch.Tensor, probability: float, threshold: float,
               generator) -> torch.Tensor:
    """Exclude top choices: with probability `probability` a row drops every
    token whose probability reaches `threshold` except the least likely of
    them (nothing when fewer than two reach it).  The row's coin is a
    uniform draw from `generator` on the logits' device."""
    p = torch.softmax(logits, dim=-1)
    above = p >= threshold
    n_above = above.sum(dim=-1, keepdim=True)
    min_above = torch.where(above, p, torch.full_like(p, float("inf"))
                            ).amin(dim=-1, keepdim=True)
    coin = torch.rand((logits.shape[0], 1), generator=generator,
                      device=logits.device)
    drop = above & (p > min_above) & (coin < probability) & (n_above > 1)
    return logits.masked_fill(drop, _NEG_INF)


def make_sampler(temp: float = 0.0, top_p: float = 0.0, min_p: float = 0.0,
                 top_k: int = -1, top_n_sigma: float = -1.0,
                 typical_p: float = 0.0, xtc_probability: float = 0.0,
                 xtc_threshold: float = 0.1) -> Callable:
    """Build `(logits [B, V], generator) -> tokens [B]`.

    temp == 0 is greedy (argmax).  Otherwise filters apply in the
    reference's order (top_k -> top_n_sigma -> top_p -> min_p -> typical_p
    -> xtc), then a categorical draw at
    temperature `temp` from the generator, as an exponential race
    argmax(p / E) with E ~ Exp(1): `torch.multinomial`'s own one-sample
    draw (the same tokens from the same generator), without its check of
    the probabilities on the host, which a CUDA graph cannot capture.  The
    reference's `jax.random.categorical` is the same race in Gumbel form."""

    def sample(logits: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if temp == 0.0:
            return torch.argmax(logits, dim=-1)
        x = logits.float()
        if top_k > 0:
            x = _apply_top_k(x, top_k)
        if top_n_sigma > 0:
            x = _apply_top_n_sigma(x, top_n_sigma)
        if 0.0 < top_p < 1.0:
            x = _apply_top_p(x, top_p)
        if min_p > 0.0:
            x = _apply_min_p(x, min_p)
        if 0.0 < typical_p < 1.0:
            x = _apply_typical_p(x, typical_p)
        if xtc_probability > 0.0:
            x = _apply_xtc(x, xtc_probability, xtc_threshold, generator)
        return _race(torch.softmax(x / temp, dim=-1), generator)

    return sample


def _race(probs: torch.Tensor, generator) -> torch.Tensor:
    """One categorical draw per row of `probs` [B, V]: the exponential race
    argmax(p / E), E ~ Exp(1), which is `torch.multinomial`'s one-sample
    draw without its check of the probabilities on the host."""
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / race, dim=-1)


def make_batched_sampler() -> Callable:
    """Per-row-parameterized sampler for continuous batching.

    Returns `(logits [B, V], params, generator) -> tokens [B]` where
    `params` is a dict of [B] tensors on the logits' device: temp, top_p,
    min_p, top_k (<= 0 disables).  Rows with temp == 0 decode greedily
    (argmax of the unfiltered logits); the others draw from
    softmax(filtered / temp) by the exponential race, so one captured step
    serves any mix of requests."""

    def sample(logits: torch.Tensor, params: dict,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = logits.float()
        filtered = batched_filter_logits(x, params)
        temp = params["temp"].reshape(-1, 1)
        safe_temp = torch.where(temp > 0, temp, torch.ones_like(temp))
        drawn = _race(torch.softmax(filtered / safe_temp, dim=-1), generator)
        greedy = torch.argmax(x, dim=-1)
        return torch.where(temp.reshape(-1) > 0, drawn, greedy)

    return sample


def batched_filter_logits(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Per-row top-k / top-p / min-p filters (no temperature draw).

    x: [B, V] f32 logits; params: dict of [B] tensors as in
    make_batched_sampler.  Ranks come from a stable descending sort (the
    reference's argsort of -x): tied logits rank by index.  Returns the
    logits with -inf where a filter drops the token."""
    B, V = x.shape
    top_p = params["top_p"].reshape(B, 1)
    min_p = params["min_p"].reshape(B, 1)
    top_k = params["top_k"].reshape(B, 1)

    sorted_x, order = torch.sort(x, dim=-1, descending=True, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(V, device=x.device).expand(B, V))
    # top-k: keep rank < k (k <= 0 disables)
    keep = (top_k <= 0) | (ranks < top_k)
    # top-p on the sorted probabilities (exclusive cumulative sum)
    probs_sorted = torch.softmax(sorted_x, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    bound = torch.where(top_p > 0, top_p, torch.ones_like(top_p))
    keep &= ((cum - probs_sorted) < bound).gather(1, ranks)
    # min-p against the row's most likely token
    probs = torch.softmax(x, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True)
    keep &= (min_p <= 0) | (probs >= min_p * pmax)
    return torch.where(keep, x, torch.full_like(x, _NEG_INF))


def batched_filtered_probs(logits: torch.Tensor,
                           params: dict) -> torch.Tensor:
    """Per-row filtered token distributions [B, T, V] of logits [B, T, V]
    (the reference's, for speculative rejection sampling): softmax of the
    filtered logits over temp, or a one-hot argmax where temp == 0."""
    B, T, V = logits.shape
    x = logits.float().reshape(B * T, V)
    # each row's parameters for its T positions, by a view: no host
    # arithmetic, so a captured speculative round can run it
    rep = {k: v.reshape(B, 1).expand(B, T).reshape(B * T)
           for k, v in params.items()}
    filtered = batched_filter_logits(x, rep)
    temp = rep["temp"].reshape(-1, 1)
    safe_temp = torch.where(temp > 0, temp, torch.ones_like(temp))
    soft = torch.softmax(filtered / safe_temp, dim=-1)
    onehot = torch.zeros_like(x).scatter_(
        1, torch.argmax(x, dim=-1, keepdim=True), 1.0)
    return torch.where(temp > 0, soft, onehot).reshape(B, T, V)


def make_logits_processors(logit_bias: Optional[dict] = None,
                           repetition_penalty: Optional[float] = None,
                           repetition_context_size: int = 20,
                           presence_penalty: Optional[float] = None,
                           frequency_penalty: Optional[float] = None):
    """Processors `(history [B, W] int64, logits [B, V]) -> logits`.

    `history` is a fixed-width ring of the last W generated tokens, padded
    with -1.  The repetition penalty reads the last
    `repetition_context_size` of them; the presence and frequency
    penalties, as the reference's, the whole ring: each token's logit
    less frequency_penalty times its count and presence_penalty if it
    occurs."""
    processors = []

    if logit_bias:
        ids = list(logit_bias.keys())
        vals = list(logit_bias.values())
        tables = {}  # (device, dtype) -> (ids, values), made once

        def bias_proc(history, logits):
            key = (logits.device, logits.dtype)
            if key not in tables:
                tables[key] = (
                    torch.tensor(ids, dtype=torch.int64, device=logits.device),
                    torch.tensor(vals, dtype=logits.dtype,
                                 device=logits.device))
            idx, val = tables[key]
            return logits.index_add(-1, idx, val.expand(*logits.shape[:-1],
                                                        -1))

        processors.append(bias_proc)

    if repetition_penalty and repetition_penalty != 1.0:
        w = repetition_context_size

        def rep_proc(history, logits):
            hist = history[:, -w:]
            seen = torch.zeros(logits.shape, dtype=torch.float32,
                               device=logits.device)
            seen.scatter_add_(1, hist.clamp(min=0), (hist >= 0).float())
            seen = seen > 0
            lf = logits.float()
            penalized = torch.where(lf < 0, lf * repetition_penalty,
                                    lf / repetition_penalty)
            return torch.where(seen, penalized, lf).to(logits.dtype)

        processors.append(rep_proc)

    if presence_penalty or frequency_penalty:
        pp = presence_penalty or 0.0
        fp = frequency_penalty or 0.0

        def freq_proc(history, logits):
            counts = torch.zeros(logits.shape, dtype=torch.float32,
                                 device=logits.device)
            counts.scatter_add_(1, history.clamp(min=0),
                                (history >= 0).float())
            lf = logits.float() - fp * counts - pp * (counts > 0).float()
            return lf.to(logits.dtype)

        processors.append(freq_proc)

    return processors
