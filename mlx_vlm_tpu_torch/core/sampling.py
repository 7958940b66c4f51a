"""Samplers and logits processors.

Port of mlx_vlm_tpu/core/sampling.py (make_sampler :94,
make_batched_sampler :137, batched_filter_logits :159,
batched_filtered_probs :188, make_logits_processors :210) for
temperature, top-k, top-p and min-p sampling, the same filters with
per-row parameters (continuous batching), and the logit-bias and
repetition-penalty processors.
A sampler is `(logits [B, V] f32, generator) -> tokens [B] int64`, a
batched sampler `(logits, params, generator)` with `params` a dict of [B]
device tensors; random draws come from the `torch.Generator` it is given.
Every sampler and processor built here reads nothing on the host and
uploads nothing after its first call on a device, so a decode step that
runs them can be captured in a CUDA graph (generate/ar.py,
generate/batch.py).  Presence/frequency penalties and the other filters
(top-n-sigma, typical-p, XTC) are not ported.
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


def make_sampler(temp: float = 0.0, top_p: float = 0.0, min_p: float = 0.0,
                 top_k: int = -1) -> Callable:
    """Build `(logits [B, V], generator) -> tokens [B]`.

    temp == 0 is greedy (argmax).  Otherwise filters apply in the
    reference's order (top_k -> top_p -> min_p), then a categorical draw at
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
        if 0.0 < top_p < 1.0:
            x = _apply_top_p(x, top_p)
        if min_p > 0.0:
            x = _apply_min_p(x, min_p)
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
                           repetition_context_size: int = 20):
    """Processors `(history [B, W] int64, logits [B, V]) -> logits`.

    `history` is a fixed-width ring of the last W generated tokens, padded
    with -1."""
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

    return processors
