"""Autoregressive decode: chunked prefill, then one decode step per token.

Port of mlx_vlm_tpu/generate/ar.py (generate_step :305).  The prompt is
prefilled in `prefill_step_size` chunks, padded as in the reference
(:357-397) so every chunk has the same length; the cache's capacity must
hold the padded prompt, which is checked before any write.  Decoding runs one
eager step per token through `step_logits`, which takes the whole-stack
fused decode kernel (K3) when the model's route is on.  The reference's
multi-step decode blocks, prompt caches and quantized KV caches are not
ported.
"""

from __future__ import annotations

import time
from typing import Callable, Generator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.sampling import make_sampler
from .common import round_up

CACHE_BUCKET = 256
HISTORY_SIZE = 64  # ring of recent tokens for repetition/frequency penalties


def _pad_axis(x: np.ndarray, axis: int, target: int):
    pad = target - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def generate_step(
    inputs_embeds: torch.Tensor,  # [B, S, D]
    model,
    *,
    position_ids: Optional[np.ndarray] = None,  # [3, B, S]
    rope_deltas: Optional[np.ndarray] = None,  # [B, 1]
    max_tokens: int = 256,
    sampler: Optional[Callable] = None,
    logits_processors: Optional[List[Callable]] = None,
    prefill_step_size: int = 512,
    seed: Optional[int] = None,
) -> Generator[Tuple[np.ndarray, np.ndarray], None, None]:
    """Yield (token [B], chosen-token logprob [B]) numpy pairs.

    The prompt embeddings must already contain the merged vision features."""
    lm = model.language_model
    lm_params = model.params["language_model"]
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device

    if position_ids is None:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        position_ids = np.broadcast_to(pos[None], (3, B, S))
    if rope_deltas is None:
        rope_deltas = np.zeros((B, 1), np.int32)
    deltas = torch.from_numpy(
        np.asarray(rope_deltas, np.int64).reshape(-1)[:B].copy()).to(dev)

    capacity = round_up(S + max_tokens + 1, CACHE_BUCKET)
    cache = lm.init_cache(B, capacity, inputs_embeds.dtype, device=dev)

    # ---- chunked prefill; the padded chunks must fit the cache, since an
    # out-of-range index write would not be clamped
    step_sz = min(prefill_step_size, round_up(S, CACHE_BUCKET))
    S_pad = round_up(S, step_sz)
    while S_pad > capacity and step_sz > 64:
        step_sz = max(64, step_sz // 2)
        S_pad = round_up(S, step_sz)
    if S_pad > capacity:
        raise ValueError(f"kv capacity {capacity} too small for padded prompt "
                         f"{S_pad}")
    embeds = inputs_embeds
    if S_pad != S:
        embeds = F.pad(embeds, (0, 0, 0, S_pad - S))
    pos_pad = _pad_axis(np.asarray(position_ids, np.int64), 2, S_pad)

    logits = None
    last = S - 1
    for c0 in range(0, S_pad, step_sz):
        pchunk = torch.from_numpy(
            np.ascontiguousarray(pos_pad[:, :, c0:c0 + step_sz])).to(dev)
        hidden = lm(lm_params, embeds[:, c0:c0 + step_sz], cache, pchunk)
        if c0 <= last < c0 + step_sz:
            h_last = hidden[:, last - c0:last - c0 + 1]
            logits = lm.logits(lm_params, h_last)[:, 0].float()
    # the padding wrote rows past S; they stay masked once the cursor is S
    cache.offset = S

    sampler = sampler or make_sampler()
    processors = tuple(logits_processors or ())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed if seed is not None else time.time_ns() % 2**31)
    history = torch.full((B, HISTORY_SIZE), -1, dtype=torch.int64, device=dev)

    def pick(logits, history):
        logprobs = torch.log_softmax(logits, dim=-1)
        tok = sampler(logits, gen)
        history = torch.cat([history[:, 1:], tok[:, None]], dim=1)
        lp = logprobs.gather(1, tok[:, None])[:, 0]
        return tok, lp, history

    if max_tokens <= 0:
        return
    tok, lp, history = pick(logits, history)
    yield tok.cpu().numpy(), lp.cpu().numpy()
    for _ in range(max_tokens - 1):
        emb = lm.embed(lm_params, tok[:, None])
        pos = (cache.offset + deltas)[None, :, None].expand(3, B, 1)
        logits = lm.step_logits(lm_params, emb, cache, pos)[:, 0].float()
        for proc in processors:
            logits = proc(history, logits)
        tok, lp, history = pick(logits, history)
        yield tok.cpu().numpy(), lp.cpu().numpy()
