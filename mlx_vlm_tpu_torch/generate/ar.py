"""Autoregressive decode: chunked prefill, then one decode step per token.

Port of mlx_vlm_tpu/generate/ar.py (make_cache :222, generate_step :305).
`make_cache` picks the KV cache from `kv_bits` and the environment as the
reference does: bf16 `KVCache`, `Int8KVCache` (8), `Int4KVCache` (4), the
rotated int4 cache (4 with MLX_VLM_TPU_KV_SCHEME=turboquant), the
TurboQuant caches (fractional bits; MLX_VLM_TPU_TQ_SCHEME=split for the
per-channel split) and the group-affine `QuantizedKVCache` (other integer
bits, or 4 / 8 with MLX_VLM_TPU_KV_SCHEME=affine).
The prompt is prefilled in `prefill_step_size` chunks, padded as in the
reference (:357-397) so every chunk has the same length; the cache's
capacity must hold the padded prompt, which is checked before any write.
Decoding runs one eager step per token through `step_logits`: the
whole-stack fused decode kernel (K3) when the model's route is on and the
cache is a plain `KVCache`, else the per-linear path, whose attention runs
K6, K7 or K8 on a quantized cache.  The reference's multi-step decode
blocks and prompt caches are not ported.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Generator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.quant import _check_bits
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


def _group_affine(kv_bits, head_dim: int = 2) -> bool:
    """Whether `kv_bits` and the environment pick the reference's
    group-affine QuantizedKVCache (ar.py:296)."""
    if not kv_bits or float(kv_bits) != int(kv_bits):
        return False
    scheme = os.environ.get("MLX_VLM_TPU_KV_SCHEME")
    if scheme == "turboquant":
        return False
    if kv_bits == 8:
        return scheme == "affine"
    return kv_bits != 4 or scheme == "affine" or head_dim % 2 != 0


def check_kv_bits(kv_bits) -> None:
    """Raise before any work for a `kv_bits` whose group-affine cache
    `quantize` cannot build (bits other than 1, 2, 4, 8): the reference
    raises the same ValueError at the cache's first write."""
    if _group_affine(kv_bits):
        _check_bits(int(kv_bits))


def make_cache(model, batch_size: int, capacity: int, dtype,
               kv_bits: Optional[float] = None, kv_group_size: int = 64,
               device=None):
    """The KV cache for `kv_bits`, by the reference's decision tree
    (ar.py:244-302)."""
    from ..core import cache as cache_lib
    from ..core import turboquant as tq

    lm = model.language_model
    dims = (lm.args.num_hidden_layers, batch_size, lm.n_kv_heads,
            lm.head_dim, capacity)
    kv_scheme = os.environ.get("MLX_VLM_TPU_KV_SCHEME")
    fractional = bool(kv_bits) and float(kv_bits) != int(kv_bits)
    if kv_bits and (fractional or kv_scheme == "turboquant"):
        hd = lm.head_dim
        if float(kv_bits) == 4.0 and hd & (hd - 1) == 0:
            return tq.make_rotated_int4_cache(*dims, device=device)
        if fractional and os.environ.get("MLX_VLM_TPU_TQ_SCHEME") == "split":
            return tq.init_turboquant_split_cache(
                *dims, kv_bits=float(kv_bits), device=device)
        return tq.init_turboquant_cache(*dims, kv_bits=float(kv_bits),
                                        device=device)
    if _group_affine(kv_bits, lm.head_dim):
        return cache_lib.init_quantized_cache(
            *dims, dtype, bits=int(kv_bits), group_size=kv_group_size,
            device=device)
    if kv_bits == 8:
        return cache_lib.init_int8_cache(*dims, device=device)
    if kv_bits == 4:
        return cache_lib.init_int4_cache(*dims, device=device)
    return lm.init_cache(batch_size, capacity, dtype, device=device)


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
    block_size: int = 32,
    kv_bits: Optional[float] = None,
    kv_group_size: int = 64,
) -> Generator[Tuple[np.ndarray, np.ndarray], None, None]:
    """Yield (token [B], chosen-token logprob [B]) numpy pairs.

    The prompt embeddings must already contain the merged vision features.
    `block_size` is the reference's count of decode steps per device
    program; here it sizes the cache as the reference does (ar.py:344-352),
    and decoding runs one token per step."""
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

    block_size = max(1, min(block_size, max_tokens))
    capacity = round_up(S + max_tokens + block_size + 1, CACHE_BUCKET)
    cache = make_cache(model, B, capacity, inputs_embeds.dtype, kv_bits,
                       kv_group_size, device=dev)

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
