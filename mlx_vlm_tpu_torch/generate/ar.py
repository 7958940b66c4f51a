"""Autoregressive decode: chunked prefill, then decode blocks.

Port of mlx_vlm_tpu/generate/ar.py (make_cache :222, generate_step :305,
DecodeEngine.decode_block_fn :137).
`make_cache` picks the KV cache from `kv_bits` and the environment as the
reference does: bf16 `KVCache`, `Int8KVCache` (8), `Int4KVCache` (4), the
rotated int4 cache (4 with MLX_VLM_TPU_KV_SCHEME=turboquant), the
TurboQuant caches (fractional bits; MLX_VLM_TPU_TQ_SCHEME=split for the
per-channel split) and the group-affine `QuantizedKVCache` (other integer
bits, or 4 / 8 with MLX_VLM_TPU_KV_SCHEME=affine).
The prompt is prefilled in `prefill_step_size` chunks, padded as in the
reference (:357-397) so every chunk has the same length; the cache must
hold the padded prompt and every decode step's row, which
`check_capacity` checks before any write.  The cache records where the
prompt ends (`set_prompt_end`), so that a decoder with a bidirectional
prefix (PaliGemma's) stops its prefix mask there and no prompt row attends
to the padding, where the reference's does (ROADMAP, known faults in the
reference).

Decoding runs in blocks of `block_size` steps, the reference's
`decode_block_fn` (one `lax.scan` program per block, one host fetch per
block) in PyTorch's idiom (`DecodeBlocks`): every piece of decode state
lives on the device (the token, the cache's cursor, the token-history
ring, the sampler's generator and an output row counter), and one step
(embed -> `step_logits` -> processors -> sampler -> history) writes its
token and logprob into a row of a device ring of two blocks.  On the card
the first decode step runs eagerly (it makes the lazy device state: rope
and codebook tables, K3's buffers, the kernels' ticket words) and the next
is captured once as a CUDA graph, which each later step replays; a block's
replays are dispatched under `torch.cuda.set_sync_debug_mode("error")`,
and its rows come back in one non-blocking copy into pinned memory, waited
on through an event.  Block k + 1 is dispatched before block k is read, as
the reference's loop does (:413-438), and the last block replays only the
steps still needed.  A capture that fails raises: nothing falls back to
eager steps.  On the CPU the same step runs eagerly, with the same state
tensors and the same one fetch per block.  Each step runs K3 when the
model's route is on and the cache is a plain `KVCache`, else the
per-linear path, whose attention runs K6, K7 or K8 on a quantized cache.
A prompt cache (apc.py's warm cache or restored snapshot) holds a prefix
already computed, and only the rest of the prompt is prefilled into it.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Generator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import cache as cache_lib
from ..core.quant import _check_bits
from ..core.sampling import make_sampler
from .common import refuse_prefix_reuse, round_up

CACHE_BUCKET = 256
HISTORY_SIZE = 64  # ring of recent tokens for repetition/frequency penalties

# The last request's decode state (its `DecodeBlocks`: the cache, the
# captured step and `stats`), held until the next request starts
last_decode = None


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
               per_row: bool = False, device=None):
    """The KV cache for `kv_bits`, by the reference's decision tree
    (ar.py:222-302).  `per_row` gives the quantized caches one cursor per
    row (continuous batching), on the branches where the reference passes
    it down; the bf16 branch ignores it, as there (generate/batch.py builds
    its `BatchKVCache` itself).  The reference passes it to no TurboQuant
    codebook cache, whose 0-dim cursor then fails the batch's first
    admission (an IndexError in `insert_row`): here such a request raises
    before any buffer is made."""
    from ..core import turboquant as tq

    lm = model.language_model
    dims = (lm.args.num_hidden_layers, batch_size, lm.n_kv_heads,
            lm.head_dim, capacity)
    kv_scheme = os.environ.get("MLX_VLM_TPU_KV_SCHEME")
    fractional = bool(kv_bits) and float(kv_bits) != int(kv_bits)
    if kv_bits and (fractional or kv_scheme == "turboquant"):
        hd = lm.head_dim
        if float(kv_bits) == 4.0 and hd & (hd - 1) == 0:
            return tq.make_rotated_int4_cache(*dims, per_row=per_row,
                                              device=device)
        if per_row:
            raise ValueError(f"kv_bits {kv_bits} builds a TurboQuant codebook "
                             f"cache, which has no per-row cursors")
        if fractional and os.environ.get("MLX_VLM_TPU_TQ_SCHEME") == "split":
            return tq.init_turboquant_split_cache(
                *dims, kv_bits=float(kv_bits), device=device)
        return tq.init_turboquant_cache(*dims, kv_bits=float(kv_bits),
                                        device=device)
    if _group_affine(kv_bits, lm.head_dim):
        return cache_lib.init_quantized_cache(
            *dims, dtype, bits=int(kv_bits), group_size=kv_group_size,
            per_row=per_row, device=device)
    if kv_bits == 8:
        return cache_lib.init_int8_cache(*dims, per_row=per_row,
                                         device=device)
    if kv_bits == 4:
        return cache_lib.init_int4_cache(*dims, per_row=per_row,
                                         device=device)
    return lm.init_cache(batch_size, capacity, dtype, device=device)


def check_capacity(capacity: int, S_pad: int, S: int,
                   max_tokens: int) -> None:
    """Raise before any write unless a cache of `capacity` rows holds a
    request's writes: the padded prompt's rows [0, S_pad) and the rows
    S .. S + max_tokens - 2 of its decode steps.  The caches write by index
    at a cursor that no step reads on the host, so this is where a write
    past the capacity is refused (it would not be clamped)."""
    end = max(S_pad, S + max(max_tokens - 1, 0))
    if end > capacity:
        raise ValueError(f"kv capacity {capacity} too small for padded prompt "
                         f"{S_pad} and {max(max_tokens - 1, 0)} decode steps "
                         f"after {S} prompt tokens")


class _NoSync:
    """torch.cuda.set_sync_debug_mode("error") for the duration of a with
    block on a CUDA device when `on` (nothing elsewhere): any call that
    waits for the card raises."""

    def __init__(self, device, on: bool = True):
        self.on = on and device.type == "cuda"

    def __enter__(self):
        if self.on:
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode(self.mode)


class DecodeBlocks:
    """The decode loop's device state and its blocks of steps.

    State tensors, all on the cache's device: `tok` [B] (the last token),
    `history` [B, HISTORY_SIZE] (the token ring the processors read), the
    cache (with its cursor), `deltas` [B] (the rope deltas), the sampler's
    generator, `out` [2 * block_size, 2, B] f64 (each step's token and
    chosen logprob, a ring of two blocks) and `row` (its next row).  On a
    CUDA device (`use_graph`) the first step runs eagerly on a side stream
    and the next is captured there (`ops/_cuda.Graph`, which counts the
    captured kernel launches at each replay); every later step replays it.
    `stats`: the first step's and the capture's host seconds (`first_s`,
    `capture_s`), the decode steps run, graph replays, host fetches and
    blocks.

    Host samplers: a sampler that carries `on_host = True`
    (structured.make_constrained_sampler) reads each step's logits on the
    host and picks the token there, so its request runs every step eagerly
    (`use_graph` False: a captured graph would replay the one token its
    capture picked) and outside sync debug mode (its copy to the host waits
    for the card).  On the fused route (B = 1, bf16 cache) each such step
    is one eager K3 launch."""

    def __init__(self, model, cache, deltas, sampler, processors, gen,
                 block_size: int):
        B = deltas.shape[0]
        dev = deltas.device
        self.lm = model.language_model
        self.params = model.params["language_model"]
        self.cache, self.deltas = cache, deltas
        self.sampler, self.processors, self.gen = sampler, processors, gen
        self.block_size, self.dev = block_size, dev
        self.host_sampler = getattr(sampler, "on_host", False)
        self.use_graph = dev.type == "cuda" and not self.host_sampler
        self.graph = None
        self.tok = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.history = torch.full((B, HISTORY_SIZE), -1, dtype=torch.int64,
                                  device=dev)
        self.out = torch.zeros((2 * block_size, 2, B), dtype=torch.float64,
                               device=dev)
        self.row = torch.zeros((), dtype=torch.int64, device=dev)
        pinned = dev.type == "cuda"
        self.host = [torch.empty((block_size, 2, B), dtype=torch.float64,
                                 pin_memory=pinned) for _ in range(2)]
        self.events = [torch.cuda.Event() if pinned else None
                       for _ in range(2)]
        self.stats = dict(first_s=0.0, capture_s=0.0, steps=0, replays=0,
                          fetches=0, blocks=0)

    def pick(self, logits: torch.Tensor):
        """Sample from f32 logits [B, V]; push the token into `history` and
        `tok` in place.  Returns (token [B], its logprob [B])."""
        logprobs = torch.log_softmax(logits, dim=-1)
        tok = self.sampler(logits, self.gen)
        self.history.copy_(torch.cat([self.history[:, 1:], tok[:, None]],
                                     dim=1))
        self.tok.copy_(tok)
        return tok, logprobs.gather(1, tok[:, None])[:, 0]

    def step(self) -> None:
        """One decode step on the state tensors: embed `tok`, its logits at
        the cache's cursor, the processors, the sampler; the token and its
        logprob land in row `row` of `out`.  Its positions are the cursor
        plus the rope deltas, made on the device."""
        B = self.tok.shape[0]
        emb = self.lm.embed(self.params, self.tok[:, None])
        pos = (self.cache.offset + self.deltas)[None, :, None].expand(3, B, 1)
        logits = self.lm.step_logits(self.params, emb, self.cache,
                                     pos)[:, 0].float()
        for proc in self.processors:
            logits = proc(self.history, logits)
        tok, lp = self.pick(logits)
        pair = torch.stack([tok.double(), lp.double()])[None]
        self.out.index_copy_(0, self.row.reshape(1), pair)
        self.row.add_(1).remainder_(2 * self.block_size)

    def _capture(self) -> None:
        """Run the first step eagerly, then capture the next, both on a side
        stream (the capture's own), the eager step making every lazy piece
        of device state first.  The eager step is waited for, so that
        `first_s` holds it and `capture_s` the capture alone."""
        from ..ops._cuda import Graph

        tic = time.perf_counter()
        main = torch.cuda.current_stream(self.dev)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.step()
        side.synchronize()
        toc = time.perf_counter()
        self.graph = Graph()
        self.graph.capture(self.step, side, generators=(self.gen,))
        main.wait_stream(side)
        self.stats["first_s"] = toc - tic
        self.stats["capture_s"] = time.perf_counter() - toc

    def dispatch(self, n: int):
        """Put the next block's n steps on the device (nothing waits for
        them) and start the copy of its rows to the host; returns what
        `fetch` takes."""
        slot = self.stats["blocks"] % 2
        done = 0
        if self.use_graph and self.graph is None:
            self._capture()
            done = 1
        with _NoSync(self.dev, on=not self.host_sampler):
            for _ in range(done, n):
                if self.use_graph:
                    self.graph.replay()
                else:
                    self.step()
            rows = self.out[slot * self.block_size:slot * self.block_size + n]
            self.host[slot][:n].copy_(rows, non_blocking=True)
            if self.events[slot] is not None:
                self.events[slot].record()
        self.stats["steps"] += n
        self.stats["replays"] += n - done if self.use_graph else 0
        self.stats["blocks"] += 1
        return slot, n

    def fetch(self, block) -> Generator[Tuple[np.ndarray, np.ndarray],
                                        None, None]:
        """Wait for a dispatched block's rows and yield its (token [B],
        logprob [B]) pairs."""
        slot, n = block
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        self.stats["fetches"] += 1
        rows = self.host[slot][:n].numpy().copy()
        for i in range(n):
            yield rows[i, 0].astype(np.int64), rows[i, 1].astype(np.float32)


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
    kv_capacity: Optional[int] = None,
    prompt_cache=None,
    prefix_len: int = 0,
    prompt_cache_callback: Optional[Callable] = None,
    prompt_progress_callback: Optional[Callable] = None,
) -> Generator[Tuple[np.ndarray, np.ndarray], None, None]:
    """Yield (token [B], chosen-token logprob [B]) numpy pairs.

    The prompt embeddings must already contain the merged vision features.
    `block_size` is the reference's count of decode steps per device
    program: the steps of one host fetch (`DecodeBlocks`); it also sizes
    the cache as the reference does (ar.py:344-352), unless `kv_capacity`
    gives its rows.  On a CUDA device each
    step after the first replays one captured CUDA graph; on the CPU every
    step runs eagerly, with the same state and fetches.  The request's
    `DecodeBlocks` stays in `last_decode` until the next request.

    Prefix caching (the reference's :345-399): a `prompt_cache` whose
    cursor is at `prefix_len` (apc.py's warm cache or restored snapshot)
    holds the prompt's first `prefix_len` rows; only [prefix_len, S) is
    prefilled, into that cache, at positions sliced from `prefix_len`,
    with the chunk halved until the padded suffix fits behind the prefix
    (a padded write must never land on cached rows).  A decoder with a
    bidirectional prefix takes no cached prefix (`refuse_prefix_reuse`).
    `prompt_cache_callback(cache)` runs once the cursor is at S, before
    any decode step is captured, so that its copy to the host falls
    outside every replay window; `prompt_progress_callback(done, S)` after
    each prefill chunk."""
    lm = model.language_model
    lm_params = model.params["language_model"]
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    global last_decode
    last_decode = None

    if position_ids is None:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        position_ids = np.broadcast_to(pos[None], (3, B, S))
    if rope_deltas is None:
        rope_deltas = np.zeros((B, 1), np.int32)
    deltas = torch.from_numpy(
        np.asarray(rope_deltas, np.int64).reshape(-1)[:B].copy()).to(dev)

    block_size = max(1, min(block_size, max_tokens))
    if prompt_cache is not None:
        refuse_prefix_reuse(model, prefix_len)
        cache = prompt_cache
    else:
        prefix_len = 0
        capacity = kv_capacity or round_up(S + max_tokens + block_size + 1,
                                           CACHE_BUCKET)
        cache = make_cache(model, B, capacity, inputs_embeds.dtype, kv_bits,
                           kv_group_size, device=dev)
    capacity = cache.capacity

    # ---- chunked prefill of the uncached suffix; the padded chunks and
    # the decode steps must fit the cache, since an out-of-range index
    # write would not be clamped
    suffix = S - prefix_len
    step_sz = min(prefill_step_size, round_up(suffix, CACHE_BUCKET))
    S_pad = round_up(suffix, step_sz)
    while prefix_len + S_pad > capacity and step_sz > 64:
        step_sz = max(64, step_sz // 2)
        S_pad = round_up(suffix, step_sz)
    check_capacity(capacity, prefix_len + S_pad, S, max_tokens)
    embeds = inputs_embeds[:, prefix_len:]
    if S_pad != suffix:
        embeds = F.pad(embeds, (0, 0, 0, S_pad - suffix))
    pos_pad = _pad_axis(np.asarray(position_ids, np.int64)[:, :, prefix_len:],
                        2, S_pad)
    cache_lib.set_prompt_end(cache, S)

    logits = None
    last = suffix - 1
    for c0 in range(0, S_pad, step_sz):
        pchunk = torch.from_numpy(
            np.ascontiguousarray(pos_pad[:, :, c0:c0 + step_sz])).to(dev)
        hidden = lm(lm_params, embeds[:, c0:c0 + step_sz], cache, pchunk)
        if c0 <= last < c0 + step_sz:
            h_last = hidden[:, last - c0:last - c0 + 1]
            logits = lm.logits(lm_params, h_last)[:, 0].float()
        if prompt_progress_callback:
            prompt_progress_callback(prefix_len + min(c0 + step_sz, suffix), S)
    # the padding wrote rows past S; they stay masked once the cursor is S
    cache.offset.fill_(S)
    if prompt_cache_callback is not None:
        prompt_cache_callback(cache)

    if max_tokens <= 0:
        return
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed if seed is not None else time.time_ns() % 2**31)
    blocks = last_decode = DecodeBlocks(
        model, cache, deltas, sampler or make_sampler(),
        tuple(logits_processors or ()), gen, block_size)
    # the first token, from the prefill's logits, in one fetch
    tok, lp = blocks.pick(logits)
    first = torch.stack([tok.double(), lp.double()]).cpu().numpy()
    blocks.stats["fetches"] += 1
    yield first[0].astype(np.int64), first[1].astype(np.float32)

    # ---- decode blocks: block k + 1 is dispatched before block k is read
    left = max_tokens - 1
    pending = None
    while left > 0 or pending is not None:
        block = None
        if left > 0:
            n = min(block_size, left)
            block = blocks.dispatch(n)
            left -= n
        if pending is not None:
            for pair in blocks.fetch(pending):
                yield pair
        pending = block
